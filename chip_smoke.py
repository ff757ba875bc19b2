#!/usr/bin/env python3
"""On-card smoke check of the PyTorch/CUDA port (pde_multigrid_tpu_torch).

    python3 chip_smoke.py            # from the root of a checkout, one GPU
    python3 chip_smoke.py PHASE ...  # the card, the build and these alone

With arguments it runs only the named phases, each a `phase_PHASE` that
takes the torch module alone (such as `kernels_line`, `subtree_mu2`,
`anis3d`, `wcycle_cli`), and ends with one JSON line of their results
and tables, written also to chiprun_out/chip_smoke_phases.json; it prints
no result line of the whole check.

Phases, in order; any failure exits non-zero without the final result line:

  1. the card: `nvidia-smi` name and power limit, torch's device name;
  2. build: nvcc compiles the kernels from `ops/cuda/csrc/*.cu` (sm_90a);
  3. kernels: each CUDA kernel against its plain PyTorch version on the
     card, at the 129^3 main path's shapes (128^3 fine, 64^3 coarse), and
     each one's time beside the plain version's (CUDA events); the
     transfers (rows 25, 26) bitwise at 128^3, 256^3 and 512^3 in both
     modes, the prolongation also in place, each timed by level; the
     residual (row 27) bitwise on every level 512^3 ... 2^3, a non-cubic
     and a non-power-of-two level, with f and f-less, timed by level
     beside its plain version (`residual_ab`); the bf16
     defect trio included: residual_split, row 10's error sweeps as the
     plan runs them on 128^3 and below (error_leg, one cooperative
     launch a leg) bitwise error_sweeps_plain at nu = 1 ... 9 and 100 on
     128^3 (isotropic and anisotropic spacing), 64^3 and two odd shapes,
     a 100-sweep leg at 128^3 timed beside its plain version and the
     half-sweep chain it replaces (error_sweep, kept for the levels that
     fit neither form), merge_fold; then
     the time-skewed wavefront (timeskew.cu, T = 4 sweeps per launch on
     a 16-CTA cluster), bitwise on small and odd-tiled levels and at
     256^3 and 512^3 over 1 ... 2T + 1 and 100 sweeps, with and without
     v_zero, a 100-sweep leg timed beside its plain version and at every
     T the kernel is built for, and (dense in and out) beside the
     half-sweep chain, the bf16 defect leg and that leg with row 10 as
     the chain, and at 128^3 and 64^3 beside the half-sweeps; its error
     mode (error_timeskew, row 10 on 256^3 and 512^3) bitwise
     error_sweeps_plain at nu = 1 ... 9 and 100 on 16^3, 32^3, the
     odd-tiled (64, 65, 100) and 256^3 and 512^3 (isotropic and
     anisotropic), a 100-sweep leg timed at 256^3 and 512^3 beside its
     plain version and the chain; then
     the fused coarse-subtree V-cycle (subtree.cu) bitwise against the
     unfused chain of the port's kernels and against its plain version at
     the roots 64^3 ... 2^3, nu = (1, 1), (1, 0), (2, 3), with and without
     the root's relax, and at nu = 3000 on the 64^3 and 32^3 roots, timed
     at nu = 3000 on every root (at 64^3 and 32^3 beside the chain), the
     64^3 level alone, the 32^3 root on 8 and on 16 CTAs; the
     transfer kernels on the sub-lane pairs
     32^3 -> 16^3 ... 4^3 -> 2^3 and (8, 4, 16) -> (4, 2, 8) (rows 23 and
     24) bitwise in both modes; then the
     whole-leg 3D resident kernel (resident3d.cu, on the subtree's leg:
     64^3, 32^3, 16^3 on a 16-CTA cluster, 8^3 and below on one CTA) in
     its three modes (dense on 64^3, 32^3, 16^3 and on colour halves
     there: rows 4 and 5; dense on one CTA on 8^3, 4^3, 2^3: row 1's 3D
     mode) bitwise against its plain versions and the half-sweep chain
     over nu = 1, 2, 3 and 100, a 100-sweep leg timed beside the chain and
     beside the fused subtree's rate a half-sweep on every level; then
     the 2D Lyapunov kernels, bitwise: split2d at 4097^2, merge2d at
     every split level (4097^2 ... 513^2) and on two odd non-square
     shapes, each level timed beside torch.take and its byte bound;
     row 16 as the colour slab's one-rank chunk on the level's halves
     (JAX's sweeps_per_call = T form) at 4097^2, 2049^2, 1025^2 and 513^2,
     t = 4, 1, 3 with and without f, and over 9 sweeps in turns between
     two pairs against the half-sweep chain; row 1 (the colour slab's leg
     in dense form, on clusters of 16, 15 and 9 CTAs) over legs of 1-500
     sweeps at 257^2 ... 3^2 with and without f; each timed beside its
     plain version;
  4. main path at 129^3: FMG(2, 100, 100), red-black Gauss-Seidel, exact
     coarsest level, through `MultigridSolver.solve()` on "cuda", first
     with precision="f32", then "mixed" (the bench's default: every leg
     of 100 sweeps takes the bf16 defect correction); error_linf
     < 50 h^2, finite residuals, and every kernel of each path launched
     by its solve (counts set to 0 just before it, read just after); in
     mixed exactly row 10's launches of the plan (4 a step at 129^3, 108
     at 257^3, 312 at 513^3), none of the half-sweep chain;
     then ms per solve step and DOF-updates/s, eager and replayed as one
     CUDA graph; then the reference: the same schedule in float64
     through the plain tensor tier, against which the mixed solve's
     error_linf must lie within 10 % of the float64 solve's, and its
     solution within 10 % of that error;
  5. the same at 257^3 (256^3 relaxed by the wavefront in f32, 128^3 by
     the half-sweeps, 64^3 solved exactly) and at 513^3 (512^3 and 256^3
     by the wavefront); in f32 exactly the launches of the schedule:
     4 (l + 1) legs on level l, each ceil(100 / T) wavefront launches or
     200 half-sweeps; then the thesis' 3D presets through the CLI,
     `--preset poisson3d` (129^3) and `--preset poisson3d-cuda` (257^3),
     FMG(2, 3000, 3000) relaxed down to 2^3: error_linf < 50 h^2, finite
     residuals, exactly the schedule's launches (one subtree launch per
     V-cycle) and no other kernel, ms per step eager and as one CUDA
     graph, at 129^3 two steps with the fused hooks on and off (the same
     solution bit for bit, eager ms each) and the plan with the 64^3-rooted
     V-cycles unfused (bitwise the same; eager and graph ms, its 64^3 level
     relaxed by the plan's resident kernel and by the half-sweeps); and
     129^3
     FMG(2, 4, 4) relaxed to 2^3 with the hooks on and off: the same
     residual history and solution bit for bit;
  6. the 2D Lyapunov path at 4097^2: FMG(2, 500, 500), exact (dense
     inverse) coarsest level 33^2, precision="mixed", through
     `MultigridSolver.solve()` on "cuda": error_linf < max(10 h, 5e-5)
     (the bench's gate for this first-order scheme), finite residuals,
     exactly the schedule's launches of row 16's chunk and row 1's leg,
     split2d and merge2d launched, no 3D or defect kernel and no
     half-sweep kernel built, the persistent halves' splits and merges
     within their per-visit budget, the solution's SHA-256; ms per step
     and DOF-updates/s, eager and as one CUDA graph, the profiler's busy
     time by kernel and the relax time by level; then the
     float64 solve of the same schedule (plain tier on the card): the
     float32 error_linf within 1 % of its, and the solution within 10 %
     of that error; then (after phase 15's reduced solve) the thesis' two
     Lyapunov presets through the CLI, `--preset lyapunov2d` (1025^2,
     FMG(1, 500, 500), relaxed to 3^2: row 16 on 1025^2 and 513^2) and
     `--preset lyapunov2d-cuda` (65^2 on [0, 20]^2, row 1 on every level):
     the plan's kernels launched and no other, each against the float64
     solve of its schedule (and the 1025^2 one under max(10 h, 5e-5)), ms
     per step eager and as one CUDA graph;
  7. the 1D family: relax1d bitwise against its plain version at 1,
     T - 1, T, T + 1 and 1000 sweeps in the layout of its plan (Ode1D on
     every level 8193 down to 3 points, 16385 and 65537; Poisson(1) at
     8193 and 16385 in wrap storage), a 1000-sweep leg timed on each;
     then the bench's ode1d row, 8193 points,
     FMG(2, 1000, 1000), exact (dense inverse) coarsest level 2049,
     precision="mixed", through `MultigridSolver.solve()` on "cuda":
     error_linf < max(10 h, 5e-5), finite residuals, exactly 12 relax1d
     launches and no other kernel, the solution's SHA-256, ms per step
     and DOF-updates/s eager and as one CUDA graph, the profiler's busy
     time, and the float64 solve of the same schedule
     (error_linf within 1 % of its, the solution within 10 % of that
     error, each plus 16 ulp of max|u|, the float32 floor);
     then `--preset ode1d` through the CLI (13 levels down to 3 points:
     the same gate and the 364 relax1d launches its schedule implies);
     then Poisson(1) at 8193, FMG(2, 100, 100), exact coarsest level
     (12 relax1d launches; its float64 solve under 50 h^2, the float32
     solve within its rounding floor of it); then the float32 floors of
     the 1D gates over sizes (Ode1D and Poisson(1) at 2049, 4097 and
     16385 points, each within its row's gate of its float64 solve) and
     their control (Ode1D on [0, 0.9], which the ODE gate must reject);
  8. the HJB path: slab2d (a whole leg one cooperative launch, halos
     refreshed every T sweeps through device memory) bitwise against its
     plain version at 513^2 and 257^2 with 1, T - 1, T, T + 1 and 30
     sweeps, and on 1025^2 (at most T sweeps a launch) with 1 and 30, the
     ring and the pinned ball unchanged, and resident_hjb at 1, T - 1, T,
     T + 1 and 30 sweeps on 257^2 down to 3^2 in the layout of its plan,
     the ring and the pinned ball unchanged (a 30-sweep leg timed on each
     level); then the bench's
     hjb2d
     row, 513^2, FMG(2, 30, 30), scheme="fas", coarsest="relax", f32,
     through `MultigridSolver.solve()` on "cuda": error_linf under the
     bench's gate 1.15 * 0.2032 * (32 h)^0.17, the ring and ball exact,
     exactly 4 slab2d (a launch a leg) and 176 resident_hjb launches and no
     other kernel, the solution's SHA-256, ms per step eager and as one
     CUDA graph, DOF-updates/s, the profiler's busy time split into slab,
     resident and plain ops;
     and the float64 solve of the same schedule (plain tier on the card):
     error_linf within 1 % of its, max|v - v_float64| under
     HJB_DV_LIMIT;
  9. FAS on 3D Poisson through the CUDA plan: 33^3, V(2, 2) cycles in the
     full approximation scheme and in the correction scheme through
     `MultigridSolver.solve_to_tolerance()` on "cuda", the same residual
     history and error_linf within 1e-5, the kernels of each plan launched
     (FAS: the whole-leg resident kernel on every level);
 10. the Galerkin path: the plan's form (stencil_slab2d on 1024^2-256^2,
     stencil_resident's leg below) and stencil_slab2d on all ten levels of
     the varcoef2d 1025^2 hierarchy with their own coefficients (1024^2
     K = 5, 512^2 ... 2^2 K = 9), bitwise against their plain version over
     1, 40 and 7 sweeps (7: not a multiple of T), and the plan's form on
     an odd 2D level (65^2 padded), 1D levels (Galerkin varcoef1d, 1024
     and 512; 8192, the general form's), 3D levels (Galerkin Poisson(3):
     the constant 7-point 32^3, the 27-point 16^3; 33^3 padded, the
     general form's) and the slab on 128^2 (Galerkin Poisson(2), constant),
     a 40-sweep leg of the plan's form timed on every level; then the
     bench's varcoef2d row, 1025^2, FMG(2, 40, 40),
     coarse_operator="galerkin", coarsest="relax", f32, through
     `MultigridSolver.solve()` on "cuda": error_linf under the bench's
     gate max(50 h^2, 5e-5), exactly the launches of the plan (ceil(40 /
     T) slab launches per 40-sweep leg on 1024^2, 512^2 and 256^2, one
     resident launch per leg below) and no other kernel, ms per step eager
     and as one CUDA graph, the profiler's busy time split into the two
     kernels and plain ops, kernel ms by level; and the float64 solve of
     the same schedule (`MultigridSolver(dtype="float64", device="cuda")`,
     the plain tier): error_linf and max|v - v_float64| within
     VARCOEF_F32_FLOOR;
 11. the presets' schedule, FMG(2, 3000, 3000) relaxed to 2^3, at 17^3,
     33^3 and 65^3 in float32 on the card against float64 on the host CPU
     (the plain tier, in child processes started after the build that run
     beside the phases above): error_linf of each and max|v32 - v64|;
 12. the sharded solve (`parallel/`): the per-shard kernels bitwise
     against their plain versions, the time-skew chunk (timeskew.cu's
     shard mode) on every shard of the 256^3 level split over 1, 2 and 4
     ranks at t = 1, 2, 4 and 2T + 1 sweeps and on odd-tiled small
     levels, the
     shards' owned windows composed against the single-chip wavefront, the
     masked block (masked_block.cu: one launch a chunk) on the extended
     blocks of every shard of the 257^3 row's 128^3 level and of the FAS
     65^3 row's levels over 1, 2 and 4 ranks at t = 1 and T, the whole
     block, and the one-colour form kept for blocks the chunk cannot
     hold, each chunk timed (the one-rank 128^3 one beside its plain
     version and the one-colour form); then 257^3 FMG(2, 100, 100), exact
     coarsest, f32,
     `--mesh 1` through the CLI in process: error_linf < 50 h^2, finite
     residuals, exactly the schedule's launches of the time-skew chunk,
     the masked block, split and merge and no other kernel
     (`sharded_launches`), ms per step eager and as one CUDA graph, and
     the solution against phase 5's unsharded 257^3 f32 solve (JAX's
     sharded-vs-single tolerance); then the same solve split over 2 and 4
     ranks on cuda:0 (gloo, halos through the host; child processes
     started after the build): each rank's launches as the schedule
     implies and rank 0's solution bitwise the one-rank solve's;
 13. the sharded 2D Lyapunov solve (after phase 6, whose solution it is
     held against): the per-shard color slab (color_slab2d_shard.cu)
     bitwise against its plain version: the chunk on every shard of
     4097^2 over 1, 2 and 4 ranks at t = 1-4, its one-rank form on every
     relaxed level at t = 1-4, and the whole leg on chip on 257^2-9^2
     over legs of 1-500 sweeps; a t = 4 chunk timed beside its plain
     version, a 500-sweep leg beside its plain version, and by level the
     chunk with and without halo rows and the leg beside 125 chunks; then
     4097^2 FMG(2, 500, 500), exact coarsest, f32, `--problem lyapunov2d
     --mesh 1` through the CLI in process: error_linf < max(10 h, 5e-5),
     finite residuals, exactly the schedule's launches of the chunk
     (4097^2-513^2), the leg (257^2-65^2), split2d and merge2d and no
     other kernel, ms per step eager and as one CUDA graph, the solution
     within JAX's sharded-vs-single tolerance of phase 6's (max|dv|
     printed);
     then FMG(2, 20, 20) over 2 and 4 gloo ranks on cuda:0: every rank's
     launches as the schedule implies, rank 0's logical solution bitwise
     the one-rank solve's of that schedule;
 14. the 3D FAS path (after phase 5): 257^3 FMG(2, 100, 100),
     scheme="fas", coarsest relaxed to 2^3, f32, through
     `MultigridSolver.solve()` on "cuda" (the wavefront on 256^3, the
     half-sweeps on 128^3, the resident kernel's merged mode on 64^3 ...
     16^3 and its one-CTA mode on 8^3 ... 2^3): error_linf < 50 h^2,
     exactly the schedule's launches (`fas_launches`) and no other kernel,
     ms per step eager and as one CUDA graph, the same step with the
     resident kernel's levels (all, or 64^3 alone) on the half-sweeps,
     bitwise the same, the correction scheme's solve within 1e-5 of its
     error_linf, and the float64 FAS solve on the plain tier; and, after
     phase 12, the sharded FAS row (F3): 65^3 FMG(2, 20, 20) relaxed to
     2^3 on one rank in process and over 2 and 4 gloo ranks (the
     replicated coarse levels on the resident kernel, the injection into
     them gathered), rank 0's logical solution bitwise the one-rank
     solve's.
 15. the two kernels JAX plans only behind a switch, each on its path
     (the switch set for the phase and restored after it): after the 3D
     resident kernel, the blocked 3D kernel (blocked3d.cu, row 19)
     bitwise against row 9's half-sweep chain and its plain version on
     small and odd-tiled wrap levels at T = 1-4 and over 100-sweep legs
     at 256^3 (T = 1-4) and 512^3 (T = 1), a T = 1 launch at 256^3 and
     512^3 timed beside its plain version and the legs beside row 9's
     chain and the wavefront; after the 257^3 f32 main path, the same
     solve with
     PDE_MG_TIMESKEW=0: error_linf < 50 h^2, exactly the schedule's
     launches (row 19 on 256^3, the half-sweeps on 128^3, no wavefront),
     against the wavefront solve (bitwise, or error_linf within 1 %),
     eager and graph ms per step; after the 2D kernels, the reduced-system
     kernel (reduced2d.cu, row 18) bitwise its plain version at 33^2,
     65^2, 513^2 (T = 16, 5) and at 4097^2 and 2049^2 in chunks of
     T = 8, 1, 3 with and without f, bitwise its plain version and within
     JAX's test tolerance of row 16 (its chunks), row 16's two chunks of 4
     timed; on every level the 4097^2 plan reduces (4097^2 ... 513^2) at
     its T and the legs' remainder 4, with and without f, bitwise and
     timed (the f-less T chunk beside its plain version), and on 129^2 at
     T = 1, 7, 8, 9, 15, 16; after phase 6,
     the
     4097^2 Lyapunov solve with the reduced opt-in on
     (dispatch.SPLIT2D_REDUCED): the bench's gate, error_linf within 1 %
     of phase 6's and max|v - v_row16| under 10 % of it, exactly the
     schedule's launches (`reduced_launches`; no row 16 chunk), eager and
     graph ms per step, busy ms by kernel and relax ms by level.

 16. line relaxation and W-cycles: after the fused subtree (phase 3),
     row 22's mu = 2 form bitwise its plain version at the 64^3 and 32^3
     roots, nu = (1, 1), (2, 3), with and without the root's relax (mu =
     3 at 32^3), timed at nu = 2 and 100 beside the V-cycle; the zebra
     line kernel (zebra_line.cu, no Pallas original) bitwise its plain
     version (relax_zebra_line on the card) at 1, 2 and 16 sweeps on
     every relaxed level of the anis3d row along x (257^3 ... 17^3), a
     65^3 level along y and z and a 2D 1025^2 level along both axes, a
     half-sweep of each
     colour timed beside the plain one and the bound; after the 3D
     presets, the bench's anis3d row: 257^3 on a domain squashed 20x
     along x, FMG(2, 16, 16), mu = 2, line-0, exact coarsest, f32,
     through `MultigridSolver.solve()` on "cuda": error_linf < 50 h^2,
     exactly the schedule's 7296 line launches (114 relaxed visits) and
     no other kernel, ms per step eager and as one CUDA graph,
     DOF-updates/s, the busy split; at 129^3 the f32 solve against its
     float64 solve; then `--n 129 --kind fmg --mu 2` through the CLI:
     error_linf < 50 h^2, exactly the schedule's launches (16 subtree
     W-cycles).
 17. 2D Poisson, after the HJB path: kernels_poisson2d, the Poisson
     forms of rows 1, 3 and 16 (resident.cu's dense leg, slab2d.cu's
     tiles, color_slab2d_shard.cu's two-sided one-rank chunk) bitwise
     their plain versions on every level of both 4097^2 hierarchies in
     the plan's form (wrap 4096^2 ... 512^2 the slab, 256^2 ... 2^2 the
     leg; padded 4097^2 ... 513^2 the chunk, 257^2 ... 3^2 the leg) at 1,
     T - 1, T, T + 1 and 500 sweeps, the boundary unchanged, a 500-sweep
     leg timed on every level, each form's record beside its plain
     version; poisson2d, FMG(2, 500, 500) exact-coarsest at 4097^2 in wrap
     storage and padded storage ([0, 1.5]^2): the bench's gate max(10 h,
     5e-5), exactly the schedule's launches, the halves' conversions
     within budget, eager/graph ms a step, the busy split and
     |v - v_float64| (reported: the discretization error lies below
     float32's reach); poisson2d_cli, `--problem poisson2d --n 4097` in
     both storages and at 1025^2 `--kind v`, `--kind w --mu 2` (both
     storages) and `--coarsest exact`; wcycle2d, one W-cycle (mu = 2) of
     every 2D and 1D plan (2D Poisson wrap and padded, Lyapunov and HJB
     at 513^2, Ode1D at 1025) against the plain tier on the card.
 18. 3D Poisson in padded storage ([0, 1.5]^3, a nonzero boundary), after
     the 2D Poisson path: kernels_poisson3d_padded, the padded forms of
     rows 1 and 3 (padded3d.cu's whole leg on a cluster, 65^3 ... 3^3;
     slab3d.cu's half-sweep a launch, 513^3 ... 129^3) bitwise their
     plain version (`padded3d.sweeps_plain`) on every level of the 513^3
     padded hierarchy in the plan's form at 1, 2, 3 and 100 sweeps with
     f and at 3 and 100 f-less, the boundary unchanged, a 100-sweep leg
     timed on every level, each form's record beside its plain version;
     poisson3d_padded, FMG(2, 100, 100) exact-coarsest at 257^3 and 513^3
     through `MultigridSolver.solve()` on "cuda": error_linf < 50 h^2,
     exactly the schedule's launches and no other kernel, eager/graph ms
     a step, DOF-updates/s, the busy split; the mixed plan (float32
     relax, no defect form); at 129^3 the f32 solve against its float64
     solve (within 64 ulp of max|u|); one W-cycle (mu = 2) and one FAS
     V-cycle at 65^3 bitwise the plain tier on the card;
     poisson3d_padded_cli,
     `--problem poisson3d --domain 1.5 --n 257 --nu1 100 --nu2 100` with
     `--coarsest exact` and with the default relaxed coarsest (to 3^3).

Every float64 reference but phase 11's is a `MultigridSolver(...,
dtype="float64", device="cuda")` solve: the plain tier on the card.  Each phase's seconds
are printed as it ends.

Every kernel's record carries its bound (the larger of its bytes over
the HBM rate and its float32 operations over the float32 rate, from the
shapes of the measured call) and, for the four dense <-> halves
converters, the time of the one `torch.take` that computes the same
permutation (no other kernel has a single PyTorch call of its function).
Stdout ends with one JSON line of per-kernel results and then
`{"ok": true, "device": {...}}`.  Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import json
import os
import socket
import subprocess
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))

# tolerance for the multi-step kernels (100 sweeps):
# both sides round every operation alike (--fmad=false, same order), so
# they are expected to agree bit for bit; 1e-6 of the output's magnitude
# leaves room only for a single-ulp difference of a reordered sum
REL_TOL = 1e-6

# the H100 SXM's peaks (NVIDIA's data sheet):
# HBM3 bytes/s, and float32 operations/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

KERNELS = {
    # name: (source, replaced TPU kernel)
    "split": (
        "pde_multigrid_tpu_torch/ops/cuda/csrc/relax.cu",
        "pde_multigrid_tpu/ops/pallas/relax.py:910",
    ),
    "merge": (
        "pde_multigrid_tpu_torch/ops/cuda/csrc/relax.cu",
        "pde_multigrid_tpu/ops/pallas/relax.py:951",
    ),
    "half_sweep": (
        "pde_multigrid_tpu_torch/ops/cuda/csrc/relax.cu",
        "pde_multigrid_tpu/ops/pallas/relax.py:1006",
    ),
    "residual_restrict": (
        "pde_multigrid_tpu_torch/ops/cuda/csrc/transfer.cu",
        "pde_multigrid_tpu/ops/pallas/transfer.py:151",
    ),
    "prolong_blend": (
        "pde_multigrid_tpu_torch/ops/cuda/csrc/transfer.cu",
        "pde_multigrid_tpu/ops/pallas/transfer.py:312",
    ),
    "residual": (
        "pde_multigrid_tpu_torch/ops/cuda/csrc/transfer.cu",
        "pde_multigrid_tpu/ops/pallas/transfer.py:413",
    ),
    # row 27's f-less mode: FAS's coarse right side, residual(v, 0), which
    # JAX computes with make_residual on a zero f
    "residual_zero_f": (
        "pde_multigrid_tpu_torch/ops/cuda/csrc/transfer.cu",
        "pde_multigrid_tpu/ops/pallas/transfer.py:413",
    ),
    "residual_split": (
        "pde_multigrid_tpu_torch/ops/cuda/csrc/defect.cu",
        "pde_multigrid_tpu/ops/pallas/defect.py:111",
    ),
    # row 10 in three forms: the whole leg with the halves on chip (the
    # plan's on 128^3 and below), the wavefront's error mode, T sweeps a
    # launch (256^3, 512^3), and the half-sweep chain, the earlier form,
    # kept for the levels that fit neither (no bench row has one)
    "error_leg": (
        "pde_multigrid_tpu_torch/ops/cuda/csrc/relax.cu",
        "pde_multigrid_tpu/ops/pallas/relax.py:1268",
    ),
    "error_timeskew": (
        "pde_multigrid_tpu_torch/ops/cuda/csrc/timeskew.cu",
        "pde_multigrid_tpu/ops/pallas/relax.py:1268",
    ),
    "error_sweep": (
        "pde_multigrid_tpu_torch/ops/cuda/csrc/relax.cu",
        "pde_multigrid_tpu/ops/pallas/relax.py:1268",
    ),
    "merge_fold": (
        "pde_multigrid_tpu_torch/ops/cuda/csrc/defect.cu",
        "pde_multigrid_tpu/ops/pallas/defect.py:191",
    ),
    "split2d": (
        "pde_multigrid_tpu_torch/ops/cuda/csrc/relax2d.cu",
        "pde_multigrid_tpu/ops/pallas/relax.py:2395",
    ),
    "merge2d": (
        "pde_multigrid_tpu_torch/ops/cuda/csrc/relax2d.cu",
        "pde_multigrid_tpu/ops/pallas/relax.py:2457",
    ),
    # row 16 in JAX's sweeps_per_call = T form: the colour slab's one-rank
    # chunk on a level's halves (its launches: the color_slab2d_shard
    # counter on the unsharded path)
    "color_slab2d": (
        "pde_multigrid_tpu_torch/ops/cuda/csrc/color_slab2d_shard.cu",
        "pde_multigrid_tpu/ops/pallas/relax.py:2547",
    ),
    # row 1's 2D Lyapunov levels: the colour slab's leg in dense form
    "resident": (
        "pde_multigrid_tpu_torch/ops/cuda/csrc/color_slab2d_shard.cu",
        "pde_multigrid_tpu/ops/pallas/relax.py:143",
    ),
    # the HJB variant of relax.py:143 (upwind update, pinned-ball mask)
    "resident_hjb": (
        "pde_multigrid_tpu_torch/ops/cuda/csrc/resident.cu",
        "pde_multigrid_tpu/ops/pallas/relax.py:143",
    ),
    "slab2d": (
        "pde_multigrid_tpu_torch/ops/cuda/csrc/slab2d.cu",
        "pde_multigrid_tpu/ops/pallas/relax.py:334",
    ),
    # also the 1D branch of relax.py:143 (Poisson(1) in wrap storage)
    "relax1d": (
        "pde_multigrid_tpu_torch/ops/cuda/csrc/relax1d.cu",
        "pde_multigrid_tpu/ops/pallas/relax.py:209",
    ),
    "stencil_resident": (
        "pde_multigrid_tpu_torch/ops/cuda/csrc/stencilop.cu",
        "pde_multigrid_tpu/ops/pallas/stencilop.py:41",
    ),
    "stencil_slab2d": (
        "pde_multigrid_tpu_torch/ops/cuda/csrc/stencilop.cu",
        "pde_multigrid_tpu/ops/pallas/stencilop.py:132",
    ),
    # one kernel serves both TPU wavefronts: row 11's record at 256^3 (the
    # level JAX gives the whole-plane kernel), row 13's at 512^3 (the level
    # it gives the j-blocked one), each with its launches on that level
    "timeskew": (
        "pde_multigrid_tpu_torch/ops/cuda/csrc/timeskew.cu",
        "pde_multigrid_tpu/ops/pallas/relax.py:1476",
    ),
    "timeskew_jb": (
        "pde_multigrid_tpu_torch/ops/cuda/csrc/timeskew.cu",
        "pde_multigrid_tpu/ops/pallas/relax.py:2051",
    ),
    "subtree": (
        "pde_multigrid_tpu_torch/ops/cuda/csrc/subtree.cu",
        "pde_multigrid_tpu/ops/pallas/subtree.py:350",
    ),
    # transfer.cu's kernels on the sub-lane pairs (SMALL_PAIR_FINE), which
    # JAX serves with its small resident transfer kernels
    "small_restrict": (
        "pde_multigrid_tpu_torch/ops/cuda/csrc/transfer.cu",
        "pde_multigrid_tpu/ops/pallas/subtree.py:754",
    ),
    "small_prolong_blend": (
        "pde_multigrid_tpu_torch/ops/cuda/csrc/transfer.cu",
        "pde_multigrid_tpu/ops/pallas/subtree.py:792",
    ),
    # the per-shard engines of the sharded solve (parallel/halo.py)
    "timeskew_shard": (
        "pde_multigrid_tpu_torch/ops/cuda/csrc/timeskew.cu",
        "pde_multigrid_tpu/ops/pallas/relax.py:1787",
    ),
    "masked_block": (
        "pde_multigrid_tpu_torch/ops/cuda/csrc/masked_block.cu",
        "pde_multigrid_tpu/ops/pallas/relax.py:792",
    ),
    # the per-shard engine of the sharded 2D Lyapunov solve: a chunk of t
    # sweeps, and a whole leg of a one-rank level held on chip
    "color_slab2d_shard": (
        "pde_multigrid_tpu_torch/ops/cuda/csrc/color_slab2d_shard.cu",
        "pde_multigrid_tpu/ops/pallas/relax.py:2879",
    ),
    "color_slab2d_leg": (
        "pde_multigrid_tpu_torch/ops/cuda/csrc/color_slab2d_shard.cu",
        "pde_multigrid_tpu/ops/pallas/relax.py:2879",
    ),
    # the whole-leg 3D resident kernel's three modes: dense on the merged
    # gate's levels (64^3 ... 16^3), colour halves (no plan selects it, as
    # in JAX), and the 3D Poisson levels of relax.py:143 (8^3 ... 2^3)
    "merged_resident": (
        "pde_multigrid_tpu_torch/ops/cuda/csrc/resident3d.cu",
        "pde_multigrid_tpu/ops/pallas/relax.py:595",
    ),
    "split_merged": (
        "pde_multigrid_tpu_torch/ops/cuda/csrc/resident3d.cu",
        "pde_multigrid_tpu/ops/pallas/relax.py:684",
    ),
    "resident3d": (
        "pde_multigrid_tpu_torch/ops/cuda/csrc/resident3d.cu",
        "pde_multigrid_tpu/ops/pallas/relax.py:143",
    ),
    # the two kernels JAX plans only behind a switch: the reduced-system
    # kernel under PDE_MG_SPLIT2D_REDUCED=1 (2D Lyapunov), the blocked 3D
    # kernel under PDE_MG_TIMESKEW=0 (256^3, 512^3)
    "reduced2d": (
        "pde_multigrid_tpu_torch/ops/cuda/csrc/reduced2d.cu",
        "pde_multigrid_tpu/ops/pallas/relax.py:3137",
    ),
    "blocked3d": (
        "pde_multigrid_tpu_torch/ops/cuda/csrc/blocked3d.cu",
        "pde_multigrid_tpu/ops/pallas/relax.py:3439",
    ),
    # the 2D Poisson forms of rows 1, 3 and 16: the dense leg (resident.cu
    # on its Poisson stencil; wrap 256^2 ... 2^2, padded 257^2 ... 3^2),
    # the tiled slab (slab2d.cu on its Poisson stencil; wrap 4096^2 ...
    # 512^2) and the colour slab's one-rank chunk with its two-sided halo
    # (padded 4097^2 ... 513^2)
    "resident_poisson": (
        "pde_multigrid_tpu_torch/ops/cuda/csrc/resident.cu",
        "pde_multigrid_tpu/ops/pallas/relax.py:143",
    ),
    "slab2d_poisson": (
        "pde_multigrid_tpu_torch/ops/cuda/csrc/slab2d.cu",
        "pde_multigrid_tpu/ops/pallas/relax.py:334",
    ),
    "color_slab2d_poisson": (
        "pde_multigrid_tpu_torch/ops/cuda/csrc/color_slab2d_shard.cu",
        "pde_multigrid_tpu/ops/pallas/relax.py:2547",
    ),
    # the 3D padded Poisson forms of rows 1 and 3: the whole leg on a
    # cluster (65^3 ... 3^3) and a half-sweep a launch (513^3 ... 129^3)
    "padded3d": (
        "pde_multigrid_tpu_torch/ops/cuda/csrc/padded3d.cu",
        "pde_multigrid_tpu/ops/pallas/relax.py:143",
    ),
    "slab3d": (
        "pde_multigrid_tpu_torch/ops/cuda/csrc/slab3d.cu",
        "pde_multigrid_tpu/ops/pallas/relax.py:334",
    ),
    # no Pallas original: JAX runs line relaxation on its jnp tier
    # (thomas_tridiagonal, relax_zebra_line); the anis3d row's relax
    "zebra_line": (
        "pde_multigrid_tpu_torch/ops/cuda/csrc/zebra_line.cu",
        "none: jnp pde_multigrid_tpu/ops/stencil.py:85 thomas_tridiagonal "
        "+ :208 relax_zebra_line",
    ),
}
# the levels (halves shapes) whose wavefront launches each record counts
TIMESKEW_LEVELS = {"timeskew": (256, 128, 256), "timeskew_jb": (512, 256, 512)}

# the kernels each 3D row's path must launch; between them every kernel
# runs (all legs have 100 sweeps, so a mixed solve takes the defect path
# on every relaxed level and never the f32 relax)
TRANSFERS = ("residual_restrict", "prolong_blend", "residual")
F32_3D = ("split", "merge", "half_sweep", *TRANSFERS)
PATHS = {
    "f32": F32_3D,  # 129^3: the half-sweeps on 128^3
    "f32_257": (*F32_3D, "timeskew"),  # the wavefront on 256^3
    "f32_513": (*F32_3D, "timeskew", "timeskew_jb"),  # on 512^3 and 256^3
    # mixed: row 10 as the whole leg on 128^3, and as the wavefront's error
    # mode on 256^3 and 512^3; no half-sweep chain
    "mixed": ("residual_split", "error_leg", "merge_fold", *TRANSFERS),
    "mixed_257": ("residual_split", "error_leg", "error_timeskew",
                  "merge_fold", *TRANSFERS),
    "mixed_513": ("residual_split", "error_leg", "error_timeskew",
                  "merge_fold", *TRANSFERS),
    # the 2D Lyapunov path (any precision: no defect plan covers 2D): row
    # 16 as one-rank chunks on 4097^2 ... 513^2, row 1 on 257^2 ... 65^2
    "lyapunov": ("split2d", "merge2d", "color_slab2d_shard", "resident"),
    # the 1D family (any precision: no defect plan covers 1D)
    "ode1d": ("relax1d",),
    # the HJB 513^2 FAS row (f32)
    "hjb": ("slab2d", "resident_hjb"),
    # the varcoef2d 1025^2 Galerkin row (f32)
    "varcoef": ("stencil_resident", "stencil_slab2d"),
    # the 3D presets (FMG(2,3000,3000), relaxed to 2^3): the fused subtree
    # on 64^3 and below, the half-sweeps on 128^3, the wavefront on 256^3
    "preset129": (*F32_3D, "subtree", "small_restrict",
                  "small_prolong_blend"),
    "preset257": (*F32_3D, "timeskew", "subtree", "small_restrict",
                  "small_prolong_blend"),
    # 33^3 V(2, 2) cycles, relaxed to 2^3: the correction scheme fuses
    # every V-cycle; FAS (no fused hooks) relaxes 32^3 and 16^3 with the
    # whole-leg resident kernel's merged mode, 8^3 ... 2^3 with its
    # one-CTA mode, and transfers on the sub-lane pairs; its coarse right
    # sides take the residual's f-less mode
    "fas3d_cs": ("subtree", "residual"),
    "fas3d_fas": ("merged_resident", "resident3d", "residual",
                  "residual_zero_f", "small_restrict",
                  "small_prolong_blend"),
    # 257^3 FMG(2, 100, 100) in FAS, relaxed to 2^3: the wavefront on
    # 256^3, the half-sweeps on 128^3, the resident kernel below
    "fas257": (*F32_3D, "residual_zero_f", "timeskew", "merged_resident",
               "resident3d", "small_restrict", "small_prolong_blend"),
    # 257^3 split over ranks: the time-skew chunk on 256^3 (with its split
    # and merge per leg), the masked block on 128^3; the transfers and
    # residuals are the plain ops (JAX's jnp under GSPMD)
    "sharded257": ("split", "merge", "timeskew_shard", "masked_block"),
    # 65^3 FAS split over ranks: the masked block on the sharded levels,
    # the resident kernel on the replicated ones (none on one rank)
    "sharded_fas": ("masked_block",),
    # 4097^2 Lyapunov split over ranks: every relaxed level by the color
    # slab, its v and f split and merged once per leg (on one rank
    # 4097^2 ... 513^2 in chunks, 257^2 ... 65^2 a whole leg a launch); the
    # transfers and residuals are the plain ops (JAX's jnp under GSPMD)
    "sharded_lyap": ("split2d", "merge2d", "color_slab2d_shard",
                     "color_slab2d_leg"),
    # the thesis' 2D Lyapunov presets, relaxed to 3^2: 1025^2 (row 16's
    # chunks on 1025^2 and 513^2, row 1 below) and 65^2 (row 1 on every
    # level)
    "preset_lyap1025": ("split2d", "merge2d", "color_slab2d_shard",
                        "resident"),
    "preset_lyap65": ("resident",),
    # 4097^2 Lyapunov with the reduced opt-in: row 18 on 4097^2 ... 513^2,
    # each leg's v (and f) split and merged, the resident kernel below
    "lyapunov_reduced": ("split2d", "merge2d", "reduced2d", "resident"),
    # 257^3 f32 with the wavefront off: row 19 on 256^3, the half-sweeps on
    # 128^3
    "f32_257_blocked": (*F32_3D, "blocked3d"),
    # the bench's anis3d row: the line kernel on every relaxed level, the
    # plain ops on the card for the rest (JAX's jnp tier)
    "anis3d": ("zebra_line",),
    # 129^3 FMG(2, 2, 2) W-cycles through the CLI: the presets' kernels,
    # the fused subtree with mu = 2
    "wcycle129": (*F32_3D, "subtree", "small_restrict",
                  "small_prolong_blend"),
    # 2D Poisson at 4097^2: wrap storage (the slab on 4096^2 ... 512^2, the
    # dense leg below) and padded storage (row 16's chunk on the split
    # levels 4097^2 ... 513^2 with their conversions, the leg below); the
    # transfers and norms are the plain ops (JAX's jnp)
    "poisson2d_wrap": ("slab2d_poisson", "resident_poisson"),
    "poisson2d_padded": ("split2d", "merge2d", "color_slab2d_poisson",
                         "resident_poisson"),
    # the W-cycles (mu = 2) of the 2D and 1D plans at 513^2 / 1025 points
    "wcycle_poisson2d_wrap": ("slab2d_poisson", "resident_poisson"),
    "wcycle_poisson2d_padded": ("split2d", "merge2d", "color_slab2d_poisson",
                                "resident_poisson"),
    "wcycle_lyapunov": ("split2d", "merge2d", "color_slab2d_shard",
                        "resident"),
    "wcycle_hjb": ("slab2d", "resident_hjb"),
    "wcycle_ode1d": ("relax1d",),
    # 3D padded Poisson: the leg on 65^3 and below, the sweep kernel above
    "poisson3d_padded_257": ("padded3d", "slab3d"),
    "poisson3d_padded_513": ("padded3d", "slab3d"),
    "poisson3d_padded_129": ("padded3d", "slab3d"),
    "poisson3d_padded_cli": ("padded3d", "slab3d"),
    "wcycle_poisson3d_padded": ("padded3d",),
    "fas_poisson3d_padded": ("padded3d",),
}

# per-sweep barrier floors of the whole-leg kernels, measured on the
# smallest levels (printed with the main-path summaries)
FLOORS = {}
# the wavefront's dense 100-sweep leg per level beside the chains it
# replaces or stands beside, ms (printed with the summaries)
TIMESKEW_AB = {}


class Failed(Exception):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise Failed(msg)


def time_ms(torch, fn, reps: int) -> float:
    """Mean ms per call of `fn`, called eagerly `reps` times between two
    CUDA events after one warm-up call: device time plus whatever the
    host's launch overhead leaves the device idle."""
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps


def device_ms(torch, fn, reps: int) -> float:
    """Mean device ms per call of `fn`: `reps` calls captured in one CUDA
    graph and replayed between two CUDA events, so host launch overhead
    drops out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(3):
        graph.replay()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / (3 * reps)


def bound(nbytes: float, ops: float) -> dict:
    """The least time the card could take: the larger of the bytes the
    call must move (inputs read once, outputs written once) over the HBM
    rate and its float32 operations over the float32 rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def updated_points(shape) -> int:
    """The points a red-black sweep of a 3D wrap level (or of a shard's
    owned planes, x = 0 first) updates: x, y, z >= 1 (the planes 0 are the
    boundary, never updated)."""
    X, Y, Z = shape
    return (X - 1) * (Y - 1) * (Z - 1)


def take_index(torch, fn, *shapes):
    """The int64 index tensor(s) that make `torch.take` compute the
    permutation `fn`: `fn` applied to float64 iotas (exact up to 2^53)."""
    dev = torch.device("cuda")
    iotas, base = [], 0
    for shp in shapes:
        n = 1
        for d in shp:
            n *= d
        iotas.append(torch.arange(base, base + n, dtype=torch.float64,
                                  device=dev).reshape(shp))
        base += n
    out = fn(*iotas)
    if isinstance(out, tuple):
        out = torch.stack(out)
    return out.to(torch.int64)


def paired_times(torch, kernel_fn, plain_fn, reps: int):
    """{"ms", "plain_ms"} device times (CUDA graph replay) and
    {"eager_ms", "eager_plain_ms"} eager per-call times, each measured in
    turns plain, kernel, kernel, plain and averaged per side."""
    out = {}
    for key, timer in (("", device_ms), ("eager_", time_ms)):
        p1 = timer(torch, plain_fn, reps)
        k1 = timer(torch, kernel_fn, reps)
        k2 = timer(torch, kernel_fn, reps)
        p2 = timer(torch, plain_fn, reps)
        out[key + "ms"] = (k1 + k2) / 2
        out[key + "plain_ms"] = (p1 + p2) / 2
    return out


def leg_times(torch, kernel_fn, plain_fn):
    """{"ms", "plain_ms", "eager_ms", "eager_plain_ms"} of a whole leg: the
    kernel graph-replayed twice around the plain version's eager call
    (kernel, plain, kernel; hundreds of PyTorch operations on large
    tensors, so its eager time is its device time to within the host's
    launches, which the warm-up keeps off the clock)."""
    k1 = device_ms(torch, kernel_fn, 1)
    plain_ms = time_ms(torch, plain_fn, 1)
    k2 = device_ms(torch, kernel_fn, 1)
    return {"ms": (k1 + k2) / 2, "plain_ms": plain_ms,
            "eager_ms": time_ms(torch, kernel_fn, 2),
            "eager_plain_ms": plain_ms}


def phase_card(torch):
    require(
        torch.cuda.is_available(),
        "torch.cuda.is_available() is false: this check runs on a GPU only",
    )
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    require(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"torch.cuda.get_device_name(0): {torch.cuda.get_device_name(0)}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"devices {torch.cuda.device_count()}")
    return card


def phase_build():
    from pde_multigrid_tpu_torch.ops.cuda import build

    lib = build.load()
    log(f"build: {'compiled' if lib.built else 'loaded'} {lib.path.name} "
        f"in {lib.seconds:.2f} s from {len(build.sources())} sources")
    # ptxas's lines: registers, and each kernel's stack frame and spills
    ptxas = [ln for ln in build.build_log().splitlines()
             if "ptxas" in ln or "spill" in ln]
    for ln in ptxas:
        print(ln, file=sys.stderr)
    return lib.seconds


def _max_err(torch, a, b) -> float:
    return float(torch.max(torch.abs(a - b)))


# row 10's bitwise sweep counts, and the odd shapes (dense, stored + 1)
# it is held on beside the bench's levels: halves (64, 65, 100), an
# odd-tiled wavefront level whose 65 rows no cluster divides, and
# (10, 13, 38)
ERROR_NUS = (*range(1, 10), 100)
# the anisotropic spacing's (the error mode's other update form) at
# 256^3 and 512^3: one launch of T, a remainder, a chain of three
ERROR_NUS_ANISO = (1, 4, 9)
ERROR_ODD = ((65, 131, 101), (11, 27, 39))
# row 10's 100-sweep legs by level beside the half-sweep chain and the
# plain version, ms (printed with the summaries)
ERROR_AB = {}


def check_error_sweeps(torch, fn, problem, g, halves, rng, nus=ERROR_NUS):
    """fn (a row-10 wrapper) bitwise `error_sweeps_plain` at every nu of
    `nus` on the bf16 residual halves `halves` (None: random ones,
    boundary planes included, which every form must ignore)."""
    from pde_multigrid_tpu_torch.ops.cuda import relax as R

    if halves is None:
        X, Y, Z = g.padded_shape
        halves = [torch.tensor(rng.standard_normal((X, Y // 2, Z)).astype(
            "float32"), device="cuda").to(torch.bfloat16) for _ in range(2)]
    rr, rb = halves
    for nu in nus:
        k = fn(rr, rb, nu, problem, g)
        p = R.error_sweeps_plain(rr, rb, nu, problem, g)
        same = all(torch.equal(a.view(torch.int16), b.view(torch.int16))
                   for a, b in zip(k, p))
        err = max(_max_err(torch, a.float(), b.float())
                  for a, b in zip(k, p))
        require(same, f"{fn.__name__} at {tuple(rr.shape)} nu = {nu} "
                f"(spacing {g.spacing}) not bitwise: max diff {err!r}")


def phase_kernels(torch):
    """Every kernel against its plain version at 128^3 / 64^3; returns
    {name: {"max_abs_err", "ms", "plain_ms"}}."""
    import numpy as np

    from pde_multigrid_tpu_torch.grid import build_geometries, wrap_interior
    from pde_multigrid_tpu_torch.models import Poisson, Poisson3D
    from pde_multigrid_tpu_torch.ops.cuda import defect as D
    from pde_multigrid_tpu_torch.ops.cuda import relax as R

    dev = torch.device("cuda")
    prob = Poisson3D()
    gf, gc = build_geometries((129,) * 3, prob.domain, 2, wrap=True)
    rng = np.random.default_rng(2024)

    def rand(shape, interior_only):
        a = rng.standard_normal(shape).astype(np.float32)
        if interior_only:  # wrap invariant: stored plane 0 stays zero
            a *= wrap_interior(shape)
        return torch.tensor(a, device=dev)

    v = rand(gf.padded_shape, True)
    f = rand(gf.padded_shape, False)
    out = {}

    def record(name, err, t, nbytes, ops, lib_ms=None):
        out[name] = {"max_abs_err": err, "ms": t["ms"],
                     "plain_ms": t["plain_ms"], **bound(nbytes, ops),
                     "library_ms": lib_ms}
        log(f"kernel {name}: max|kernel - plain| = {err!r}; device "
            f"{t['ms']!r} ms vs plain {t['plain_ms']!r} ms (bound "
            f"{out[name]['bound_ms']!r} ms by {out[name]['bound_by']}, "
            f"torch.take {lib_ms!r} ms); eager call {t['eager_ms']!r} ms "
            f"vs plain {t['eager_plain_ms']!r} ms")

    # split / merge: bitwise, including the round trip
    r, b = R.split(v)
    pr, pb = R.split_colors(v)
    err = max(_max_err(torch, r, pr), _max_err(torch, b, pb))
    require(torch.equal(r, pr) and torch.equal(b, pb), "split not bitwise")
    t = paired_times(torch, lambda: R.split(v),
                           lambda: R.split_colors(v), 20)
    # the library call: one torch.take of v with the permutation's index
    idx = take_index(torch, R.split_colors, v.shape)
    require(torch.equal(torch.take(v, idx), torch.stack([r, b])),
            "torch.take does not compute split")
    record("split", err, t, 2 * v.nbytes, 0,
           device_ms(torch, lambda: torch.take(v, idx), 20))
    back = R.merge(r, b)
    require(torch.equal(back, v), "merge(split(v)) != v")
    require(torch.equal(back, R.merge_colors(r, b)), "merge not bitwise")
    t = paired_times(torch, lambda: R.merge(r, b),
                           lambda: R.merge_colors(r, b), 20)
    rb = torch.stack([r, b])  # the halves as one source tensor
    idx = take_index(torch, R.merge_colors, r.shape, b.shape)
    require(torch.equal(torch.take(rb, idx), v),
            "torch.take does not compute merge")
    record("merge", _max_err(torch, back, R.merge_colors(r, b)), t,
           2 * v.nbytes, 0, device_ms(torch, lambda: torch.take(rb, idx), 20))

    # relax: one sweep bitwise, 100 sweeps within REL_TOL
    fr, fb = R.split(f)
    k_r, k_b = r.clone(), b.clone()
    p_r, p_b = r.clone(), b.clone()
    R.relax_halves(k_r, k_b, fr, fb, 1, prob, gf)
    R.half_sweep_plain(p_r, p_b, fr, R.RED, prob, gf)
    R.half_sweep_plain(p_b, p_r, fb, R.BLACK, prob, gf)
    require(torch.equal(k_r, p_r) and torch.equal(k_b, p_b),
            "one relax sweep not bitwise")
    k_r, k_b = r.clone(), b.clone()
    p_r, p_b = r.clone(), b.clone()
    R.relax_halves(k_r, k_b, fr, fb, 100, prob, gf)
    for _ in range(100):
        R.half_sweep_plain(p_r, p_b, fr, R.RED, prob, gf)
        R.half_sweep_plain(p_b, p_r, fb, R.BLACK, prob, gf)
    err = max(_max_err(torch, k_r, p_r), _max_err(torch, k_b, p_b))
    scale = max(float(torch.max(torch.abs(p_r))),
                float(torch.max(torch.abs(p_b))))
    require(err <= REL_TOL * scale, "100 relax sweeps disagree")
    # time one sweep (a red and a black launch) and report per half-sweep
    t_r, t_b = r.clone(), b.clone()

    def plain_sweep():
        R.half_sweep_plain(t_r, t_b, fr, R.RED, prob, gf)
        R.half_sweep_plain(t_b, t_r, fb, R.BLACK, prob, gf)

    t = paired_times(
        torch, lambda: R.relax_halves(t_r, t_b, fr, fb, 1, prob, gf),
        plain_sweep, 25,
    )
    # per half-sweep: u read and written, w and fu read; 13 operations an
    # updated point of the colour (3 pair sums, 3 products and 3 sums, the
    # negation, the scale, the blend's difference and sum)
    record("half_sweep", err, {k: x / 2 for k, x in t.items()},
           4 * r.nbytes, 13 * updated_points(gf.padded_shape) / 2)

    # row 27, with f and f-less, bitwise on every level 512^3 ... 2^3 and
    # two odd ones; the records at 128^3
    check_residuals(torch, prob, record)

    # rows 25 and 26 bitwise on the 513^3 path's fine levels, their
    # records at 128^3
    check_transfers(torch, prob, record)

    # the bf16 defect trio.  residual_split: bitwise
    k_r = D.residual_split(v, f, prob, gf)
    p_r = D.residual_split_plain(v, f, prob, gf)
    require(all(map(torch.equal, k_r, p_r)), "residual_split not bitwise")
    err = max(_max_err(torch, a.float(), b.float()) for a, b in zip(k_r, p_r))
    t = paired_times(torch, lambda: D.residual_split(v, f, prob, gf),
                     lambda: D.residual_split_plain(v, f, prob, gf), 20)
    record("residual_split", err, t, 2 * v.nbytes + v.numel() * 2,
           16 * v.numel())

    # row 10, the error sweeps from e = 0: the whole-leg kernel (the
    # plan's form on 128^3 and below) bitwise its plain version at
    # nu = 1 ... 9 and 100 on 128^3, 64^3 and odd shapes, with isotropic
    # and anisotropic spacing (the kernel's two update forms); the
    # wavefront's error mode is held in phase_kernels_timeskew
    rr, rb = p_r
    aniso = ((0.0, 1.0), (0.0, 2.0), (0.0, 4.0))
    ga = build_geometries((129,) * 3, aniso, 2, wrap=True)[0]
    for pb, g, halves in ((prob, gf, p_r),
                          (Poisson(3, domain=aniso), ga, p_r),
                          *((prob, g, None) for g in (
                              gc, *(build_geometries(s, prob.domain, 1,
                                                     wrap=True)[0]
                                    for s in ERROR_ODD)))):
        check_error_sweeps(torch, R.error_leg, pb, g, halves, rng)
    log(f"kernel error_leg: bitwise against error_sweeps_plain at nu = "
        f"{ERROR_NUS} on the halves levels (128, 64, 128) (isotropic and "
        f"anisotropic), (64, 32, 64), "
        f"{[(s[0] - 1, (s[1] - 1) // 2, s[2] - 1) for s in ERROR_ODD]}")
    # a 100-sweep leg beside its plain version and the half-sweep chain it
    # replaces (the chain per half-sweep: row 10's earlier form, still the
    # form of the levels that fit neither kernel)
    nsw = 100
    k_e = R.error_leg(rr, rb, nsw, prob, gf)
    t = leg_times(torch, lambda: R.error_leg(rr, rb, nsw, prob, gf),
                  lambda: R.error_sweeps_plain(rr, rb, nsw, prob, gf))
    chain_ms = device_ms(torch, lambda: R.error_chain(rr, rb, nsw, prob, gf),
                         1)
    c_e = R.error_chain(rr, rb, nsw, prob, gf)
    require(all(torch.equal(a, b) for a, b in zip(c_e, k_e)),
            "the half-sweep chain and the leg differ")
    # the leg reads rr and rb once and writes er and eb once; per sweep and
    # updated point 8 operations (3 pair sums, 2 sums, 2 products, the
    # select)
    record("error_leg", 0.0, t, 4 * rr.nbytes,
           nsw * 8 * updated_points(gf.padded_shape))
    ERROR_AB["128^3"] = {"leg_ms": t["ms"], "plain_ms": t["plain_ms"],
                         "chain_ms": chain_ms,
                         "layout": R.error_leg_layout(*rr.shape, R._sm_count(
                             rr.device.index))}
    # per half-sweep: the other color and the RHS half read, one written
    # (bf16); 8 operations an updated point of the colour
    record("error_sweep", 0.0, {"ms": chain_ms / (2 * nsw),
                                "plain_ms": t["plain_ms"] / (2 * nsw),
                                "eager_ms": float("nan"),
                                "eager_plain_ms": float("nan")},
           3 * rr.nbytes, 8 * updated_points(gf.padded_shape) / 2)
    log(f"row 10 at 128^3, a {nsw}-sweep leg: {ERROR_AB['128^3']!r}")

    # merge_fold, in place into v: bitwise
    er, eb = k_e
    vk = v.clone()
    D.merge_fold(er, eb, vk)
    vp = D.merge_fold_plain(er, eb, v)
    require(torch.equal(vk, vp), "merge_fold not bitwise")
    t = paired_times(torch, lambda: D.merge_fold(er, eb, vk),
                     lambda: D.merge_fold_plain(er, eb, v), 20)
    record("merge_fold", _max_err(torch, D.merge_fold(er, eb, v.clone()),
                                  vp), t,
           er.nbytes + eb.nbytes + 2 * v.nbytes, v.numel())
    torch.cuda.synchronize()
    return out


# the fine levels rows 25 and 26 are held at (those of the 513^3 path),
# and their kernel and plain ms by level (printed with the summaries)
TRANSFER_LEVELS = (128, 256, 512)
TRANSFER_AB = {}


def check_transfers(torch, prob, record):
    """Rows 25 and 26 on the fine levels 128^3, 256^3 and 512^3: residual
    + restrict in both modes (restrict alone on f, whose boundary planes
    are not zero: the FMG RHS cascade) and prolong + blend in both modes,
    into a new tensor and in place into the base, each equal to its plain
    version (torch.equal); each timed beside its plain version by level
    (TRANSFER_AB), the records (`record`) at 128^3."""
    import numpy as np

    from pde_multigrid_tpu_torch.grid import build_geometries, wrap_interior
    from pde_multigrid_tpu_torch.ops.cuda import transfer as T

    rng = np.random.default_rng(2057)
    for n in TRANSFER_LEVELS:
        gf, gc = build_geometries((n + 1,) * 3, prob.domain, 2, wrap=True)
        fs, cs = gf.padded_shape, gc.padded_shape
        v = torch.tensor((rng.standard_normal(fs) * wrap_interior(fs))
                         .astype(np.float32), device="cuda")
        f = torch.tensor(rng.standard_normal(fs).astype(np.float32),
                         device="cuda")
        c = torch.tensor((rng.standard_normal(cs) * wrap_interior(cs))
                         .astype(np.float32), device="cuda")
        tag = f"{n}^3"
        calls = {
            "residual_restrict": (
                lambda: T.residual_restrict(v, f, prob, gf, gc),
                lambda: T.residual_restrict_plain(v, f, prob, gf, gc, True)),
            "restrict": (
                lambda: T.residual_restrict(f, None, prob, gf, gc,
                                            with_residual=False),
                lambda: T.residual_restrict_plain(f, None, prob, gf, gc,
                                                  False)),
        }
        for name, (kern, plain) in calls.items():
            require(torch.equal(kern(), plain()), f"{name} {tag} not bitwise")
        dst = torch.empty_like(v)
        for mode in ("add", "replace"):
            p = T.prolong_blend_plain(c, v, mode)
            require(torch.equal(T.prolong_blend(c, v, mode, gc, gf), p),
                    f"prolong_blend({mode}) {tag} not bitwise")
            w = v.clone()
            require(T.prolong_blend(c, w, mode, gc, gf, out=w) is w
                    and torch.equal(w, p),
                    f"prolong_blend({mode}) {tag} in place not bitwise")
            calls[f"prolong_{mode}"] = (
                lambda mode=mode: T.prolong_blend(c, v, mode, gc, gf,
                                                  out=dst),
                lambda mode=mode: T.prolong_blend_plain(c, v, mode))
        reps = {128: 20, 256: 5, 512: 2}[n]
        ab = TRANSFER_AB[tag] = {}
        for name, (kern, plain) in calls.items():
            t = paired_times(torch, kern, plain, reps)
            fine_bytes = (1 if name == "restrict" else 2) * v.nbytes
            ab[name] = {"ms": t["ms"], "plain_ms": t["plain_ms"],
                        "bound_ms": (fine_bytes + c.nbytes)
                        / HBM_BYTES_PER_S * 1e3}
            if n == 128 and name in ("residual_restrict", "prolong_add"):
                # the records: the residual at every fine point and a
                # 27-point weighted sum per coarse point; trilinear weights
                # (up to 7 sums and a scale) and the blend
                ops = (14 * v.numel() + 53 * c.numel()
                       if name == "residual_restrict" else 10 * v.numel())
                record(name.replace("_add", "_blend"), 0.0, t,
                       2 * v.nbytes + c.nbytes, ops)
        log(f"transfers {tag} (rows 25, 26): bitwise in both modes, "
            f"prolongation also in place; ms {ab!r}")
        del v, f, c, dst, w, calls
        torch.cuda.empty_cache()


# the levels row 27 is held at: every level of the 513^3 path and of FAS
# 257^3, a non-cubic one and one whose extents are not powers of two (the
# point form); its kernel, plain and bound ms by level, with f and f-less
# (printed with the summaries)
RESIDUAL_LEVELS = [(n,) * 3 for n in (512, 256, 128, 64, 32, 16, 8, 4, 2)
                   ] + [(64, 32, 128), (24, 12, 20)]
RESIDUAL_AB = {}


def check_residuals(torch, prob, record):
    """Row 27 on RESIDUAL_LEVELS, with f (`transfer.residual`) and f-less
    (`transfer.residual_zero_f`), each equal to its plain version
    (torch.equal) and the f-less one also to residual_plain(v, 0); each
    timed beside its plain version by level (RESIDUAL_AB), the records
    (`record`) at 128^3."""
    import numpy as np

    from pde_multigrid_tpu_torch.grid import build_geometries, wrap_interior
    from pde_multigrid_tpu_torch.ops.cuda import transfer as T

    rng = np.random.default_rng(2058)
    for shape in RESIDUAL_LEVELS:
        g = build_geometries(tuple(n + 1 for n in shape), ((0.0, 1.0),) * 3,
                             1, wrap=True)[0]
        require(tuple(g.padded_shape) == shape, f"level {g.padded_shape}")
        v = torch.tensor((rng.standard_normal(shape) * wrap_interior(shape))
                         .astype(np.float32), device="cuda")
        f = torch.tensor(rng.standard_normal(shape).astype(np.float32),
                         device="cuda")
        tag = "x".join(map(str, shape))
        k, p = T.residual(v, f, prob, g), T.residual_plain(v, f, prob, g)
        require(torch.equal(k, p), f"residual {tag} not bitwise: max diff "
                f"{_max_err(torch, k, p)!r}")
        k0 = T.residual_zero_f(v, prob, g)
        p0 = T.residual_plain(v, None, prob, g)
        require(torch.equal(k0, p0) and torch.equal(k0, T.residual_plain(
            v, torch.zeros_like(v), prob, g)),
            f"residual_zero_f {tag} not bitwise: max diff "
            f"{_max_err(torch, k0, p0)!r}")
        reps = {512: 2, 256: 5}.get(shape[0], 20)
        t = paired_times(torch, lambda: T.residual(v, f, prob, g),
                         lambda: T.residual_plain(v, f, prob, g), reps)
        t0 = paired_times(torch, lambda: T.residual_zero_f(v, prob, g),
                          lambda: T.residual_plain(v, None, prob, g), reps)
        # 2 v, (a - 2v + b) w per axis and their sum, f - L v, the mask: 14
        # a point (f-less 0 - L v the same)
        b3, b2 = bound(3 * v.nbytes, 14 * v.numel()), bound(
            2 * v.nbytes, 14 * v.numel())
        lay = T.residual_layout(shape, True)
        RESIDUAL_AB[tag] = {
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": b3["bound_ms"], "zero_f_ms": t0["ms"],
            "zero_f_plain_ms": t0["plain_ms"],
            "zero_f_bound_ms": b2["bound_ms"],
            "form": "walk" if lay.form == T.WALK else "point",
            "TJ": lay.TJ, "bands": lay.gy if lay.form == T.WALK else 0}
        if shape == (128,) * 3:
            record("residual", _max_err(torch, k, p), t, 3 * v.nbytes,
                   14 * v.numel())
            record("residual_zero_f", _max_err(torch, k0, p0), t0,
                   2 * v.nbytes, 14 * v.numel())
        del v, f, k, p, k0, p0
        torch.cuda.empty_cache()
    log(f"residual (row 27): bitwise with f and f-less on {len(RESIDUAL_AB)}"
        f" levels; ms {RESIDUAL_AB!r}")


def defect_chain_relax(problem, g):
    """The defect leg with row 10 as its earlier form, the half-sweep chain
    (`relax.error_chain`): the parent's defect path, for the A/B."""
    from pde_multigrid_tpu_torch.ops.cuda import defect as D
    from pde_multigrid_tpu_torch.ops.cuda import relax as R

    def relax(v, f, nsweeps):
        rr, rb = D.residual_split(v, f, problem, g)
        er, eb = R.error_chain(rr, rb, nsweeps, problem, g)
        return D.merge_fold(er, eb, v)

    return relax


def timeskew_leg_bytes(shape, nsweeps: int, T: int) -> int:
    """The HBM bytes a wavefront leg moves at T sweeps a launch on halves
    `shape`: every launch reads b, fr and fb once and writes b once, the
    last one also r (relax.timeskew_relax_halves)."""
    X, Y2, Z = shape
    n = X * Y2 * Z * 4
    return -(-nsweeps // T) * 4 * n + n


def phase_kernels_timeskew(torch):
    """The wavefront kernel (csrc/timeskew.cu) against its plain version,
    bitwise: on small and odd-tiled wrap levels (16^3, 32^3, 64^3, a
    (10, 13, 38) and a (64, 65, 100) halves level: clusters of 8 and 16
    CTAs, one CTA of 13 rows, bands with recomputed halos, 2 z points a
    thread where Z % 4 != 0) and at the 256^3 and 512^3 levels, over
    nu = 1 ... 2T + 1 (every remainder launch, one launch of T, chains
    with each remainder) and 100, with and without v_zero.  On 256^3 and
    512^3 a 100-sweep leg on halves timed beside the plain version at
    T = TIMESKEW_T (the record, with its HBM traffic over its time), and
    at every T the kernel is built for; the dense 100-sweep leg
    (black-only split of v, split of f, sweeps, merge) of the wavefront
    beside the two chains it replaces or stands beside: the f32
    half-sweeps (one launch each, `make_split_relax`) and the bf16 defect
    leg (the mixed plan's choice on these levels).  On 128^3 and 64^3,
    below the gate, the dense leg of the wavefront beside the half-sweeps
    that relax them.  Returns {"timeskew": the 256^3 record,
    "timeskew_jb": the 512^3 record}, each per 100-sweep leg."""
    import numpy as np

    from pde_multigrid_tpu_torch.grid import build_geometries, wrap_interior
    from pde_multigrid_tpu_torch.models import Poisson, Poisson3D
    from pde_multigrid_tpu_torch.ops.cuda import defect as D
    from pde_multigrid_tpu_torch.ops.cuda import relax as R

    dev = torch.device("cuda")
    prob = Poisson3D()
    rng = np.random.default_rng(2027)
    T = R.TIMESKEW_T
    nsw = 100
    nus = (*range(1, 2 * T + 2), nsw)
    out = {}

    def rand(shape):
        return torch.tensor(rng.standard_normal(shape).astype(np.float32),
                            device=dev)

    def halves(g):
        X, Y, Z = g.padded_shape
        return [rand((X, Y // 2, Z)) for _ in range(3)]

    def check(g, b, fr, fb, ns, v_zero=False):
        k = R.timeskew_relax_halves(None if v_zero else b, fr, fb, ns, prob,
                                    g, v_zero)
        p = R.timeskew_sweeps_plain(b, fr, fb, ns, prob, g, v_zero)
        err = max(_max_err(torch, a, c) for a, c in zip(k, p))
        require(all(map(torch.equal, k, p)),
                f"timeskew {tuple(fr.shape)} nu={ns} v_zero={v_zero}"
                f" not bitwise: max diff {err!r}")
        return err

    def check_all(g, b, fr, fb):
        return max(check(g, b, fr, fb, ns, vz) for ns in nus
                   for vz in (False, True))

    def dense_legs(g, legs):
        v = rand(g.padded_shape) * torch.tensor(
            wrap_interior(g.padded_shape), device=dev)
        f = rand(g.padded_shape)
        _, bk = R.split(v, red=False)
        require(torch.equal(bk, R.split_colors(v)[1]),
                f"black-only split at {g.padded_shape} not bitwise")
        # each leg relaxes v in place, again at every call
        return {k: device_ms(torch, lambda fn=fn: fn(v, f, nsw), 1)
                for k, fn in legs.items()}

    aniso = ((0.0, 1.0), (0.0, 2.0), (0.0, 4.0))

    def error_leg_record(g, name):
        """Row 10's error mode on the level: bitwise at ERROR_NUS (with
        anisotropic spacing at ERROR_NUS_ANISO), a 100-sweep leg timed
        beside its plain version and the half-sweep chain; at 256^3 the
        error_timeskew record."""
        X, Y, Z = g.padded_shape
        rr, rb = [rand((X, Y // 2, Z)).to(torch.bfloat16) for _ in range(2)]
        check_error_sweeps(torch, R.error_timeskew, prob, g, (rr, rb), rng)
        ga = build_geometries(tuple(n + 1 for n in g.padded_shape), aniso,
                              1, wrap=True)[0]
        check_error_sweeps(torch, R.error_timeskew, Poisson(3, domain=aniso),
                           ga, (rr, rb), rng, ERROR_NUS_ANISO)
        t = leg_times(
            torch, lambda: R.error_timeskew(rr, rb, nsw, prob, g),
            lambda: R.error_sweeps_plain(rr, rb, nsw, prob, g))
        chain_ms = device_ms(
            torch, lambda: R.error_chain(rr, rb, nsw, prob, g), 1)
        # the leg reads rr and rb once and writes er and eb once; per sweep
        # and updated point 8 operations (3 pair sums, 2 sums, 2 products,
        # the select)
        rec = {"max_abs_err": 0.0, "ms": t["ms"], "plain_ms": t["plain_ms"],
               **bound(4 * rr.nbytes,
                       nsw * 8 * updated_points(g.padded_shape)),
               "library_ms": None}
        key = f"{X}^3"
        ERROR_AB[key] = {**rec, "chain_ms": chain_ms,
                         "launches": R.error_launches("wavefront", nsw)}
        if name == "timeskew":
            out["error_timeskew"] = rec
        log(f"kernel error_timeskew ({key}, one {nsw}-sweep leg, "
            f"{ERROR_AB[key]['launches']} launches): bitwise at nu = "
            f"{ERROR_NUS} (anisotropic at {ERROR_NUS_ANISO}); "
            f"{ERROR_AB[key]!r}; "
            f"eager {t['eager_ms']!r} ms vs plain {t['eager_plain_ms']!r}")

    small = ((17, 17, 17), (33, 33, 33), (65, 65, 65), (11, 27, 39),
             (65, 131, 101))
    for shape in small:
        g = build_geometries(shape, prob.domain, 1, wrap=True)[0]
        check_all(g, *halves(g))
    log(f"kernel timeskew: bitwise against its plain version at nu = "
        f"{nus}, with and without v_zero, on the halves levels "
        f"{[(s[0] - 1, (s[1] - 1) // 2, s[2] - 1) for s in small]}")
    # row 10's error mode (k = 4: Z % 4 == 0) on the small levels and the
    # odd-tiled (64, 65, 100), which the plan gives the whole-leg kernel
    err_small = ((17, 17, 17), (33, 33, 33), (65, 131, 101))
    for shape in err_small:
        g = build_geometries(shape, prob.domain, 1, wrap=True)[0]
        check_error_sweeps(torch, R.error_timeskew, prob, g, None, rng)
    log(f"kernel error_timeskew: bitwise against error_sweeps_plain at nu = "
        f"{ERROR_NUS} on the halves levels "
        f"{[(s[0] - 1, (s[1] - 1) // 2, s[2] - 1) for s in err_small]}")

    for name, n in (("timeskew", 257), ("timeskew_jb", 513)):
        g = build_geometries((n,) * 3, prob.domain, 1, wrap=True)[0]
        b, fr, fb = halves(g)
        shape = tuple(fr.shape)
        err = check_all(g, b, fr, fb)
        t = paired_times(
            torch,
            lambda: R.timeskew_relax_halves(b, fr, fb, nsw, prob, g),
            lambda: R.timeskew_sweeps_plain(b, fr, fb, nsw, prob, g), 1)
        # the T ladder: the same leg at every T the kernel is built for
        ladder = {}
        for tt in range(1, R.TIMESKEW_MAX_T + 1):
            ms = device_ms(torch, lambda tt=tt: R.timeskew_relax_halves(
                b, fr, fb, nsw, prob, g, T=tt), 1)
            ladder[f"T{tt}"] = {
                "ms": ms, "launches": -(-nsw // tt),
                "hbm_share": timeskew_leg_bytes(shape, nsw, tt)
                / (ms * 1e-3) / HBM_BYTES_PER_S,
                "layout": {k: v for k, v in R.timeskew_launch_layout(
                    *shape, tt, 4, shape[0]).items()
                    if k in ("ctas", "rows", "bands", "chunks", "lx",
                             "clusters", "redundancy")}}
        dense = dense_legs(g, {
            "wavefront": R.make_timeskew_relax(prob, g),
            "half_sweeps": R.make_split_relax(prob, g),
            "defect": D.plan_defect_relax(prob, g, torch.float32),
            "defect_chain": defect_chain_relax(prob, g)})
        error_leg_record(g, name)
        # the leg reads b, fr and fb once and writes r and b once; per
        # sweep and updated point 13 operations (3 pair sums, 3 products
        # and 3 sums, the negation, the scale, the select).  hbm_share:
        # the bytes the leg's launches move at T (timeskew_leg_bytes)
        # over its time, against the HBM rate
        nl = -(-nsw // T)
        hbm = timeskew_leg_bytes(shape, nsw, T)
        out[name] = {"max_abs_err": err, "ms": t["ms"],
                     "plain_ms": t["plain_ms"],
                     **bound(5 * fr.nbytes,
                             nsw * 13 * updated_points(g.padded_shape)),
                     "library_ms": None,
                     "hbm_share": hbm / (t["ms"] * 1e-3) / HBM_BYTES_PER_S}
        TIMESKEW_AB[f"{n - 1}^3"] = {**dense, "ladder": ladder}
        log(f"kernel {name} ({n - 1}^3, one {nsw}-sweep leg on halves, "
            f"T = {T}, {nl} launches): bitwise at nu = {nus}, with and "
            f"without v_zero; device {t['ms']!r} ms vs plain "
            f"{t['plain_ms']!r} ms (bound {out[name]['bound_ms']!r} ms by "
            f"{out[name]['bound_by']}; {hbm / 1e9:.3f} GB at T = {T}, "
            f"{out[name]['hbm_share']:.3f} of the HBM rate); eager "
            f"{t['eager_ms']!r} ms vs plain {t['eager_plain_ms']!r} ms; "
            f"T ladder {ladder!r}; dense leg ms: {dense!r}")
        del b, fr, fb
    for n in (129, 65):
        g = build_geometries((n,) * 3, prob.domain, 1, wrap=True)[0]
        dense = dense_legs(g, {"wavefront": R.make_timeskew_relax(prob, g),
                               "half_sweeps": R.make_split_relax(prob, g),
                               "defect": D.plan_defect_relax(
                                   prob, g, torch.float32)})
        TIMESKEW_AB[f"{n - 1}^3"] = dense
        log(f"wavefront below its gate ({n - 1}^3, plan: "
            f"{'wavefront' if R.timeskew_plan(g) else 'half-sweeps'}): "
            f"dense {nsw}-sweep leg ms {dense!r}")
    torch.cuda.synchronize()
    return out


# the subtree kernel's roots on the 3D presets' hierarchies (stored
# extents), and the sweep pairs it is held bitwise at on every root
SUBTREE_ROOTS = (64, 32, 16, 8, 4, 2)
SUBTREE_NUS = ((1, 1), (1, 0), (2, 3))
# the presets' nu, checked at the 64^3 and 32^3 roots, timed at every root
SUBTREE_LONG = 3000
# the sub-lane pairs JAX gives its small resident transfer kernels
# (subtree.py _small_pair_ok: a fine level of at most 32^3 here), by the
# fine level's stored shape: rows 23 and 24 count the transfer kernels'
# launches there, rows 25 and 26 the others
SMALL_PAIR_FINE = ((32, 32, 32), (16, 16, 16), (8, 8, 8), (4, 4, 4))
# a non-cubic pair (grid points) the transfers are held on beside them:
# fine (8, 4, 16), coarse (4, 2, 8)
SMALL_PAIR_ODD = (9, 5, 17)
# the subtree kernel's V-cycle per root and nu beside the unfused chain and
# the plain version, ms (printed with the summaries)
SUBTREE_AB = {}


def _subtree_cost(geoms, nu1, nu2, with_root_relax):
    """(bytes, operations) of one fused call: the root's v read and
    written and its f read; per updated point (x, y, z >= 1) and sweep 13
    operations (3 pair sums, 3 products and 3 sums, the negation, the
    scale, the blend's difference and sum) on every relaxed level,
    nu1 + nu2 sweeps each;
    per fine point of each pair the residual (14: 2 c, per axis a
    difference, a sum and a product, 2 sums, f - L v, the mask) and the
    prolongation (10), per coarse point the weighting (53)."""
    pts = [g.padded_shape[0] * g.padded_shape[1] * g.padded_shape[2]
           for g in geoms]
    upd = [updated_points(g.padded_shape) for g in geoms]
    relaxed = upd if with_root_relax else upd[1:]
    ops = 13 * (nu1 + nu2) * sum(relaxed)
    ops += sum(24 * f + 53 * c for f, c in zip(pts, pts[1:]))
    return 3 * 4 * pts[0], ops


def phase_kernels_subtree(torch):
    """The fused subtree V-cycle (csrc/subtree.cu) bitwise against the
    unfused chain of the port's kernels (split, half-sweeps, merge,
    residual_restrict, prolong_blend through `CycleProgram.v_cycle` on a
    `CudaKernels` without a fused plan, every level relaxed by the
    half-sweeps) and against its plain version, at
    the roots 64^3 ... 2^3 of the 65^3 wrap hierarchy, nu = (1, 1), (1, 0),
    (2, 3), with the root relaxed and without (the correction alone); at
    the 64^3 and 32^3 roots also nu = 3000 (the plain version there only
    with the root relaxed: the correction's sub-V-cycle is the next
    root's check).  Inputs are random with the wrap invariant (v zero on
    the stored planes 0), f random everywhere.  The V-cycle at nu = 3000
    is timed at every root, the kernel graph-replayed, at 64^3 and 32^3
    beside the chain (graph-replayed) and the plain version (eager, one
    call: some 2e6 PyTorch operations, too many to capture); from these
    the 64^3 level alone (the 64^3-rooted call less the 32^3-rooted one,
    and per 64^3 half-sweep).  The 32^3 root on a cluster of 8 and of 16
    CTAs (the layout's choice), each bitwise the default call at every nu
    in both variants, timed at nu = 3000 in turns.
    Then the transfer kernels on the
    sub-lane pairs 32^3 -> 16^3 ... 4^3 -> 2^3 (rows 23 and 24: restrict
    alone, and prolong + blend in both modes) bitwise against their plain
    versions, timed at 32^3 -> 16^3.  Returns {"subtree": the 64^3 record
    at nu = 3000, "small_restrict", "small_prolong_blend"}."""
    import numpy as np

    from pde_multigrid_tpu_torch.config import CycleConfig
    from pde_multigrid_tpu_torch.cycles import CycleProgram
    from pde_multigrid_tpu_torch.grid import build_geometries, wrap_interior
    from pde_multigrid_tpu_torch.models import Poisson3D
    from pde_multigrid_tpu_torch.ops.cuda import relax as R
    from pde_multigrid_tpu_torch.ops.cuda import subtree as S
    from pde_multigrid_tpu_torch.ops.cuda import transfer as T
    from pde_multigrid_tpu_torch.ops.cuda.dispatch import CudaKernels

    dev = torch.device("cuda")
    prob = Poisson3D()
    geoms = build_geometries((SUBTREE_ROOTS[0] + 1,) * 3, prob.domain,
                             wrap=True)
    require([g.padded_shape[0] for g in geoms] == list(SUBTREE_ROOTS),
            f"hierarchy {[g.padded_shape for g in geoms]}")
    rng = np.random.default_rng(2028)
    chain_tier = CudaKernels(prob, geoms, torch.float32)  # no fused plan
    require(not any(chain_tier._sub_v), "the chain tier has a fused plan")
    # the chain relaxes every level by the half-sweeps (the plan would give
    # 64^3 ... 2^3 the whole-leg resident kernel), as when ROADMAP queue 2
    # item 13's A/B was first measured
    chain_tier._relax = [R.make_split_relax(prob, g) for g in geoms]
    levels = [prob.init_level(g, torch.float32, dev) for g in geoms]
    out = {}

    def rand(shape, interior_only):
        a = rng.standard_normal(shape).astype(np.float32)
        if interior_only:
            a *= wrap_interior(shape)
        return torch.tensor(a, device=dev)

    def chain(l, v, f, nu1, nu2, with_root_relax):
        """The unfused V-cycle (or correction) on a copy of v."""
        prog = CycleProgram(prob, geoms, CycleConfig("v", 0, nu1, nu2),
                            chain_tier, device=dev)
        v = v.clone()
        if with_root_relax:
            levels[l].v, levels[l].f = v, f
            prog.v_cycle(levels, l, f_is_rhs=False)
            return levels[l].v
        coarse = levels[l + 1]
        coarse.f = T.residual_restrict(v, f, prob, geoms[l], geoms[l + 1])
        coarse.v.zero_()
        prog.v_cycle(levels, l + 1, f_is_rhs=False)
        return T.prolong_blend(coarse.v, v, "add", geoms[l + 1], geoms[l],
                               out=v)

    def kernel(l, v, f, nu1, nu2, with_root_relax):
        return S.subtree_vcycle(v.clone(), f, prob, geoms[l:], nu1, nu2,
                                with_root_relax)

    def plain(l, v, f, nu1, nu2, with_root_relax):
        return S.subtree_vcycle_plain(v, f, prob, geoms[l:], nu1, nu2,
                                      with_root_relax)

    def check(l, nu1, nu2, wr, with_plain=True):
        g = geoms[l]
        v = rand(g.padded_shape, True)
        f = rand(g.padded_shape, False)
        k = kernel(l, v, f, nu1, nu2, wr)
        c = chain(l, v, f, nu1, nu2, wr)
        tag = (f"subtree root {g.padded_shape[0]}^3 nu = ({nu1}, {nu2}) "
               f"with_root_relax={wr}")
        err = _max_err(torch, k, c)
        require(torch.equal(k, c), f"{tag}: kernel != chain, max diff "
                f"{err!r}")
        plain_ms = None
        if with_plain:
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            p = plain(l, v, f, nu1, nu2, wr)
            e1.record()
            e1.synchronize()
            plain_ms = e0.elapsed_time(e1)
            err = max(err, _max_err(torch, k, p))
            require(torch.equal(k, p), f"{tag}: kernel != plain, max diff "
                    f"{err!r}")
        require(bool(torch.isfinite(k).all()), f"{tag}: non-finite")
        return v, f, plain_ms, err

    ncases, max_err = 0, 0.0
    for l in range(len(geoms)):
        for nu1, nu2 in SUBTREE_NUS:
            for wr in (True, False) if l + 1 < len(geoms) else (True,):
                max_err = max(max_err, check(l, nu1, nu2, wr)[3])
                ncases += 1
    log(f"kernel subtree: bitwise against the unfused chain and the plain "
        f"version at roots {list(SUBTREE_ROOTS)}, nu {list(SUBTREE_NUS)}, "
        f"with and without the root's relax ({ncases} cases)")
    nu = SUBTREE_LONG
    for l, root in enumerate(SUBTREE_ROOTS):
        ab = SUBTREE_AB[f"{root}^3 nu={nu}"] = {}
        if l < 2:
            max_err = max(max_err,
                          check(l, nu, nu, False, with_plain=False)[3])
            v, f, plain_ms, err = check(l, nu, nu, True)
            max_err = max(max_err, err)
        else:
            v = rand(geoms[l].padded_shape, True)
            f = rand(geoms[l].padded_shape, False)
        vk = v.clone()
        ab["kernel_ms"] = device_ms(
            torch, lambda: kernel(l, vk, f, nu, nu, True), 1)
        if l < 2:
            ab["chain_ms"] = device_ms(
                torch, lambda: chain(l, vk, f, nu, nu, True), 1)
            ab["plain_eager_ms"] = plain_ms
        if l == 0:
            nbytes, ops = _subtree_cost(geoms, nu, nu, True)
            out["subtree"] = {"max_abs_err": max_err, "ms": ab["kernel_ms"],
                              "plain_ms": plain_ms, **bound(nbytes, ops),
                              "library_ms": None}
        what = ("; bitwise against the chain (graph-replayed) in both "
                "variants and the plain version (eager, one call)"
                if l < 2 else "")
        log(f"kernel subtree ({root}^3 root, nu = {nu}): ms {ab}{what}")
    # the 64^3 level alone: the 64^3-rooted call less the 32^3-rooted one,
    # and per 64^3 half-sweep (2 (nu1 + nu2) of them, nu1 = nu2 = nu)
    lvl = (SUBTREE_AB[f"64^3 nu={nu}"]["kernel_ms"]
           - SUBTREE_AB[f"32^3 nu={nu}"]["kernel_ms"])
    SUBTREE_AB["64^3 level"] = {"ms": lvl, "us_per_half_sweep":
                                lvl * 1e3 / (4 * nu)}
    log(f"kernel subtree: the 64^3 level {lvl!r} ms a call, "
        f"{lvl * 1e3 / (4 * nu)!r} us a half-sweep")
    # the 32^3 root's cluster (subtree.layout's `ctas`): 8 or 16 CTAs, each
    # bitwise the default layout's call, timed at nu = 3000 in turns
    sub = tuple(geoms[1:])
    v = rand(sub[0].padded_shape, True)
    f = rand(sub[0].padded_shape, False)
    for nu1, nu2 in (*SUBTREE_NUS, (nu, nu)):
        for wr in (True, False):
            want = kernel(1, v, f, nu1, nu2, wr)
            for ctas in (8, 16):
                got = v.clone()
                S._launch(got, f, S._params(sub, nu1, nu2, wr, S.CAPACITY,
                                            ctas))
                require(torch.equal(got, want), f"subtree root 32^3 on "
                        f"{ctas} CTAs, nu = ({nu1}, {nu2}) with_root_relax="
                        f"{wr}: not bitwise the default layout's call")
    by_ctas = {8: [], 16: []}
    for ctas in (8, 16, 16, 8):
        params = S._params(sub, nu, nu, True, S.CAPACITY, ctas)
        vk = v.clone()
        by_ctas[ctas].append(device_ms(
            torch, lambda: S._launch(vk, f, params), 1))
    SUBTREE_AB[f"32^3 nu={nu} by cluster"] = {
        str(c): sum(t) / len(t) for c, t in by_ctas.items()}
    log(f"kernel subtree (32^3 root, nu = {nu}) on 8 / 16 CTAs, bitwise: "
        f"{SUBTREE_AB[f'32^3 nu={nu} by cluster']} ms (layout's choice: "
        f"{S.layout(sub, True)['nctas']})")

    # rows 23, 24: the transfer kernels on the sub-lane pairs, and on a
    # non-cubic pair with a coarse axis of 2 points
    errs = {"small_restrict": 0.0, "small_prolong_blend": 0.0}
    pairs = [*zip(geoms[1:], geoms[2:]),
             build_geometries(SMALL_PAIR_ODD, prob.domain, 2, wrap=True)]
    for gf, gc in pairs:
        a = rand(gf.padded_shape, False)
        vb = rand(gf.padded_shape, True)
        c = rand(gc.padded_shape, True)
        pair = f"{gf.padded_shape} -> {gc.padded_shape}"
        for with_res in (False, True):
            k = T.residual_restrict(vb if with_res else a, a, prob, gf, gc,
                                    with_residual=with_res)
            p = T.residual_restrict_plain(vb if with_res else a, a, prob, gf,
                                          gc, with_res)
            if not with_res:
                errs["small_restrict"] = max(errs["small_restrict"],
                                             _max_err(torch, k, p))
            require(torch.equal(k, p), f"residual_restrict({with_res}) "
                    f"{pair} not bitwise")
        for mode in ("add", "replace"):
            k = T.prolong_blend(c, vb, mode, gc, gf)
            p = T.prolong_blend_plain(c, vb, mode)
            errs["small_prolong_blend"] = max(errs["small_prolong_blend"],
                                              _max_err(torch, k, p))
            w = vb.clone()
            T.prolong_blend(c, w, mode, gc, gf, out=w)
            require(torch.equal(k, p) and torch.equal(w, p),
                    f"prolong_blend({mode}) {pair} not bitwise")
        if gf.padded_shape[0] == SMALL_PAIR_FINE[0][0]:
            t = paired_times(
                torch, lambda: T.residual_restrict(a, None, prob, gf, gc,
                                                   with_residual=False),
                lambda: T.residual_restrict_plain(a, None, prob, gf, gc,
                                                  False), 20)
            out["small_restrict"] = {
                "ms": t["ms"], "plain_ms": t["plain_ms"],
                **bound(a.nbytes + a.nbytes // 8, 53 * c.numel()),
                "library_ms": None}
            dst = torch.empty_like(vb)
            t2 = paired_times(
                torch, lambda: T.prolong_blend(c, vb, "replace", gc, gf,
                                               out=dst),
                lambda: T.prolong_blend_plain(c, vb, "replace"), 20)
            out["small_prolong_blend"] = {
                "ms": t2["ms"],
                "plain_ms": t2["plain_ms"],
                **bound(c.nbytes + 2 * vb.nbytes, 11 * vb.numel()),
                "library_ms": None}
            log(f"kernels small_restrict / small_prolong_blend ({pair}): "
                f"device {t['ms']!r} / {t2['ms']!r} ms vs plain "
                f"{t['plain_ms']!r} / {t2['plain_ms']!r} ms")
    for name, err in errs.items():
        out[name]["max_abs_err"] = err
    log("kernels small_restrict / small_prolong_blend: bitwise against "
        "their plain versions (and the residual mode; prolongation also in "
        f"place) on {[s[0] for s in SMALL_PAIR_FINE]}^3 -> half and "
        f"{tuple(n - 1 for n in SMALL_PAIR_ODD)} -> half")
    torch.cuda.synchronize()
    return out


# the masked block's t = T chunk by extended block shape (and at the
# one-rank 128^3 block the one-colour form's 2T launches), ms (printed
# with the summaries)
MASKED_AB = {}


# the whole-leg 3D resident kernel: the levels of the 65^3 wrap hierarchy
# (64^3 ... 2^3), the sweep counts it is held bitwise at, and its 100-sweep
# leg per level beside the half-sweep chain (row 9), ms (printed with the
# summaries)
RESIDENT3D_NUS = (1, 2, 3, 100)
RESIDENT3D_AB = {}


def _resident3d_cost(g, nsweeps: int):
    """(bytes, operations) of one leg: v read and written and f read once,
    12 B a stored point; 13 float32 operations an interior point (x, y,
    z >= 1: the planes 0 are never updated) and sweep (3 pair sums, 3
    products and 3 sums, the negation, the scale, the blend's difference
    and sum)."""
    X, Y, Z = g.padded_shape
    return 12 * X * Y * Z, 13 * (X - 1) * (Y - 1) * (Z - 1) * nsweeps


def phase_kernels_resident3d(torch):
    """The whole-leg 3D resident kernel (csrc/resident3d.cu) in its three
    modes, bitwise against its plain versions and against the row-9 chain
    (split, half-sweeps, merge: `relax.make_split_relax`) on every level
    of 65^3 (64^3 ... 2^3) at nu = 1, 2, 3 and 100: the dense merged mode
    (`merged_resident_relax`, row 4) and the halves mode
    (`split_merged_relax`, row 5; against `relax_halves` on the same
    halves) on the merged gate's levels 64^3, 32^3, 16^3, the one-CTA
    dense mode (`resident3d_relax`, row 1) on 8^3, 4^3, 2^3.  A 100-sweep
    leg timed on every level beside the chain (graph-replayed), and its
    rate a half-sweep beside the fused subtree's on the same level (from
    phase_kernels_subtree, where it ran before).  Returns
    the records of "merged_resident" and
    "split_merged" (64^3) and "resident3d" (8^3), each per 100-sweep
    leg."""
    import numpy as np

    from pde_multigrid_tpu_torch.grid import build_geometries, wrap_interior
    from pde_multigrid_tpu_torch.models import Poisson3D
    from pde_multigrid_tpu_torch.ops.cuda import relax as R
    from pde_multigrid_tpu_torch.ops.cuda import resident3d as RS3

    dev = torch.device("cuda")
    prob = Poisson3D()
    geoms = build_geometries((65,) * 3, prob.domain, wrap=True)
    require([g.padded_shape[0] for g in geoms] == [64, 32, 16, 8, 4, 2],
            f"hierarchy {[g.padded_shape for g in geoms]}")
    rng = np.random.default_rng(2031)
    nsw = RESIDENT3D_NUS[-1]
    out, errs = {}, {"merged_resident": 0.0, "split_merged": 0.0,
                     "resident3d": 0.0}
    # the fused subtree's rate a half-sweep by level (row 22's, from
    # phase_kernels_subtree's nu = SUBTREE_LONG calls: a root's call less
    # the next root's, over its 4 nu half-sweeps)
    roots = [SUBTREE_AB.get(f"{r}^3 nu={SUBTREE_LONG}", {}).get("kernel_ms")
             for r in SUBTREE_ROOTS] + [0.0]
    row22 = {r: (a - b) * 1e3 / (4 * SUBTREE_LONG)
             for r, a, b in zip(SUBTREE_ROOTS, roots, roots[1:])
             if a is not None and b is not None}

    def rand(shape, interior):
        a = rng.standard_normal(shape).astype(np.float32)
        if interior:
            a *= wrap_interior(shape)
        return torch.tensor(a, device=dev)

    for g in geoms:
        merged = RS3.merged_gate(g)
        name = "merged_resident" if merged else "resident3d"
        dense = (RS3.merged_resident_relax if merged
                 else RS3.resident3d_relax)
        v = rand(g.padded_shape, True)
        f = rand(g.padded_shape, False)
        fr, fb = R.split(f)
        row9 = R.make_split_relax(prob, g)
        tag = f"resident3d {g.padded_shape[0]}^3 ({RS3.layout(g)})"
        for ns in RESIDENT3D_NUS:
            k = dense(v.clone(), f, ns, prob, g)
            c = row9(v.clone(), f, ns)
            p = RS3.merged_resident_plain(v, f, ns, prob, g)
            errs[name] = max(errs[name], _max_err(torch, k, c),
                             _max_err(torch, k, p))
            require(torch.equal(k, c) and torch.equal(k, p),
                    f"{tag} {name} nu = {ns}: not bitwise the chain and the "
                    f"plain version, max diff {errs[name]!r}")
            if merged:
                r, b = R.split(v)
                rc, bc = r.clone(), b.clone()
                RS3.split_merged_relax(r, b, fr, fb, ns, prob, g)
                R.relax_halves(rc, bc, fr, fb, ns, prob, g)
                rp, bp = RS3.split_merged_plain(*R.split(v), fr, fb, ns,
                                                prob, g)
                errs["split_merged"] = max(
                    errs["split_merged"], _max_err(torch, r, rc),
                    _max_err(torch, b, bc), _max_err(torch, r, rp))
                require(all(map(torch.equal, (r, b, r, b), (rc, bc, rp, bp)))
                        and torch.equal(R.merge(r, b), k),
                        f"{tag} split_merged nu = {ns}: not bitwise the "
                        f"chain, the plain version and the dense mode")
            require(bool(torch.isfinite(k).all()), f"{tag}: non-finite")
        # each leg relaxes its own copy of v in place, again at each call
        vk, vc = v.clone(), v.clone()
        ab = RESIDENT3D_AB[f"{g.padded_shape[0]}^3"] = {
            "kernel_ms": device_ms(torch, lambda: dense(vk, f, nsw, prob,
                                                        g), 2),
            "chain_ms": device_ms(torch, lambda: row9(vc, f, nsw), 2),
            "layout": RS3.layout(g)}
        ab["us_per_half_sweep"] = ab["kernel_ms"] * 1e3 / (2 * nsw)
        ab["row22_us_per_half_sweep"] = row22.get(g.padded_shape[0])
        log(f"{tag}: {name} bitwise against the row-9 chain and the plain "
            f"version at nu = {list(RESIDENT3D_NUS)}"
            f"{' (and split_merged on halves)' if merged else ''}; "
            f"{nsw}-sweep leg device ms {ab['kernel_ms']!r} vs chain "
            f"{ab['chain_ms']!r}; {ab['us_per_half_sweep']!r} us a "
            f"half-sweep vs the fused subtree's level "
            f"{ab['row22_us_per_half_sweep']!r}")
        records = {"merged_resident": 64, "split_merged": 64,
                   "resident3d": 8}
        for rec in [k for k, s in records.items()
                    if s == g.padded_shape[0] and (merged or k == name)]:
            if rec == "split_merged":
                r, b = R.split(v)
                t = paired_times(
                    torch, lambda: RS3.split_merged_relax(
                        r, b, fr, fb, nsw, prob, g),
                    lambda: RS3.split_merged_plain(r, b, fr, fb, nsw, prob,
                                                   g), 1)
            else:
                vk = v.clone()
                t = paired_times(
                    torch, lambda: dense(vk, f, nsw, prob, g),
                    lambda: RS3.merged_resident_plain(v, f, nsw, prob, g),
                    1)
            out[rec] = {"ms": t["ms"], "plain_ms": t["plain_ms"],
                        **bound(*_resident3d_cost(g, nsw)),
                        "library_ms": None}
            log(f"kernel {rec} ({g.padded_shape[0]}^3, one {nsw}-sweep "
                f"leg): device {t['ms']!r} ms vs plain {t['plain_ms']!r} ms "
                f"(bound {out[rec]['bound_ms']!r} ms by "
                f"{out[rec]['bound_by']}); eager {t['eager_ms']!r} ms vs "
                f"plain {t['eager_plain_ms']!r} ms")
    for name, err in errs.items():
        out[name]["max_abs_err"] = err
    torch.cuda.synchronize()
    return out


# the unsharded 2D Lyapunov path's two relax forms by level, ms
# (printed with the summaries): row 16's T = 4 chunk on the level's
# halves, with and without f, and row 1's 500-sweep leg
LYAP2D_AB = {}
# the levels of each: the split levels (row 16) and the resident ones
# (row 1: its clusters of 16, 15 and 9 CTAs, then the smaller clusters
# and one CTA below the path's levels)
ROW16_LEVELS = (4097, 2049, 1025, 513)
# row 15's odd non-square shapes, beside the split levels
MERGE2D_ODD = ((1025, 2047), (515, 333))
# row 15's times by shape (the summary line)
MERGE2D_AB = {}
ROW1_LEVELS = (257, 129, 65, 33, 17, 9, 3)
ROW1_LEGS = (1, 3, 4, 5, 9, 500)


def phase_kernels2d(torch):
    """The 2D Lyapunov kernels against their plain versions: split2d at
    the 4097^2 level's shapes; merge2d (row 15) on every split level and
    on MERGE2D_ODD, the last also into outputs off a 16-byte boundary,
    each timed beside torch.take (times into MERGE2D_AB); row 16, JAX's
    sweeps_per_call = T form, as the colour slab's one-rank chunk on a
    level's halves at 4097^2, 2049^2, 1025^2 and 513^2: chunks of t = 4,
    1, 3 with and without f against `color_slab2d_shard_plain`, and
    `relax_halves2d`
    over 9 sweeps (two chunks and a remainder, in turns between two
    pairs) against the half-sweep chain; row 1, `resident_relax` (the
    colour slab's leg in dense form, in place) against
    `resident_relax_plain` over legs of ROW1_LEGS sweeps with and without
    f on ROW1_LEVELS.  Every comparison is bitwise.  Timed beside the
    plain versions: the t = 4 chunk on each split level, f and f-less,
    and the 500-sweep leg on 257^2, 129^2 and 65^2, f and f-less.
    Returns {name: record}: color_slab2d for the f-less 4097^2 chunk,
    resident for the f-less 500-sweep leg at 257^2."""
    import numpy as np

    from pde_multigrid_tpu_torch.grid import build_geometries
    from pde_multigrid_tpu_torch.models import Lyapunov2D
    from pde_multigrid_tpu_torch.ops.cuda import relax2d as R2
    from pde_multigrid_tpu_torch.ops.cuda import resident as RS

    dev = torch.device("cuda")
    prob = Lyapunov2D()
    rng = np.random.default_rng(2025)
    out = {}

    def rand(shape):
        return torch.tensor(rng.standard_normal(shape).astype(np.float32),
                            device=dev)

    def record(name, err, t, what, nbytes, ops, lib_ms=None, bnd=None):
        res = {"max_abs_err": err, "ms": t["ms"], "plain_ms": t["plain_ms"],
               **(bnd or bound(nbytes, ops)), "library_ms": lib_ms}
        log(f"kernel {name} ({what}): max|kernel - plain| = {err!r}; device "
            f"{t['ms']!r} ms vs plain {t['plain_ms']!r} ms (bound "
            f"{res['bound_ms']!r} ms by {res['bound_by']}, library "
            f"{lib_ms!r} ms); eager call {t['eager_ms']!r} ms vs plain "
            f"{t['eager_plain_ms']!r} ms")
        return res

    n = 4097
    g = build_geometries((n, n), prob.domain, 1)[0]
    v, f = rand((n, n)), rand((n, n))
    r, b = R2.to_halves(v)
    pr, pb = R2.split_colors_2d(v)
    require(torch.equal(r, pr) and torch.equal(b, pb), "split2d not bitwise")
    t = paired_times(torch, lambda: R2.to_halves(v, out=(r, b)),
                     lambda: R2.split_colors_2d(v), 10)
    # the library call: one torch.take; the inert slot (y = Y of odd rows,
    # which nothing reads) takes point (0, 0) instead of 0
    idx = take_index(torch, R2.split_colors_2d, v.shape)
    live = torch.stack(R2.split_colors_2d(torch.ones_like(v))) > 0
    require(torch.equal(torch.take(v, idx)[live], torch.stack([r, b])[live]),
            "torch.take does not compute split2d")
    out["split2d"] = record(
        "split2d", _max_err(torch, r, pr), t, "4097^2",
        v.nbytes + r.nbytes + b.nbytes, 0,
        device_ms(torch, lambda: torch.take(v, idx), 10))
    del v, f, r, b, pr, pb, idx, live

    # row 15: merge2d at every split level and on odd non-square shapes,
    # the last also into outputs 4, 8 and 12 bytes past a 16-byte
    # boundary, bitwise; each timed beside torch.take and its byte bound
    for X, Y in [(m, m) for m in ROW16_LEVELS] + list(MERGE2D_ODD):
        v = rand((X, Y))
        r, b = R2.to_halves(v)
        dense = torch.empty_like(v)
        R2.from_halves(r, b, dense)
        require(torch.equal(dense, v),
                f"merge2d(split2d(v)) != v at {X}x{Y}")
        require(torch.equal(dense, R2.merge_colors_2d(r, b, Y)),
                f"merge2d not bitwise at {X}x{Y}")
        if (X, Y) == MERGE2D_ODD[-1]:
            buf = torch.empty(X * Y + 3, device=dev)
            for k in (1, 2, 3):
                skewed = buf[k:k + X * Y].view(X, Y)
                R2.from_halves(r, b, skewed)
                require(torch.equal(skewed, v), f"merge2d at {X}x{Y} into "
                        f"an output {4 * k} bytes past a 16-byte boundary")
            del buf, skewed
        t = paired_times(torch, lambda: R2.from_halves(r, b, dense),
                         lambda: R2.merge_colors_2d(r, b, Y), 10)
        rb = torch.stack([r, b])  # the halves as one source tensor
        idx = take_index(torch,
                         lambda r_, b_: R2.merge_colors_2d(r_, b_, Y),
                         r.shape, b.shape)
        require(torch.equal(torch.take(rb, idx), v),
                "torch.take does not compute merge2d")
        res = record(
            "merge2d", 0.0, t, f"{X}x{Y}", r.nbytes + b.nbytes + v.nbytes,
            0, device_ms(torch, lambda: torch.take(rb, idx), 10))
        MERGE2D_AB[f"{X}x{Y}"] = {k: res[k] for k in (
            "ms", "plain_ms", "library_ms", "bound_ms")}
        if (X, Y) == (n, n):
            out["merge2d"] = res
        del v, r, b, dense, rb, idx

    # row 16: the one-rank chunk on each split level's halves
    err16, chunks = 0.0, 0
    LYAP2D_AB["chunk_t4_ms"] = {}
    for m in ROW16_LEVELS:
        gm = build_geometries((m, m), prob.domain, 1)[0]
        r, b = R2.to_halves(rand((m, m)))
        fr, fb = R2.to_halves(rand((m, m)))
        ko = (torch.empty_like(r), torch.empty_like(b))
        spare = (torch.empty_like(r), torch.empty_like(b))
        for hf in ((fr, fb), (None, None)):
            for tc in (R2.CHUNK_T, 1, 3):
                R2.color_slab2d_shard(r, b, *hf, 0, tc, prob, gm, m, ko,
                                      one_rank=True)
                want = R2.color_slab2d_shard_plain(r, b, *hf, 0, tc, prob,
                                                   gm, m)
                e = max(_max_err(torch, x, w) for x, w in zip(ko, want))
                require(all(map(torch.equal, ko, want)),
                        f"color_slab2d {m}^2 chunk t = {tc} (with f: "
                        f"{hf[0] is not None}) not bitwise: max diff {e!r}")
                err16, chunks = max(err16, e), chunks + 1
            k_r, k_b = r.clone(), b.clone()
            got = R2.relax_halves2d(k_r, k_b, *hf, 9, prob, gm, spare=spare)
            p_r, p_b = r.clone(), b.clone()
            for _ in range(9):
                R2.half_sweep2d_plain(p_r, p_b, hf[0], R2.RED, prob, gm)
                R2.half_sweep2d_plain(p_b, p_r, hf[1], R2.BLACK, prob, gm)
            e = max(_max_err(torch, got[0], p_r), _max_err(torch, got[1], p_b))
            require(got is spare and torch.equal(got[0], p_r)
                    and torch.equal(got[1], p_b),
                    f"relax_halves2d {m}^2, 9 sweeps (with f: "
                    f"{hf[0] is not None}) not bitwise the half-sweep "
                    f"chain: max diff {e!r}")
            err16 = max(err16, e)
        times = {}
        for hf in ((None, None), (fr, fb)):
            key = "f" if hf[0] is not None else "no_f"
            ins = (r, b) + ((fr, fb) if hf[0] is not None else ())
            t = paired_times(
                torch,
                lambda: R2.color_slab2d_shard(r, b, *hf, 0, R2.CHUNK_T, prob,
                                              gm, m, ko, one_rank=True),
                lambda: R2.color_slab2d_shard_plain(r, b, *hf, 0, R2.CHUNK_T,
                                                    prob, gm, m), 3)
            bnd = slab_bound(ins, ko, gm, 0, m, R2.CHUNK_T)
            times[key] = t["ms"]
            times[key + "_bound"] = bnd["bound_ms"]
            res = record(
                "color_slab2d", err16, t,
                f"{m}^2 halves, one t = {R2.CHUNK_T} chunk, "
                f"{'with' if key == 'f' else 'no'} f, "
                f"{R2.slab_tile(m, (m + 1) // 2, R2.CHUNK_T)[4]} threads",
                0, 0, bnd=bnd)
            if m == 4097 and key == "no_f":
                out["color_slab2d"] = res
        LYAP2D_AB["chunk_t4_ms"][m] = times
    log(f"kernel color_slab2d: bitwise against its plain version on {chunks}"
        f" chunks ({ROW16_LEVELS} squared, t = 4, 1, 3, with and without "
        f"f) and relax_halves2d bitwise the half-sweep chain over 9 sweeps "
        f"on each; max diff {err16!r}")
    del r, b, fr, fb, ko, spare, k_r, k_b, p_r, p_b, got, want

    # row 1: the dense leg, in place, on the resident levels
    err1, legs = 0.0, 0
    LYAP2D_AB["resident_500_ms"] = {}
    for m in ROW1_LEVELS:
        gm = build_geometries((m, m), prob.domain, 1)[0]
        v, f = rand((m, m)), rand((m, m))
        for ff in (f, None):
            for ns in ROW1_LEGS if m >= 65 else (1, 5, 500):
                k = RS.resident_relax(v.clone(), ff, ns, prob, gm)
                p = RS.resident_relax_plain(v.clone(), ff, ns, prob, gm)
                e = _max_err(torch, k, p)
                require(torch.equal(k, p), f"resident {ns} sweeps at {m}^2 "
                        f"({RS.layout(gm)}, with f: {ff is not None}) not "
                        f"bitwise: max diff {e!r}")
                err1, legs = max(err1, e), legs + 1
        if m < 65:
            continue
        times = {"layout": RS.layout(gm)}
        for ff in (None, f):
            key = "f" if ff is not None else "no_f"
            w = v.clone()
            t = paired_times(
                torch, lambda: RS.resident_relax(w, ff, 500, prob, gm),
                lambda: RS.resident_relax_plain(w, ff, 500, prob, gm), 1)
            # v (and f) read once, v written once; per interior point its
            # coefficients (and f a_f) once, and per sweep 2 products, 1
            # sum (+ the f term) and the blend's 2
            n_int = (m - 2) ** 2
            wf = ff is not None
            res = record("resident", err1, t,
                         f"{m}^2 on {RS.layout(gm)}, one 500-sweep leg, "
                         f"{'with' if wf else 'no'} f",
                         (3 if wf else 2) * v.nbytes,
                         (LYAP_COEF_OPS + wf + (6 if wf else 5) * 500)
                         * n_int)
            times[key] = t["ms"]
            times[key + "_plain"] = t["plain_ms"]
            times[key + "_bound"] = res["bound_ms"]
            if m == 257 and not wf:
                out["resident"] = res
        LYAP2D_AB["resident_500_ms"][m] = times
    ctas = [RS.layout(build_geometries((m, m), prob.domain, 1)[0])[2]
            for m in ROW1_LEVELS]
    log(f"kernel resident: bitwise against resident_relax_plain on {legs} "
        f"legs ({ROW1_LEVELS} squared, clusters {ctas}, with and without "
        f"f); max diff {err1!r}")
    # the barrier floor: a 500-sweep f-less leg on the smallest level
    # (9^2: 49 interior points), per sweep
    g = build_geometries((9, 9), prob.domain, 1)[0]
    w = rand((9, 9))
    ms = device_ms(torch, lambda: RS.resident_relax(w, None, 500, prob, g), 3)
    FLOORS["resident_us_per_sweep"] = ms / 500 * 1e3
    log(f"kernel resident (9^2, one 500-sweep leg, no f): {ms!r} ms, "
        f"{FLOORS['resident_us_per_sweep']!r} us per sweep (barrier floor)")
    torch.cuda.synchronize()
    return out


def phase_kernels1d(torch):
    """relax1d against its plain version on the card, bitwise, at 1,
    T - 1, T, T + 1 and 1000 sweeps (T the layout's sweeps between halo
    refreshes, `relax1d.layout`; 1000 on one warp): Ode1D on every level
    of the ode1d preset's hierarchy, 8193 down to 3 points, and at 16385
    and 65537 (the cluster's capacity: K = 8), and Poisson(1) in wrap
    storage at 8193 and 16385 (8192 and 16384 stored points).  Returns
    {"relax1d": the record of the 8193 leg}; the other legs' times
    (graph-replayed; the plain version's where it is quick) go to the log
    and RELAX1D_LEG_MS, the 3-point leg's as the per-sweep floor."""
    import numpy as np

    from pde_multigrid_tpu_torch.grid import build_geometries
    from pde_multigrid_tpu_torch.models import Ode1D, Poisson
    from pde_multigrid_tpu_torch.ops.cuda import relax1d as R1

    dev = torch.device("cuda")
    rng = np.random.default_rng(2026)
    out = {}
    nsw = 1000
    cases = [(Ode1D(), n, False) for n in (8193, 4097, 16385, 65537, 2049,
                                           1025, 513, 257, 129, 65, 33, 17,
                                           9, 5, 3)]
    cases += [(Poisson(1), n, True) for n in (8193, 16385)]
    for prob, n, wrap in cases:
        g = build_geometries((n,), prob.domain, 1, wrap=wrap)[0]
        (N,) = g.padded_shape
        lay = R1.layout(g, prob)
        v, f = (torch.tensor(rng.standard_normal(N).astype(np.float32),
                             device=dev) for _ in range(2))
        if wrap:
            v[0] = 0.0  # the wrap invariant: the zero plane
        T = lay.T or nsw
        tag = (f"{prob.name} {n} ({N} stored) on {lay.nctas} CTA(s) of "
               f"{lay.wpc} warp(s), K = {lay.K}, T = {T}")
        for ns in sorted({1, T - 1, T, T + 1, nsw} - {0}):
            k = R1.relax1d(v.clone(), f, ns, prob, g)
            p = R1.relax1d_plain(v.clone(), f, ns, prob, g)
            err = _max_err(torch, k, p)
            require(torch.equal(k, p), f"relax1d {ns} sweeps, {tag}, not "
                    f"bitwise: max diff {err!r}")
        w = v.clone()
        kern = lambda: R1.relax1d(w, f, nsw, prob, g)  # noqa: E731
        if n == 8193 and not wrap:
            t = paired_times(torch, kern,
                             lambda: R1.relax1d_plain(w, f, nsw, prob, g), 1)
            # v read and written once, f, a_e, a_f read once; per sweep and
            # interior point 2 products, 1 sum and the blend's 2 sums,
            # and f * a_f once per point
            res = {"max_abs_err": err, "ms": t["ms"],
                   "plain_ms": t["plain_ms"],
                   **bound(5 * v.nbytes, 4 * (n - 2) * nsw + N),
                   "library_ms": None}
            out["relax1d"] = res
            RELAX1D_LEG_MS[f"{prob.name} {n}"] = t["ms"]
            log(f"kernel relax1d ({tag}, one {nsw}-sweep leg): max|kernel "
                f"- plain| = {err!r}; device {t['ms']!r} ms vs plain "
                f"{t['plain_ms']!r} ms (bound {res['bound_ms']!r} ms by "
                f"{res['bound_by']}); eager call {t['eager_ms']!r} ms vs "
                f"plain {t['eager_plain_ms']!r} ms")
            continue
        ms = device_ms(torch, kern, 3)
        RELAX1D_LEG_MS[f"{prob.name} {n}"] = ms
        plain = ("" if N > 16385 else "vs plain " + repr(device_ms(
            torch, lambda: R1.relax1d_plain(w, f, nsw, prob, g), 1)) + " ms")
        log(f"kernel relax1d ({tag}, one {nsw}-sweep leg): bitwise at 1, "
            f"T - 1, T, T + 1 and {nsw} sweeps; device {ms!r} ms "
            f"({ms / nsw * 1e3!r} us per sweep) {plain}")
        if n == 3:
            FLOORS["relax1d_us_per_sweep"] = ms / nsw * 1e3
    torch.cuda.synchronize()
    return out


# ms of a 1000-sweep relax1d leg by problem and level (phase_kernels1d)
RELAX1D_LEG_MS = {}


def _counter_modules():
    from pde_multigrid_tpu_torch.ops.cuda import blocked3d as BL
    from pde_multigrid_tpu_torch.ops.cuda import defect as D
    from pde_multigrid_tpu_torch.ops.cuda import masked_block as MB
    from pde_multigrid_tpu_torch.ops.cuda import padded3d as PD
    from pde_multigrid_tpu_torch.ops.cuda import reduced2d as RD
    from pde_multigrid_tpu_torch.ops.cuda import relax as R
    from pde_multigrid_tpu_torch.ops.cuda import relax1d as R1
    from pde_multigrid_tpu_torch.ops.cuda import relax2d as R2
    from pde_multigrid_tpu_torch.ops.cuda import resident as RS
    from pde_multigrid_tpu_torch.ops.cuda import resident3d as RS3
    from pde_multigrid_tpu_torch.ops.cuda import slab2d as SL
    from pde_multigrid_tpu_torch.ops.cuda import slab3d as SB
    from pde_multigrid_tpu_torch.ops.cuda import stencilop as SO
    from pde_multigrid_tpu_torch.ops.cuda import subtree as ST
    from pde_multigrid_tpu_torch.ops.cuda import transfer as T
    from pde_multigrid_tpu_torch.ops.cuda import zebra_line as ZL

    return (R, T, D, R2, RS, R1, SL, SO, ST, MB, RS3, RD, BL, ZL, PD, SB)


def reset_counts() -> None:
    for mod in _counter_modules():
        mod.reset_launches()


def read_counts() -> dict:
    from pde_multigrid_tpu_torch.ops.cuda import relax as R
    from pde_multigrid_tpu_torch.ops.cuda import transfer as T

    out = {}
    for mod in _counter_modules():
        out.update(mod.launches)
    for name, level in TIMESKEW_LEVELS.items():
        out[name] = R.timeskew_by_level.get(level, 0)
    # rows 23 and 24: the transfer kernels' launches on the sub-lane pairs
    # (restrict alone; prolong + blend), taken out of rows 25 and 26
    for name, key, total in (("small_restrict", "restrict",
                              "residual_restrict"),
                             ("small_prolong_blend", "prolong_blend",
                              "prolong_blend")):
        out[name] = sum(T.launches_by_fine.get((key, s), 0)
                        for s in SMALL_PAIR_FINE)
        out[total] -= out[name]
    return out


def _check_solve(torch, tag, res, solver, limit, path, launches=None):
    """The shared gate of a solve: error_linf under `limit`, finite
    residual norms and solution of the level's shape, and the launches
    (`_check_counts`).  Returns the launch counts."""
    require(res.error_linf < limit, f"{tag}: error_linf {res.error_linf!r} "
            f"not under {limit!r}")
    require(
        all(map(lambda x: x == x and abs(x) != float("inf"),
                (res.residual_l2, res.residual_linf))),
        f"{tag}: non-finite residual norms",
    )
    require(tuple(res.v.shape) == solver.geoms[0].padded_shape,
            f"{tag}: solution shape {tuple(res.v.shape)}")
    require(bool(torch.isfinite(res.v).all()), f"{tag}: non-finite solution")
    return _check_counts(tag, path, launches)


def _check_counts(tag, path, launches=None):
    """Every kernel of the path launched since the counts were last set to
    0 (exactly `launches` times, when given: one count for every kernel of
    the path, or a count per kernel name), and no other kernel.  Returns
    the launch counts."""
    counts = read_counts()
    for k in PATHS[path]:
        n = counts.get(k, 0)
        want = launches.get(k) if isinstance(launches, dict) else launches
        require(n > 0 if want is None else n == want,
                f"{tag}: {n} {k} launches, the schedule implies "
                f"{'some' if want is None else want}")
    stray = [k for k in KERNELS if k not in PATHS[path] and counts.get(k, 0)]
    require(not stray, f"{tag}: other kernels launched: {stray}")
    return counts


def row_path(n: int, precision: str) -> str:
    """The PATHS entry of the 3D row at n^3 in `precision`."""
    base = "f32" if precision == "f32" else "mixed"
    return base if n == 129 else f"{base}_{n}"


def phase_main_path(torch, n: int, precision: str):
    """FMG(2,100,100) exact-coarsest solve at n^3 on the card in
    `precision`.  In f32, exactly the launches of the schedule: level l
    takes 4 (l + 1) legs of 100 sweeps (nu0 = 2 V-cycles from each of the
    l + 1 levels at or above it, two legs each), each ceil(100 / T)
    wavefront launches on the levels the plan gives the wavefront and 200
    half-sweeps on the others.  Returns (launch counts of the solve,
    summary, solution v)."""
    from pde_multigrid_tpu_torch import (
        CycleConfig,
        MultigridSolver,
        Poisson3D,
        SolverConfig,
    )
    from pde_multigrid_tpu_torch.ops.cuda import relax as R

    nus = (2, 100, 100)
    cfg = SolverConfig(
        cycle=CycleConfig("fmg", *nus, coarsest="exact"),
        precision=precision,
    )
    solver = MultigridSolver(Poisson3D(), n, cfg, device="cuda")
    levels = solver.fresh_levels()
    torch.cuda.synchronize()
    reset_counts()
    res = solver.solve(levels)
    counts = read_counts()
    by_level = dict(R.timeskew_by_level)
    h = solver.geoms[0].spacing[0]
    tag = f"main path {n}^3 {precision}"
    log(f"{tag}: levels {[g.padded_shape for g in solver.geoms]}, "
        f"error_linf {res.error_linf!r} (limit 50 h^2 = {50 * h * h!r}), "
        f"residual_l2 {res.residual_l2!r}, residual_linf "
        f"{res.residual_linf!r}, launches {counts}, wavefront launches by "
        f"level {by_level}")
    _check_solve(torch, tag, res, solver, 50 * h * h, row_path(n, precision))
    if precision == "mixed":
        # row 10 a step: level l relaxes 2 nu0 (l + 1) legs, each one
        # launch of the whole-leg kernel or ceil(nu / T) of the wavefront's
        # error mode, as the plan's form gives it
        kern = solver.program.kernels
        want = {"error_leg": 0, "error_timeskew": 0, "error_sweep": 0}
        name = {"leg": "error_leg", "wavefront": "error_timeskew",
                "chain": "error_sweep"}
        for l, d in enumerate(kern._defect):
            if d is not None and kern._relax[l] is not None:
                want[name[d.form]] += 2 * nus[0] * (l + 1) * d.launches(
                    nus[1])
        got = {k: counts.get(k, 0) for k in want}
        log(f"{tag}: row 10 launches a step {got} (total "
            f"{sum(got.values())}), the plan's {want}; forms by level "
            f"{[d.form if d else None for d in kern._defect]}")
        require(got == want, f"{tag}: row 10 launches {got}, the schedule "
                f"implies {want}")
    if precision == "f32":
        legs = [2 * nus[0] * (l + 1) for l in range(len(solver.geoms) - 1)]
        plan = [R.timeskew_plan(g) for g in solver.geoms[:len(legs)]]
        want = {(g.padded_shape[0], g.padded_shape[1] // 2,
                 g.padded_shape[2]): k * -(-nus[1] // R.TIMESKEW_T)
                for g, k, w in zip(solver.geoms, legs, plan) if w}
        half = sum(k * 2 * nus[1] for k, w in zip(legs, plan) if not w)
        require(by_level == want and counts["half_sweep"] == half
                and sum(want.values()) == R.launches["timeskew"],
                f"{tag}: wavefront launches {by_level} and {counts['half_sweep']}"
                f" half-sweeps; the schedule implies {want} and {half}")

    summary = {"n": n, "precision": precision,
               "levels": [g.padded_shape for g in solver.geoms],
               "error_linf": res.error_linf,
               "residual_l2": res.residual_l2}
    if precision == "mixed":
        summary["row10_launches"] = got
    summary.update(time_step(torch, tag, solver, levels, 5, 2))
    return counts, summary, res.v


def time_step(torch, tag, solver, levels, reps, graph_reps):
    """ms per solve step and DOF-updates/s, eager (`reps` steps between
    CUDA events) and replayed as one CUDA graph of `graph_reps` steps, the
    updates counted from the solver's cycle.  A failed capture fails the
    run: the graph numbers are the device times PERF.md compares."""
    from pde_multigrid_tpu_torch.utils.updates import count_smoother_updates

    step = lambda: solver.program.solve_step(levels)  # noqa: E731
    step_ms = time_ms(torch, step, reps)
    graph_ms = device_ms(torch, step, graph_reps)
    torch.cuda.synchronize()
    shapes = [g.shape for g in solver.geoms]
    cyc = solver.config.cycle
    updates = count_smoother_updates(shapes, cyc.kind, cyc.nu0, cyc.nu1,
                                     cyc.nu2, cyc.mu, cyc.coarsest)
    rate = updates / (step_ms / 1000.0)
    graph_rate = updates / (graph_ms / 1000.0)
    log(f"{tag}: {step_ms!r} ms/step eager over {reps} solve steps (CUDA "
        f"events), {graph_ms!r} ms/step replayed as one CUDA graph; "
        f"{updates} smoother updates/step, {rate!r} DOF-updates/s eager, "
        f"{graph_rate!r} graph")
    return {"ms_per_step": step_ms, "graph_ms_per_step": graph_ms,
            "dof_updates_per_s": rate, "graph_dof_updates_per_s": graph_rate,
            "updates_per_step": updates}


LYAP_N = 4097
LYAP_NUS = (2, 500, 500)


def lyapunov_launches(solver) -> dict:
    """The relax launches of one FMG step of the unsharded 2D Lyapunov
    plan: level l takes 2 nu0 (l + 1) legs (`reduced_launches`), each
    ceil(nu / CHUNK_T) chunks of row 16 on a split level and one launch
    of row 1 on the others."""
    from pde_multigrid_tpu_torch.ops.cuda.relax2d import CHUNK_T

    kern = solver.program.kernels
    cyc = solver.config.cycle
    want = {"color_slab2d_shard": 0, "resident": 0}
    for l, fn in enumerate(kern._relax):
        if fn is None:
            continue
        cycles = cyc.nu0 * (l + 1)  # one nu1 leg and one nu2 leg each
        if kern._split[l]:
            want["color_slab2d_shard"] += cycles * (
                -(-cyc.nu1 // CHUNK_T) - (-cyc.nu2 // CHUNK_T))
        else:
            want["resident"] += 2 * cycles
    return want


def phase_lyapunov(torch):
    """The 2D Lyapunov path: 4097^2, FMG(2, 500, 500) with the exact
    (dense inverse) coarsest level, precision="mixed" (the bench's
    default; no defect plan covers a 2D level, so it relaxes in f32),
    through `MultigridSolver.solve()` on "cuda".  error_linf below the
    bench's gate max(10 h, 5e-5) for this one-sided first-order scheme,
    finite residuals, exactly the schedule's relax launches
    (`lyapunov_launches`: row 16's chunks on 4097^2 ... 513^2, row 1's
    legs on 257^2 ... 65^2), split2d and merge2d launched, nothing else of
    the CUDA tier (no half-sweep kernel is built), and the persistent
    halves within their conversion budget; the solution's SHA-256
    printed.  Returns (launch counts, summary, solution v)."""
    from pde_multigrid_tpu_torch import (
        CycleConfig,
        Lyapunov2D,
        MultigridSolver,
        SolverConfig,
    )

    cfg = SolverConfig(cycle=CycleConfig("fmg", *LYAP_NUS, coarsest="exact"),
                       precision="mixed")
    solver = MultigridSolver(Lyapunov2D(), LYAP_N, cfg, device="cuda")
    kern = solver.program.kernels
    levels = solver.fresh_levels()
    torch.cuda.synchronize()
    reset_counts()
    res = solver.solve(levels)  # the solver's first: conversions start at 0
    counts = read_counts()
    conv = dict(kern.conversions)
    h = solver.geoms[0].spacing[0]
    limit = max(10 * h, 5e-5)
    tag = f"lyapunov {LYAP_N}^2 mixed"
    log(f"{tag}: levels {[g.padded_shape for g in solver.geoms]}, split "
        f"levels {[l for l, s_ in enumerate(kern._split) if s_]}, "
        f"error_linf {res.error_linf!r} (limit max(10 h, 5e-5) = "
        f"{limit!r}), residual_l2 {res.residual_l2!r}, residual_linf "
        f"{res.residual_linf!r}, launches {counts}, conversions {conv}")
    want = lyapunov_launches(solver)
    _check_solve(torch, tag, res, solver, limit, "lyapunov", want)
    require("half_sweep2d" not in counts,
            f"{tag}: a half_sweep2d counter: the kernel is still built")
    sha = hashlib.sha256(res.v.cpu().numpy().tobytes()).hexdigest()
    log(f"{tag}: relax launches {want} as the schedule implies; solution "
        f"SHA-256 {sha}")
    # the budget: per visit of a split level (nu0 (l + 1) of them, nu0 l
    # as a coarse level with an RHS) at most one split of v, one of f and
    # one merge, plus the final solution's merge
    nu0 = LYAP_NUS[0]
    split = [l for l, s_ in enumerate(kern._split) if s_]
    visits = sum(nu0 * (l + 1) for l in split)
    budget = {"split_v": visits, "split_f": sum(nu0 * l for l in split),
              "merge": visits + 1}
    log(f"{tag}: conversions {conv} against the budget {budget}; split2d "
        f"launches {counts['split2d']}, merge2d {counts['merge2d']}")
    require(all(conv[k] <= budget[k] for k in budget),
            f"{tag}: conversions {conv} over the budget {budget}")
    require(counts["split2d"] == conv["split_v"] + conv["split_f"]
            and counts["merge2d"] == conv["merge"],
            f"{tag}: conversion launches do not match the plan's count")
    summary = {"n": LYAP_N, "problem": "lyapunov2d", "precision": "mixed",
               "levels": [g.padded_shape for g in solver.geoms],
               "error_linf": res.error_linf,
               "residual_l2": res.residual_l2, "conversions": conv,
               "launches_per_step": want, "sha256": sha}
    v = res.v.clone()
    summary.update(time_step(torch, tag, solver, levels, 2, 1))
    busy = busy_split_ms(
        torch, lambda: solver.program.solve_step(levels),
        {"chunk": "color_slab2d_kernel<false",
         "resident": "color_slab2d_kernel<true, true",
         "split2d": "split2d_kernel", "merge2d": "merge2d_kernel"})
    summary["busy_ms"] = busy
    # the relax kernels' device ms per step by level: level l's 2 nu0
    # f-less legs (the V-cycles rooted at l) and 2 nu0 l legs with f, each
    # ceil(nu / CHUNK_T) t = 4 chunks or one 500-sweep leg, at
    # phase_kernels2d's times (a remainder chunk would count as a whole)
    from pde_multigrid_tpu_torch.ops.cuda.relax2d import CHUNK_T

    nu0 = LYAP_NUS[0]
    by_level = {}
    for l, g in enumerate(solver.geoms):
        m = g.shape[0]
        chunk = LYAP2D_AB.get("chunk_t4_ms", {}).get(m)
        leg = LYAP2D_AB.get("resident_500_ms", {}).get(m)
        per, times = ((-(-LYAP_NUS[1] // CHUNK_T), chunk) if chunk
                      else (1, leg))
        if times:
            by_level[m] = per * 2 * nu0 * (times["no_f"] + l * times["f"])
    summary["relax_ms_per_step_by_level"] = by_level
    log(f"{tag}: device busy ms per step by kernel (profiler) {busy!r}; "
        f"relax device ms per step by level {by_level!r} (sum "
        f"{sum(by_level.values())!r})")
    return counts, summary, v


# the reduced-system kernel (row 18) against its plain version and row
# 16's chain; the blocked 3D kernel (row 19) against row 9's chain (ms,
# printed with the summaries)
REDUCED_AB = {}
BLOCKED_AB = {}
# JAX's test tolerance of the reduced kernel against dense red-black
# sweeps (tests/test_pallas.py:791-815): the precomputed coefficient
# products reassociate the arithmetic
REDUCED_RTOL, REDUCED_ATOL = 2e-5, 2e-6


def phase_kernels_reduced2d(torch):
    """The reduced-system kernel (csrc/reduced2d.cu) bitwise against its
    plain version on random halves of 33^2, 65^2 and 513^2 at T = 16 and 5
    (tiles past the level), then at 4097^2 and 2049^2,
    on halves of random dense levels: chunks of T = 8 (the path's T at both
    levels), 1 and 3 (a remainder), each with and without f, bitwise
    against its plain version and within JAX's test tolerance of row 16
    (`relax_halves2d`: its one-rank chunks, bitwise the half-sweep chain)
    over the same sweeps; at 4097^2 row 16's two f-less chunks of 4 sweeps
    timed.  Then on every level the 4097^2 plan reduces (4097^2 ... 513^2)
    chunks of its T and of the legs' remainder 500 % T, with and without
    f, bitwise its plain version and each timed (the f-less T chunk beside
    its plain version: `REDUCED_AB["chunk_ms_by_level"]`), and on 129^2 T
    = 1, 7, 8, 9, 15, 16 (around both T of the plan) with and without f.
    Returns {"reduced2d": the 4097^2 f-less T = 8 chunk's record}."""
    import numpy as np

    from pde_multigrid_tpu_torch.grid import build_geometries
    from pde_multigrid_tpu_torch.models import Lyapunov2D
    from pde_multigrid_tpu_torch.ops.cuda import reduced2d as RD
    from pde_multigrid_tpu_torch.ops.cuda import relax2d as R2

    dev = torch.device("cuda")
    prob = Lyapunov2D()
    rng = np.random.default_rng(2031)
    out = {}
    small = (33, 65, 513)
    for n in small:  # tiles past the level's rows and slots, T = 16 and 5
        g = build_geometries((n, n), prob.domain, 1)[0]
        r, b, fr, fb = (torch.tensor(rng.standard_normal(
            (n, (n + 1) // 2)).astype(np.float32), device=dev)
            for _ in range(4))
        ko = (torch.empty_like(r), torch.empty_like(b))
        for T in (16, 5):
            for hf in ((fr, fb), (None, None)):
                RD.reduced_chunk(r, b, *hf, T, prob, g, ko)
                p = RD.reduced_slab2d_plain(r, b, *hf, T, prob, g)
                require(all(map(torch.equal, ko, p)),
                        f"reduced2d {n}^2 T={T} with f: {hf[0] is not None}"
                        " not bitwise")
    log(f"kernel reduced2d ({small} squared, random halves, T = 16, 5, with "
        "and without f): bitwise against its plain version")
    for n in (4097, 2049):
        g = build_geometries((n, n), prob.domain, 1)[0]
        require(RD.chunk_sweeps(g) == 8, f"{n}^2: JAX's ladder gives T = "
                f"{RD.chunk_sweeps(g)}, not 8")
        v, f = (torch.tensor(rng.standard_normal((n, n)).astype(np.float32),
                             device=dev) for _ in range(2))
        r, b = R2.to_halves(v)
        fr, fb = R2.to_halves(f)
        ko = (torch.empty_like(r), torch.empty_like(b))
        errs, rels = [], []
        for T in (8, 1, 3):
            for hf in ((fr, fb), (None, None)):
                RD.reduced_chunk(r, b, *hf, T, prob, g, ko)
                p = RD.reduced_slab2d_plain(r, b, *hf, T, prob, g)
                err = max(_max_err(torch, a, c) for a, c in zip(ko, p))
                require(all(map(torch.equal, ko, p)),
                        f"reduced2d {n}^2 T={T} with f: {hf[0] is not None}"
                        f" not bitwise: max diff {err!r}")
                cr, cb = r.clone(), b.clone()
                cr, cb = R2.relax_halves2d(cr, cb, *hf, T, prob, g)
                for a, c in zip(ko, (cr, cb)):
                    excess = torch.abs(a - c) - (
                        REDUCED_ATOL + REDUCED_RTOL * torch.abs(c))
                    rels.append(float(torch.max(excess)))
                errs.append(err)
        require(max(rels) <= 0.0, f"reduced2d {n}^2: outside rtol "
                f"{REDUCED_RTOL} / atol {REDUCED_ATOL} of row 16 "
                f"(max excess {max(rels)!r})")
        log(f"kernel reduced2d ({n}^2, chunks of T = 8, 1, 3, with and "
            f"without f): bitwise against its plain version; within rtol "
            f"{REDUCED_RTOL} / atol {REDUCED_ATOL} of row 16's chunks "
            f"(largest |diff| - tol: {max(rels)!r})")
        if n != 4097:
            continue
        err_4097 = max(errs)
        # row 16 over the same 8 sweeps: its form on the path, two f-less
        # one-rank chunks of 4 between two pairs of halves
        cr, cb = r.clone(), b.clone()
        spare = (torch.empty_like(r), torch.empty_like(b))
        chain = device_ms(
            torch, lambda: R2.relax_halves2d(cr, cb, None, None, 8, prob, g,
                                             spare=spare), 3)
        REDUCED_AB.update(row16_8_sweeps_ms=chain)
        log(f"kernel reduced2d ({n}^2): row 16's two f-less chunks of 4 "
            f"sweeps (its form on the path, relax_halves2d) {chain!r} ms")
    del v, f, r, b, fr, fb, ko, cr, cb, spare
    # every level the 4097^2 plan reduces, at its T and at the legs'
    # remainder (500 % T), with and without f: bitwise its plain version,
    # each chunk timed (f-less at T beside its plain version)
    by_level = {}
    for g in build_geometries((LYAP_N, LYAP_N), prob.domain, 4):
        n, T = g.shape[0], RD.chunk_sweeps(g)
        rem = LYAP_NUS[1] % T
        r, b, fr, fb = (torch.tensor(rng.standard_normal(
            (n, (n + 1) // 2)).astype(np.float32), device=dev)
            for _ in range(4))
        ko = (torch.empty_like(r), torch.empty_like(b))
        times = {"T": T, "rem": rem, "layout": RD.layout(*r.shape,
                                                          T).as_dict()}
        for t_, tag in ((T, ""), (rem, "rem_")):
            for hf, fk in (((fr, fb), "f"), ((None, None), "no_f")):
                RD.reduced_chunk(r, b, *hf, t_, prob, g, ko)
                p = RD.reduced_slab2d_plain(r, b, *hf, t_, prob, g)
                require(all(map(torch.equal, ko, p)),
                        f"reduced2d {n}^2 T={t_} with f: {fk == 'f'} not "
                        "bitwise its plain version")
                if (t_, fk) == (T, "no_f"):
                    pt = paired_times(
                        torch, lambda: RD.reduced_chunk(r, b, None, None, T,
                                                        prob, g, ko),
                        lambda: RD.reduced_slab2d_plain(r, b, None, None, T,
                                                        prob, g), 3)
                    times.update(no_f=pt["ms"], plain_ms=pt["plain_ms"],
                                 eager_ms=pt["eager_ms"],
                                 eager_plain_ms=pt["eager_plain_ms"])
                else:
                    times[tag + fk] = device_ms(
                        torch, lambda t_=t_, hf=hf: RD.reduced_chunk(
                            r, b, *hf, t_, prob, g, ko), 5)
        by_level[n] = times
        log(f"kernel reduced2d ({n}^2, chunks of T = {T} and {rem}, with "
            f"and without f): bitwise its plain version; device ms {times!r}")
        if n == LYAP_N:
            # r and b read once and written once (f-less); per interior
            # black point and sweep 3 products, 3 sums and the mask fold
            # (8), per interior black point and chunk about 80 for its
            # fields and its red neighbour's rebuild (three coefficient
            # evaluations, one division each)
            out["reduced2d"] = {"max_abs_err": err_4097,
                                "ms": times["no_f"],
                                "plain_ms": times["plain_ms"],
                                **bound(4 * r.nbytes,
                                        (8 * T + 80) * (n - 2) ** 2 / 2),
                                "library_ms": None}
            REDUCED_AB.update(chunk_t8_ms=times["no_f"],
                              plain_ms=times["plain_ms"])
            log(f"kernel reduced2d ({n}^2, one f-less T = {T} chunk): "
                f"device {times['no_f']!r} ms vs plain "
                f"{times['plain_ms']!r} ms (bound "
                f"{out['reduced2d']['bound_ms']!r} ms by "
                f"{out['reduced2d']['bound_by']}); eager "
                f"{times['eager_ms']!r} ms vs plain "
                f"{times['eager_plain_ms']!r} ms")
        del r, b, fr, fb, ko
    REDUCED_AB["chunk_ms_by_level"] = by_level
    # a small level in the plan's layouts (several tiles, the last row and
    # column of them partial) around both T of the plan
    g = build_geometries((129, 129), prob.domain, 1)[0]
    r, b, fr, fb = (torch.tensor(rng.standard_normal((129, 65)).astype(
        np.float32), device=dev) for _ in range(4))
    ko = (torch.empty_like(r), torch.empty_like(b))
    ts = (1, 7, 8, 9, 15, 16)
    for T in ts:
        for hf in ((fr, fb), (None, None)):
            RD.reduced_chunk(r, b, *hf, T, prob, g, ko)
            p = RD.reduced_slab2d_plain(r, b, *hf, T, prob, g)
            require(all(map(torch.equal, ko, p)),
                    f"reduced2d 129^2 T={T} with f: {hf[0] is not None} not "
                    "bitwise its plain version")
    log(f"kernel reduced2d (129^2, T = {ts}, with and without f): bitwise "
        "its plain version")
    torch.cuda.synchronize()
    return out


def phase_kernels_blocked3d(torch):
    """The blocked 3D kernel (csrc/blocked3d.cu) against row 9's
    half-sweep chain (csrc/relax.cu), bitwise: on small and odd-tiled wrap
    levels (halves (8, 4, 8), (10, 6, 14), (48, 40, 72), 64^3) over
    nu = 5 at T = 1-4 (partial tiles, tiles holding a point twice, a
    remainder launch); at 256^3 a 100-sweep leg at T = 1-4, also
    bitwise its plain version; at 512^3 a 100-sweep leg at T = 1 (the
    plain version on a 4-sweep leg).  Timed: one T = 1 launch at 256^3
    and at 512^3 beside its plain version, and the 100-sweep legs on
    halves at 256^3 and 512^3 beside row 9's chain and the wavefront's.
    Returns {"blocked3d": the 256^3 launch's record}."""
    import numpy as np

    from pde_multigrid_tpu_torch.grid import build_geometries
    from pde_multigrid_tpu_torch.models import Poisson3D
    from pde_multigrid_tpu_torch.ops.cuda import blocked3d as BL
    from pde_multigrid_tpu_torch.ops.cuda import relax as R

    dev = torch.device("cuda")
    prob = Poisson3D()
    rng = np.random.default_rng(2033)
    out = {}

    def halves(g):
        X, Y, Z = g.padded_shape
        return [torch.tensor(rng.standard_normal((X, Y // 2, Z)).astype(
            np.float32), device=dev) for _ in range(4)]

    def check(g, hv, ns, T, plain=True):
        k = BL.blocked_relax_halves(*hv, ns, prob, g, T=T)
        c = [a.clone() for a in hv[:2]]
        R.relax_halves(*c, *hv[2:], ns, prob, g)
        err = max(_max_err(torch, a, e) for a, e in zip(k, c))
        require(all(map(torch.equal, k, c)),
                f"blocked3d {tuple(hv[0].shape)} nu={ns} T={T} not bitwise "
                f"row 9's chain: max diff {err!r}")
        if plain:
            p = [a.clone() for a in hv[:2]]
            for s in range(0, ns, T):
                p = BL.blocked_slab3d_plain(*p, *hv[2:], min(T, ns - s),
                                            prob, g)
            require(all(map(torch.equal, k, p)),
                    f"blocked3d {tuple(hv[0].shape)} nu={ns} T={T} not "
                    "bitwise its plain version")
        return err

    small = ((9, 9, 9), (11, 13, 15), (49, 81, 73), (65, 65, 65))
    for shape in small:
        g = build_geometries(shape, prob.domain, 1, wrap=True)[0]
        hv = halves(g)
        for T in (1, 2, 3, 4):
            check(g, hv, 5, T)
    log(f"kernel blocked3d: bitwise against row 9's chain and its plain "
        f"version at nu = 5, T = 1-4, on the halves levels "
        f"{[(s[0] - 1, (s[1] - 1) // 2, s[2] - 1) for s in small]}")
    nsw = 100
    for n in (257, 513):
        g = build_geometries((n,) * 3, prob.domain, 1, wrap=True)[0]
        require(BL.use_blocked(g), f"{n - 1}^3: not a row-19 level")
        hv = halves(g)
        ts = (1, 2, 3, 4) if n == 257 else (1,)
        err = max(check(g, hv, nsw, T, plain=n == 257) for T in ts)
        if n == 513:
            err = max(err, check(g, hv, 4, 1))
        legs = {f"blocked_T{T}": device_ms(
            torch, lambda T=T: BL.blocked_relax_halves(*hv, nsw, prob, g,
                                                       T=T), 1) for T in ts}
        c = [a.clone() for a in hv[:2]]
        legs["half_sweeps"] = device_ms(
            torch, lambda: R.relax_halves(*c, *hv[2:], nsw, prob, g), 1)
        legs["wavefront"] = device_ms(
            torch, lambda: R.timeskew_relax_halves(hv[1], *hv[2:], nsw, prob,
                                                   g), 1)
        BLOCKED_AB[f"{n - 1}^3"] = legs
        log(f"kernel blocked3d ({n - 1}^3): bitwise row 9's chain over "
            f"{nsw} sweeps at T = {ts}; {nsw}-sweep leg on halves, device "
            f"ms: {legs!r}")
        # one T = 1 launch (the path's) beside its plain version
        ko = (torch.empty_like(hv[0]), torch.empty_like(hv[1]))
        t = paired_times(
            torch, lambda: BL.blocked_chunk(*hv, 1, prob, g, ko),
            lambda: BL.blocked_slab3d_plain(*hv, 1, prob, g),
            10 if n == 257 else 2)
        BLOCKED_AB[f"{n - 1}^3 launch"] = {
            **t, "layout": BL.layout(*hv[0].shape, 1).as_dict()}
        # r, b, fr and fb read once, r and b written once; 13 operations
        # an updated point
        rec = {"max_abs_err": err, "ms": t["ms"], "plain_ms": t["plain_ms"],
               **bound(6 * hv[0].nbytes,
                       13 * updated_points(g.padded_shape)),
               "library_ms": None}
        log(f"kernel blocked3d ({n - 1}^3, one T = 1 launch): device "
            f"{t['ms']!r} ms vs plain {t['plain_ms']!r} ms (bound "
            f"{rec['bound_ms']!r} ms by {rec['bound_by']}); eager "
            f"{t['eager_ms']!r} ms vs plain {t['eager_plain_ms']!r} ms")
        if n == 257:
            out["blocked3d"] = rec
        del hv, c, ko
    torch.cuda.synchronize()
    return out



def reduced_launches(solver) -> dict:
    """The launches of one FMG step with the reduced opt-in on, for the
    kernels of the reduced levels: FMG(nu0, nu1, nu2) with the exact
    coarsest level gives level l 2 nu0 (l + 1) legs (nu0 V-cycles from each
    of the l + 1 levels at or above it, two legs each), of which the 2 nu0
    of the V-cycles rooted at l read the cascaded zero RHS (f-less: no
    split of f).  Each leg splits v (and f), runs nu // T chunks of T and
    one of nu % T, and merges."""
    kern = solver.program.kernels
    cyc = solver.config.cycle
    want = {"reduced2d": 0, "split2d": 0, "merge2d": 0}
    for l, T in enumerate(kern._reduced_t):
        if T is None:
            continue
        cycles = cyc.nu0 * (l + 1)  # one nu1 leg and one nu2 leg each
        want["reduced2d"] += cycles * (-(-cyc.nu1 // T) - (-cyc.nu2 // T))
        want["split2d"] += 2 * cycles + 2 * cyc.nu0 * l
        want["merge2d"] += 2 * cycles
    return want


def phase_lyapunov_reduced(torch, sly, vly, counts_ly):
    """The 2D Lyapunov path of phase 6 with the reduced-system opt-in on
    (dispatch.SPLIT2D_REDUCED, JAX's PDE_MG_SPLIT2D_REDUCED=1; restored
    after): 4097^2 FMG(2, 500, 500), exact coarsest level, mixed.  The
    bench's gate, error_linf within 1 % of phase 6's solve (`sly`, `vly`:
    the same schedule on row 16), max|v - v_row16| under 10 % of that
    error (the chunk reassociates: tolerance-level, not bitwise), finite
    residuals; exactly the schedule's launches: row 18 on 4097^2 ... 513^2
    (T = 8, 8, 16, 16: JAX's ladder), split2d / merge2d per leg, the
    resident kernel below as in phase 6 (`counts_ly`), no half-sweep;
    then ms per step eager and as one CUDA graph, the profiler's busy ms
    a step by kernel, and the relax kernels' device ms a step by level
    (the chunk times of phase kernels_reduced2d, row 1's legs of phase
    kernels2d)."""
    from pde_multigrid_tpu_torch import (
        CycleConfig,
        Lyapunov2D,
        MultigridSolver,
        SolverConfig,
    )
    from pde_multigrid_tpu_torch.ops.cuda import dispatch

    tag = f"lyapunov {LYAP_N}^2 mixed, reduced"
    saved = dispatch.SPLIT2D_REDUCED
    try:
        dispatch.SPLIT2D_REDUCED = True
        cfg = SolverConfig(
            cycle=CycleConfig("fmg", *LYAP_NUS, coarsest="exact"),
            precision="mixed")
        solver = MultigridSolver(Lyapunov2D(), LYAP_N, cfg, device="cuda")
    finally:
        dispatch.SPLIT2D_REDUCED = saved
    kern = solver.program.kernels
    require(kern._reduced_t[:5] == [8, 8, 16, 16, None]
            and not any(kern._split),
            f"{tag}: reduced levels {kern._reduced_t}, split {kern._split}")
    levels = solver.fresh_levels()
    torch.cuda.synchronize()
    reset_counts()
    res = solver.solve(levels)
    counts = read_counts()
    h = solver.geoms[0].spacing[0]
    limit = max(10 * h, 5e-5)
    want = {**reduced_launches(solver), "resident": counts_ly["resident"]}
    dv = float(torch.max(torch.abs(res.v - vly)))
    gap = res.error_linf - sly["error_linf"]
    log(f"{tag}: T per level {kern._reduced_t}, error_linf "
        f"{res.error_linf!r} (limit {limit!r}; row 16's {sly['error_linf']!r}"
        f", gap {gap!r} = {100 * gap / sly['error_linf']!r} %), max|v - "
        f"v_row16| = {dv!r}, residual_l2 {res.residual_l2!r}, launches "
        f"{counts} (the schedule: {want})")
    _check_solve(torch, tag, res, solver, limit, "lyapunov_reduced", want)
    require(abs(gap) <= 0.01 * sly["error_linf"],
            f"{tag}: error_linf not within 1 % of row 16's solve")
    require(dv <= 0.1 * sly["error_linf"],
            f"{tag}: max|v - v_row16| {dv!r} not under 10 % of its error")
    summary = {"n": LYAP_N, "problem": "lyapunov2d", "precision": "mixed",
               "reduced": True, "chunk_t": kern._reduced_t,
               "error_linf": res.error_linf, "residual_l2": res.residual_l2,
               "max_abs_dv_vs_row16": dv,
               "launches_per_step": {k: counts[k] for k in want}}
    summary.update(time_step(torch, tag, solver, levels, 2, 1))
    summary["busy_ms"] = busy_split_ms(
        torch, lambda: solver.program.solve_step(levels),
        {"reduced2d": "reduced2d_kernel",
         "resident": "color_slab2d_kernel<true, true",
         "split2d": "split2d_kernel", "merge2d": "merge2d_kernel"})
    # the relax kernels' device ms per step by level: level l's 2 nu0
    # f-less legs and 2 nu0 l legs with f, each nu // T chunks of T and one
    # of nu % T on the reduced levels (phase kernels_reduced2d's times),
    # one 500-sweep leg of row 1 below (phase kernels2d's)
    nu0, nu = LYAP_NUS[0], LYAP_NUS[1]
    by_level = {}
    for l, g in enumerate(solver.geoms):
        m = g.shape[0]
        red = REDUCED_AB.get("chunk_ms_by_level", {}).get(m)
        leg = LYAP2D_AB.get("resident_500_ms", {}).get(m)
        if red:
            full = nu // red["T"]
            legs = {fk: full * red[fk] + (red["rem_" + fk] if red["rem"]
                                          else 0.0)
                    for fk in ("no_f", "f")}
        elif leg:
            legs = leg
        else:
            continue
        by_level[m] = 2 * nu0 * (legs["no_f"] + l * legs["f"])
    summary["relax_ms_per_step_by_level"] = by_level
    log(f"{tag}: device busy ms per step by kernel (profiler) "
        f"{summary['busy_ms']!r}; relax device ms per step by level "
        f"{by_level!r} (sum {sum(by_level.values())!r})")
    return counts, summary


def phase_lyapunov_presets(torch):
    """The thesis' two 2D Lyapunov presets through the CLI in process on
    "cuda", relaxed to 3^2 (the CLI's default coarsest): `--preset
    lyapunov2d` (1025^2 on [0, 1]^2, FMG(1, 500, 500): 1025^2 and 513^2
    split levels in row 16's chunks, row 1 on 257^2 ... 3^2) and `--preset
    lyapunov2d-cuda` (65^2 on [0, 20]^2, FMG(2, 500, 500): row 1 on every
    level).  Each: finite residuals, the kernels of its plan launched and
    no other, the plan's levels, and the float64 solve of the same
    schedule (`phase_f64_reference`: error_linf within 1 %, the solution
    within 10 % of that error); on the unit square also error_linf <
    max(10 h, 5e-5), the bench's gate (on [0, 20]^2 at h = 0.3125 the
    scheme's own error is ~10.4, as JAX's jnp tier gives it); ms per step
    eager and as one CUDA graph (an equal solver's).  Returns the
    summaries."""
    from pde_multigrid_tpu_torch import (
        CycleConfig,
        MultigridSolver,
        SolverConfig,
    )
    from pde_multigrid_tpu_torch.__main__ import PRESETS, build_problem
    from pde_multigrid_tpu_torch.__main__ import main as cli_main

    out, counts_by = [], {}
    for name, path, split in (("lyapunov2d", "preset_lyap1025", 2),
                              ("lyapunov2d-cuda", "preset_lyap65", 0)):
        pre = PRESETS[name]
        problem = build_problem("lyapunov2d", pre.get("domain"))
        cfg = SolverConfig(cycle=CycleConfig(
            "fmg", pre["nu0"], pre["nu1"], pre["nu2"], coarsest="relax"))
        solver = MultigridSolver(problem, pre["n"], cfg, device="cuda")
        kern = solver.program.kernels
        resident = [fn == kern._relax_resident for fn in kern._relax]
        require(kern._split == [True] * split + [False] * (
            len(solver.geoms) - split) and all(
            resident[split:]) and solver.geoms[-1].shape == (3, 3),
            f"preset {name}: split levels {kern._split}, resident "
            f"{resident}, levels {[g.shape for g in solver.geoms]}")
        buf, err = io.StringIO(), io.StringIO()
        torch.cuda.synchronize()
        reset_counts()
        with contextlib.redirect_stdout(buf), \
                contextlib.redirect_stderr(err):
            res = cli_main(["--preset", name, "--device", "cuda"])
        counts = read_counts()
        js = json.loads(buf.getvalue().strip().splitlines()[-1])
        h = solver.geoms[0].spacing[0]
        unit = pre.get("domain") is None
        limit = max(10 * h, 5e-5) if unit else float("inf")
        tag = f"preset {name} ({pre['n']}^2)"
        log(f"{tag}: levels {[g.shape for g in solver.geoms]}, error_linf "
            f"{js['error_linf']!r} (limit {limit!r}), residual_l2 "
            f"{js['residual_l2']!r}, launches {counts}; "
            f"{err.getvalue().strip().splitlines()[-1]}")
        counts_by[path] = _check_solve(torch, tag, res, solver, limit, path)
        summary = {"preset": name, "n": pre["n"],
                   "levels": [g.padded_shape for g in solver.geoms],
                   "error_linf": js["error_linf"],
                   "residual_l2": js["residual_l2"],
                   "launches": {k: counts[k] for k in PATHS[path]}}
        phase_f64_reference(torch, problem, pre["n"],
                            (pre["nu0"], pre["nu1"], pre["nu2"]), summary,
                            res.v, tag, cycle_kw={"coarsest": "relax"})
        summary.update(time_step(torch, tag, solver, solver.fresh_levels(),
                                 2, 1))
        out.append(summary)
        del solver, res
    return counts_by, out


def phase_f32_257_blocked(torch, s32, v32):
    """257^3 f32 FMG(2, 100, 100), exact coarsest (fastdiag 64^3), with the
    wavefront off (PDE_MG_TIMESKEW=0, restored after): 256^3 relaxed by row
    19 (csrc/blocked3d.cu, T = 1), 128^3 by the half-sweeps.  error_linf
    < 50 h^2, finite residuals, exactly the schedule's launches (4 legs of
    100 launches on 256^3, 8 of 200 half-sweeps on 128^3) and no wavefront;
    against phase 5's wavefront solve (`s32`, `v32`): bitwise if it is,
    else max|dv| reported and error_linf within 1 %; ms per step eager and
    as one CUDA graph."""
    from pde_multigrid_tpu_torch import (
        CycleConfig,
        MultigridSolver,
        Poisson3D,
        SolverConfig,
    )
    from pde_multigrid_tpu_torch.ops.cuda import blocked3d as BL

    n, nus = 257, (2, 100, 100)
    tag = f"f32 {n}^3, wavefront off"
    saved = os.environ.get("PDE_MG_TIMESKEW")
    os.environ["PDE_MG_TIMESKEW"] = "0"
    try:
        cfg = SolverConfig(cycle=CycleConfig("fmg", *nus, coarsest="exact"),
                           precision="f32")
        solver = MultigridSolver(Poisson3D(), n, cfg, device="cuda")
        kern = solver.program.kernels
        require(kern.tiers[:2] == ["blocked3d", "half_sweep"],
                f"{tag}: plan {kern.tiers}")
        levels = solver.fresh_levels()
        torch.cuda.synchronize()
        reset_counts()
        res = solver.solve(levels)
        counts = read_counts()
        h = solver.geoms[0].spacing[0]
        want = {"blocked3d": 4 * -(-nus[1] // BL.BLOCKED_T),
                "half_sweep": 8 * 2 * nus[1]}
        dv = float(torch.max(torch.abs(res.v - v32)))
        gap = res.error_linf - s32["error_linf"]
        log(f"{tag}: plan {kern.tiers}, error_linf {res.error_linf!r} "
            f"(limit {50 * h * h!r}; the wavefront's {s32['error_linf']!r}, "
            f"gap {gap!r}), max|v - v_wavefront| = {dv!r} "
            f"({'bitwise' if dv == 0 else 'not bitwise'}), launches {counts}"
            f" (the schedule: {want})")
        _check_solve(torch, tag, res, solver, 50 * h * h, "f32_257_blocked")
        require(all(counts[k] == w for k, w in want.items()),
                f"{tag}: launches {counts}, the schedule implies {want}")
        require(dv == 0 or abs(gap) <= 0.01 * s32["error_linf"],
                f"{tag}: error_linf not within 1 % of the wavefront solve's")
        summary = {"n": n, "precision": "f32", "timeskew": False,
                   "error_linf": res.error_linf,
                   "residual_l2": res.residual_l2,
                   "max_abs_dv_vs_wavefront": dv,
                   "launches_per_step": want}
        summary.update(time_step(torch, tag, solver, levels, 5, 2))
    finally:
        if saved is None:
            os.environ.pop("PDE_MG_TIMESKEW", None)
        else:
            os.environ["PDE_MG_TIMESKEW"] = saved
    return counts, summary


def phase_f64_reference(torch, prob, n: int, nus, summary, v, tag: str,
                        floor: float = 0.0, wrap: bool = False,
                        err64_limit=None, gate: bool = True,
                        cycle_kw=None, dv_limit=None) -> bool:
    """The float64 solve of the same FMG schedule, exact coarsest level,
    through `MultigridSolver(..., dtype="float64", device="cuda")`: the
    plain tensor tier on the card (the dense coarse inverse is float32, as
    in the JAX package), on the hierarchy of the port's float32 solve `v`,
    whose record is `summary`: its error_linf within 1 % of the float64
    solve's, and its solution within 10 % of that error on the interior
    (or within `dv_limit`, where given), each plus `floor`, the float32
    floor of the 1D and varcoef solves (ODE_F32_FLOOR,
    POISSON1D_F32_FLOOR, VARCOEF_F32_FLOOR; 0 elsewhere).  `err64_limit`
    gates the float64 solve itself, `wrap` is the storage the float32
    solve had.  The kernels use the Pallas kernels' update form (reciprocal
    coefficients), which rounds the small decay term coarser than the jnp
    tier's division: the Lyapunov solution drifts 1.2e-5 from the float64
    one at 4097^2 where the division form drifts 3.6e-6 (PERF.md,
    Findings); JAX's own Pallas tier drifts as the port's kernels do.
    Adds the readings to `summary` and returns whether the float32 solve
    met the gate; a miss fails the run unless `gate` is False (a control).
    `cycle_kw` replaces the exact coarsest level (HJB: scheme="fas",
    coarsest="relax")."""
    from pde_multigrid_tpu_torch import (
        CycleConfig,
        MultigridSolver,
        SolverConfig,
    )
    from pde_multigrid_tpu_torch.ops.cuda.dispatch import CudaKernels

    cfg = SolverConfig(
        cycle=CycleConfig("fmg", *nus, **(cycle_kw or {"coarsest": "exact"})),
        dtype="float64", num_levels=len(summary["levels"]))
    solver = MultigridSolver(prob, n, cfg, device="cuda")
    kern = solver.program.kernels
    require(not isinstance(kern, CudaKernels)
            and not any(getattr(kern, "plans", None) or ()),
            f"{tag}: float64 on cuda did not take the plain tier")
    require(solver.geoms[0].wrap == wrap
            and [g.padded_shape for g in solver.geoms] == [
                tuple(x) for x in summary["levels"]],
            f"{tag}: the float64 hierarchy is not the float32 solve's")
    res = solver.solve()
    v64 = res.v
    m = solver.fresh_levels()[0].aux["m_int"]
    err64 = res.error_linf
    dv = float(torch.max(torch.abs((v.to(torch.float64) - v64) * m)))
    gap = summary["error_linf"] - err64
    summary.update(f64_error_linf=err64, max_abs_dv_vs_f64=dv,
                   gap_pct_of_f64=100 * gap / err64)
    dv_max = (0.1 * err64 if dv_limit is None else dv_limit) + floor
    ok = abs(gap) <= 0.01 * err64 + floor and dv <= dv_max
    log(f"reference {tag} float64 (plain tier): error_linf {err64!r}"
        + (f" (limit {err64_limit!r})" if err64_limit else "")
        + f"; the port's float32 solve: error_linf - float64's = {gap!r} "
        f"({100 * gap / err64!r} %; limit 1 % + floor: {0.01 * err64!r} + "
        f"{floor!r}), max|v - v_float64| = {dv!r} (limit {dv_max!r}): "
        f"{'within' if ok else 'outside'} the gate")
    if err64_limit is not None:
        require(err64 < err64_limit, f"{tag}: the float64 solve's error_linf "
                f"{err64!r} not under {err64_limit!r}")
    require(ok or not gate, f"{tag}: the float32 solve is not within the "
            "gate of the float64 solve")
    return ok


ODE_N = 8193
ODE_NUS = (2, 1000, 1000)
# The float32 floor of the 1D ODE solves: 16 ulp of max|u| = |u(0)| = 1.
# The float32 solution drifts from the float64 one by 10 to 11.5 ulp at
# every size from 2049 to 16385 points while the error halves with h, so
# 1 % of the error alone falls below float32's reach at 8193, where JAX's
# own Pallas form (interpreted on the CPU) misses it too (+1.00 %;
# tests/test_torch_kernels1d.py).  The floor lies above the largest
# error_linf gap of a sound float32 solve (10.1 ulp at 8193) and far below
# the control of phase_f32_floors (334 ulp; PERF.md, Findings).
ODE_F32_FLOOR = 16 * 2.0 ** -23

def busy_split_ms(torch, fn, kernels):
    """Device busy ms of one call of `fn` (warmed up), split by kernel: the
    summed device times of the torch.profiler trace's device events whose
    name holds each of `kernels` (a {label: name} map), and the rest
    ("plain"); None where the trace shows no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {label: 0.0 for label in (*kernels, "plain")}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        label = next((k for k, name in kernels.items() if name in e.name),
                     "plain")
        out[label] += e.device_time_total / 1e3
    total = sum(out.values())
    if total <= 0:
        return None
    out["total"] = total
    return out


def phase_ode1d(torch):
    """The bench's ode1d row: 8193 points, FMG(2, 1000, 1000), exact
    (dense inverse) coarsest level, precision="mixed" (no defect plan
    covers 1D: the levels relax in float32), through
    `MultigridSolver.solve()` on "cuda".  8193 and 4097 are relaxed, 2049
    (2047 interior points) solved exactly: 12 relax1d legs per step, 4 at
    8193 and 8 at 4097.  Returns (launch counts, summary, solution v)."""
    from pde_multigrid_tpu_torch import (
        CycleConfig,
        MultigridSolver,
        Ode1D,
        SolverConfig,
    )

    cfg = SolverConfig(cycle=CycleConfig("fmg", *ODE_NUS, coarsest="exact"),
                       precision="mixed")
    t0 = time.perf_counter()
    solver = MultigridSolver(Ode1D(), ODE_N, cfg, device="cuda")
    setup_s = time.perf_counter() - t0
    levels = solver.fresh_levels()
    torch.cuda.synchronize()
    reset_counts()
    res = solver.solve(levels)
    h = solver.geoms[0].spacing[0]
    limit = max(10 * h, 5e-5)
    tag = f"ode1d {ODE_N} mixed"
    log(f"{tag}: levels {[g.padded_shape for g in solver.geoms]}, solver "
        f"set-up {setup_s!r} s (the 2049-point dense inverse probed and "
        f"inverted on the host), error_linf {res.error_linf!r} (limit "
        f"max(10 h, 5e-5) = {limit!r}), residual_l2 {res.residual_l2!r}, "
        f"residual_linf {res.residual_linf!r}, launches {read_counts()}")
    counts = _check_solve(torch, tag, res, solver, limit, "ode1d", 12)
    summary = {"n": ODE_N, "problem": "ode1d", "precision": "mixed",
               "levels": [g.padded_shape for g in solver.geoms],
               "setup_s": setup_s, "error_linf": res.error_linf,
               "residual_l2": res.residual_l2}
    v = res.v.clone()
    summary["sha256"] = _sha(v)
    log(f"{tag}: solution SHA-256 {summary['sha256']}")
    summary.update(time_step(torch, tag, solver, levels, 5, 2))
    busy = busy_split_ms(torch, lambda: solver.program.solve_step(levels),
                         {"relax1d": "relax1d_kernel"})
    summary["busy_ms_per_step"] = busy and busy["total"]
    log(f"{tag}: device busy ms per step (torch.profiler, eager): {busy!r}")
    return counts, summary, v


def phase_ode1d_preset(torch):
    """`python -m pde_multigrid_tpu_torch --preset ode1d`, in process: 8193
    points, FMG(2, 1000, 1000), relaxed down to 3 points (13 levels, the
    CLI's default coarsest="relax").  A V-cycle from level l relaxes twice
    on each of the L - l levels below it, so the step runs
    nu0 * L * (L + 1) = 364 relax1d legs.  The bench's gate on the
    printed error_linf."""
    from pde_multigrid_tpu_torch.__main__ import PRESETS
    from pde_multigrid_tpu_torch.__main__ import main as cli_main

    p = PRESETS["ode1d"]
    L = (p["n"] - 1).bit_length() - 1
    legs = p["nu0"] * L * (L + 1)
    buf = io.StringIO()
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf), \
            contextlib.redirect_stderr(io.StringIO()):
        cli_main(["--preset", "ode1d", "--device", "cuda"])
    wall = time.perf_counter() - t0
    out = json.loads(buf.getvalue().strip().splitlines()[-1])
    h = 1.0 / (p["n"] - 1)
    limit = max(10 * h, 5e-5)
    tag = "--preset ode1d"
    log(f"{tag}: {L} levels, error_linf {out['error_linf']!r} (limit "
        f"{limit!r}), residual_l2 {out['residual_l2']!r}, solve "
        f"{out['wall_time_s']!r} s, command {wall!r} s, launches "
        f"{read_counts()}")
    require(out["error_linf"] < limit, f"{tag}: error_linf too large")
    require(out["residual_l2"] == out["residual_l2"]
            and abs(out["residual_l2"]) != float("inf") and not
            out["diverged"], f"{tag}: non-finite residual")
    _check_counts(tag, "ode1d", legs)
    return {"preset": "ode1d", "levels": L, "relax1d_launches": legs,
            "error_linf": out["error_linf"],
            "residual_l2": out["residual_l2"],
            "wall_time_s": out["wall_time_s"]}


POISSON1D_NUS = (2, 100, 100)
# The float32 floor of Poisson(1), FMG(2, 100, 100): h^-2 = 6.7e7 at 8193
# amplifies float32 rounding far above 50 h^2 = 7.5e-7.  Sound float32
# solves of this schedule lie 5.3e-6 to 1.4e-4 from the float64 one at
# 257 to 16385 points on the card, and up to 4.3e-4 at 8193 in the JAX
# package's own tiers on the CPU (tests/test_torch_kernels1d.py); the
# floor admits them all (PERF.md, Findings).
POISSON1D_F32_FLOOR = 5e-4


def phase_poisson1d(torch):
    """Poisson(1) at 8193 points in wrap storage (8192 stored),
    FMG(2, 100, 100), exact coarsest level (2049, fast diagonalization):
    12 relax1d legs (the Poisson update), the float32 solve within
    POISSON1D_F32_FLOOR of the float64 solve of the same schedule (plain
    tier, on the card), and the float64 solve under the 3D gate 50 h^2."""
    from pde_multigrid_tpu_torch import (
        CycleConfig,
        MultigridSolver,
        Poisson,
        SolverConfig,
    )

    n = 8193
    cfg = SolverConfig(cycle=CycleConfig("fmg", *POISSON1D_NUS,
                                         coarsest="exact"))
    solver = MultigridSolver(Poisson(1), n, cfg, device="cuda")
    torch.cuda.synchronize()
    reset_counts()
    res = solver.solve()
    tag = f"poisson1d {n}"
    h = solver.geoms[0].spacing[0]
    log(f"{tag}: levels {[g.padded_shape for g in solver.geoms]} (wrap "
        f"{solver.geoms[0].wrap}), error_linf {res.error_linf!r} (float32 "
        f"floor {POISSON1D_F32_FLOOR!r}), residual_l2 {res.residual_l2!r}, "
        f"launches {read_counts()}")
    require(solver.geoms[0].wrap, f"{tag}: not in wrap storage")
    _check_solve(torch, tag, res, solver, POISSON1D_F32_FLOOR, "ode1d", 12)
    summary = {"n": n, "problem": "poisson1d",
               "levels": [g.padded_shape for g in solver.geoms],
               "error_linf": res.error_linf, "residual_l2": res.residual_l2}
    phase_f64_reference(torch, solver.problem, n, POISSON1D_NUS, summary,
                        res.v, tag, POISSON1D_F32_FLOOR, wrap=True,
                        err64_limit=50 * h * h)
    return summary


def phase_f32_floors(torch):
    """The 1D gates' float32 floors, read over sizes: the float32 solve
    (relax1d on "cuda") against the float64 solve of the same schedule at
    2049, 4097 and 16385 points (8193 are the rows themselves), Ode1D
    FMG(2, 1000, 1000) and Poisson(1) FMG(2, 100, 100), each held to its
    row's gate; and the control, Ode1D on [0, 0.9] at 8193, where the
    float32 sum e^x + 1 + h carries h as 461 steps of 2^-22 where it is
    460.8 and so shifts the smoother's scheme, which the ODE gate must
    reject.  Returns the readings."""
    from pde_multigrid_tpu_torch import (
        CycleConfig,
        MultigridSolver,
        Ode1D,
        Poisson,
        SolverConfig,
    )

    cases = [(Ode1D(), n, ODE_NUS, ODE_F32_FLOOR, True)
             for n in (2049, 4097, 16385)]
    cases.append((Ode1D(domain=((0.0, 0.9),)), ODE_N, ODE_NUS, ODE_F32_FLOOR,
                  False))
    cases += [(Poisson(1), n, POISSON1D_NUS, POISSON1D_F32_FLOOR, True)
              for n in (2049, 4097, 16385)]
    rows = []
    for prob, n, nus, floor, sound in cases:
        cfg = SolverConfig(cycle=CycleConfig("fmg", *nus, coarsest="exact"),
                           precision="mixed")
        solver = MultigridSolver(prob, n, cfg, device="cuda")
        res = solver.solve()
        row = {"n": n, "problem": prob.name, "domain": prob.domain[0],
               "levels": [g.padded_shape for g in solver.geoms],
               "error_linf": res.error_linf}
        tag = (f"float32 floor: {prob.name} {n} on {list(prob.domain[0])}"
               f"{'' if sound else ' (control)'}")
        ok = phase_f64_reference(torch, prob, n, nus, row, res.v, tag, floor,
                                 wrap=solver.geoms[0].wrap, gate=sound)
        require(sound or not ok, f"{tag}: the gate does not reject it")
        rows.append(row)
    return rows


HJB_N = 513
HJB_NUS = (2, 30, 30)
# The gate on max|v - v_float64| of the HJB row.  Its error_linf (0.1407,
# almost all discretization error at the switching curve) barely moves with
# the iterate elsewhere, so 10 % of it would pass a solve ~1e4 times the
# float32 drift: the sound drift is 6e-7 on the CPU at 129^2 and 257^2
# (tests/test_torch_hjb.py) and 9.85e-7 on the card at 513^2 (PERF.md).
HJB_DV_LIMIT = 1e-5
# the resident levels of the HJB kernel check: every level of the 513^2
# hierarchy the leg kernel serves
HJB_RESIDENT_SIZES = (257, 129, 65, 33, 17, 9, 5, 3)
# ms of a 30-sweep leg of the HJB leg kernel by level (phase_kernels_hjb)
HJB_LEG_MS = {}
# ms of a 30-sweep leg of the slab kernel (row 3) by level
HJB_SLAB_MS = {}


def _hjb_inputs(torch, rng, prob, g):
    """(v, f, fixed) for an HJB level on the card: the initial level (the
    boundary ring and the pinned ball hold their exact values) plus
    uniform [0, 1) values on the points a sweep updates, f = 1 + 0.1 N(0, 1)
    everywhere, and the mask of the points a sweep must leave as they are
    (ring and ball)."""
    import numpy as np

    lvl = prob.init_level(g, torch.float32, "cuda")
    m = lvl.aux["m_int"]
    noise = torch.tensor(rng.random(g.padded_shape).astype(np.float32),
                         device="cuda")
    f = torch.tensor(
        (1.0 + 0.1 * rng.standard_normal(g.padded_shape)).astype(np.float32),
        device="cuda")
    return (lvl.v + m * noise).contiguous(), f, m == 0


def _hjb_leg_cost(g, nsweeps):
    """(bytes, operations) of one HJB relax leg on level `g`: v, f and the
    mask byte read, v written, four coefficient columns read; per sweep and
    updated point 15 operations (the upwind blend 4, the minimum 1, base 2,
    the two candidates 4, the select 2, the masked write 2)."""
    X, Y = g.padded_shape
    n_int = (g.shape[0] - 2) * (g.shape[1] - 2)
    return 13 * X * Y + 16 * Y, 15 * n_int * nsweeps


def phase_kernels_hjb(torch):
    """The HJB kernels against their plain versions on the card, bitwise,
    with the boundary ring and the pinned target ball unchanged: slab2d in
    the layout of its plan (`slab2d.slab_layout`: a whole leg one
    cooperative launch on 513^2 and 257^2, at most T sweeps a launch on
    1025^2) at 513^2 and 257^2 with nsweeps 1, T - 1, T, T + 1 and 30 (a
    30-sweep leg twice, the same bits: the outboxes' epochs move on), at
    1025^2 with 1 and 30, a 30-sweep leg timed on each (ms into
    HJB_SLAB_MS); resident_hjb on every level from 257^2 to 3^2 in the
    layout of the plan (`resident.hjb_leg_layout`) at 1, T - 1, T, T + 1
    and 30 sweeps (T the layout's sweeps between halo refreshes, 30 on one
    CTA),
    a 30-sweep leg timed on each (ms and us per sweep into HJB_LEG_MS).
    Returns {name: record}: slab2d per 30-sweep leg at 513^2,
    resident_hjb per 30-sweep leg at 257^2."""
    import numpy as np

    from pde_multigrid_tpu_torch.grid import build_geometries
    from pde_multigrid_tpu_torch.models import HJBMinTime
    from pde_multigrid_tpu_torch.ops.cuda import resident as RS
    from pde_multigrid_tpu_torch.ops.cuda import slab2d as SL

    prob = HJBMinTime()
    rng = np.random.default_rng(2027)
    nsw = HJB_NUS[1]
    out = {}

    def record(name, err, t, what, cost):
        res = {"max_abs_err": err, "ms": t["ms"], "plain_ms": t["plain_ms"],
               **bound(*cost), "library_ms": None}
        log(f"kernel {name} ({what}): max|kernel - plain| = {err!r}; device "
            f"{t['ms']!r} ms vs plain {t['plain_ms']!r} ms (bound "
            f"{res['bound_ms']!r} ms by {res['bound_by']}); eager call "
            f"{t['eager_ms']!r} ms vs plain {t['eager_plain_ms']!r} ms")
        return res

    for n in (HJB_N, 257, 1025):
        g = build_geometries((n, n), prob.domain, 1)[0]
        v, f, fixed = _hjb_inputs(torch, rng, prob, g)
        lay = SL.slab_layout(g)
        T = lay.T
        counts = {1, nsw} if n == 1025 else {1, T - 1, T, T + 1, nsw}
        for ns in sorted(counts - {0}):
            k = SL.slab_relax(v, f, ns, prob, g)
            p = SL.slab_relax_plain(v, f, ns, prob, g)
            err = _max_err(torch, k, p)
            require(torch.equal(k, p), f"slab2d at {n}^2, {ns} sweeps, not "
                    f"bitwise: max diff {err!r}")
            require(torch.equal(k[fixed], v[fixed]), f"slab2d at {n}^2: a "
                    "ring or pinned point changed")
        require(torch.equal(SL.slab_relax(v, f, nsw, prob, g), k),
                f"slab2d at {n}^2: a second {nsw}-sweep leg differs")
        what = (f"{n}^2, one {nsw}-sweep leg in {SL.slab_launches(nsw, g)} "
                f"launch(es): {lay.ntx} x {lay.nty} tiles of {lay.BX} x "
                f"{lay.BY}, T = {T}, {lay.threads} threads a CTA, "
                f"{'a leg a launch' if lay.leg else 'T sweeps a launch'}")
        if n == HJB_N:
            t = paired_times(
                torch, lambda: SL.slab_relax(v, f, nsw, prob, g),
                lambda: SL.slab_relax_plain(v, f, nsw, prob, g), 1)
            out["slab2d"] = record("slab2d", err, t, what,
                                   _hjb_leg_cost(g, nsw))
            HJB_SLAB_MS[n] = t["ms"]
            continue
        ms = device_ms(torch, lambda: SL.slab_relax(v, f, nsw, prob, g), 3)
        HJB_SLAB_MS[n] = ms
        log(f"kernel slab2d ({what}): bitwise; device {ms!r} ms")

    for n in HJB_RESIDENT_SIZES:
        g = build_geometries((n, n), prob.domain, 1)[0]
        v, f, fixed = _hjb_inputs(torch, rng, prob, g)
        lay = RS.hjb_leg_layout(g)
        # one CTA runs the leg as one chunk; a cluster refreshes its halos
        # every T sweeps
        T = lay.T or nsw
        tag = (f"{n}^2 on {lay.nctas} CTA(s) of {lay.threads} threads, "
               f"T = {T}, {lay.G} segment(s) of {lay.L} rows")
        for ns in sorted({1, T - 1, T, T + 1, nsw} - {0}):
            k = RS.resident_relax(v.clone(), f, ns, prob, g)
            p = RS.resident_relax_plain(v.clone(), f, ns, prob, g)
            err = _max_err(torch, k, p)
            require(torch.equal(k, p), f"resident_hjb {ns} sweeps at {tag} "
                    f"not bitwise: max diff {err!r}")
            require(torch.equal(k[fixed], v[fixed]),
                    f"resident_hjb at {tag}: a ring or pinned point changed")
        w = v.clone()
        if n == 257:
            t = paired_times(
                torch, lambda: RS.resident_relax(w, f, nsw, prob, g),
                lambda: RS.resident_relax_plain(w, f, nsw, prob, g), 1)
            out["resident_hjb"] = record(
                "resident_hjb", err, t, f"{tag}, one {nsw}-sweep leg",
                _hjb_leg_cost(g, nsw))
            ms = t["ms"]
        else:
            ms = device_ms(
                torch, lambda: RS.resident_relax(w, f, nsw, prob, g), 3)
        HJB_LEG_MS[n] = ms
        log(f"kernel resident_hjb ({tag}, one {nsw}-sweep leg): bitwise at "
            f"1, T - 1, T, T + 1 and {nsw} sweeps; device {ms!r} ms, "
            f"{ms / nsw * 1e3!r} us per sweep")
        if n == 3:
            FLOORS["resident_hjb_us_per_sweep"] = ms / nsw * 1e3
    torch.cuda.synchronize()
    return out


def _hjb_gate(h: float) -> float:
    """The bench's hjb2d error gate (bench.py:722-728): 1.15 times the
    pinned envelope 0.2032 (32 h)^0.17 of the first-order monotone scheme
    (the value function is Holder-1/2 on the switching curve)."""
    return 1.15 * 0.2032 * (h * 32.0) ** 0.17


def phase_hjb(torch):
    """The bench's hjb2d row: 513^2, FMG(2, 30, 30), scheme="fas",
    coarsest="relax", f32, through `MultigridSolver.solve()` on "cuda":
    error_linf under the bench's gate, finite residuals, the boundary ring
    and the pinned ball of the finest level exact after the step, exactly
    the slab2d and resident_hjb launches the schedule implies (4 legs at
    513^2, a launch each (`slab_launches`), 176 resident legs) and no
    other kernel;
    ms per step and DOF-updates/s eager and as one CUDA graph, and the
    profiler's busy time split into slab, resident and plain ops.  Returns
    (launch counts, summary, solution v)."""
    from pde_multigrid_tpu_torch import (
        CycleConfig,
        HJBMinTime,
        MultigridSolver,
        SolverConfig,
    )
    from pde_multigrid_tpu_torch.ops.cuda import slab2d as SL

    cfg = SolverConfig(cycle=CycleConfig("fmg", *HJB_NUS, scheme="fas",
                                         coarsest="relax"))
    solver = MultigridSolver(HJBMinTime(), HJB_N, cfg, device="cuda")
    levels = solver.fresh_levels()
    fixed = (levels[0].aux["m_log"] - levels[0].aux["m_int"]) > 0
    anchor = levels[0].v[fixed].clone()
    torch.cuda.synchronize()
    reset_counts()
    res = solver.solve(levels)
    counts = read_counts()
    h = max(solver.geoms[0].spacing)
    limit = _hjb_gate(h)
    nlev = len(solver.geoms)
    nu0 = HJB_NUS[0]
    legs = nu0 * nlev * (nlev + 1)  # a V-cycle from l relaxes twice per level
    fine_legs = 2 * nu0
    want = {"slab2d": fine_legs * SL.slab_launches(HJB_NUS[1],
                                                   solver.geoms[0]),
            "resident_hjb": legs - fine_legs}
    tag = f"hjb2d {HJB_N}^2 FAS f32"
    log(f"{tag}: levels {[g.padded_shape for g in solver.geoms]}, error_linf "
        f"{res.error_linf!r} (limit 1.15 * 0.2032 * (32 h)^0.17 = "
        f"{limit!r}), residual_l2 {res.residual_l2!r}, residual_linf "
        f"{res.residual_linf!r}, launches {counts} (want {want}, slab2d "
        f"{SL.slab_layout(solver.geoms[0]).as_dict()})")
    _check_solve(torch, tag, res, solver, limit, "hjb", want)
    require(torch.equal(res.v[fixed], anchor),
            f"{tag}: the boundary ring or the pinned ball changed")
    summary = {"n": HJB_N, "problem": "hjb2d", "scheme": "fas",
               "precision": "f32",
               "levels": [g.padded_shape for g in solver.geoms],
               "slab_layout": SL.slab_layout(solver.geoms[0]).as_dict(),
               "error_linf": res.error_linf,
               "residual_l2": res.residual_l2}
    v = res.v.clone()
    summary["sha256"] = _sha(v)
    log(f"{tag}: solution SHA-256 {summary['sha256']}")
    summary.update(time_step(torch, tag, solver, levels, 3, 1))
    busy = busy_split_ms(
        torch, lambda: solver.program.solve_step(levels),
        {"slab2d": "slab2d_kernel", "resident_hjb": "resident2d_kernel"})
    summary["busy_ms_per_step"] = busy
    log(f"{tag}: device busy ms per step (torch.profiler, eager): {busy!r}")
    return counts, summary, v


def phase_fas3d(torch):
    """FAS on 3D Poisson through the CUDA plan (ROADMAP.md queue 3 F1):
    33^3 in wrap storage, five V(2, 2) cycles in the full approximation
    scheme and in the correction scheme through
    `MultigridSolver.solve_to_tolerance()` on "cuda".  For this linear
    problem FAS is the correction scheme: error_linf within 1e-5 and the
    last cycle's residual reduction within 0.15 of each other (the CPU
    counterpart: tests/test_torch_galerkin.py), and each solve launches the
    kernels of its plan and no other: the correction scheme the fused
    subtree (every level is at most 32^3) and the residual norms; FAS the
    whole-leg resident kernel (merged mode on 32^3 and 16^3, one-CTA mode
    on 8^3 ... 2^3) and the transfer kernels on the sub-lane pairs (FAS's
    coarse change through prolong_blend's add mode)."""
    from pde_multigrid_tpu_torch import (
        CycleConfig,
        MultigridSolver,
        Poisson3D,
        SolverConfig,
    )

    n = 33
    out = {}
    for scheme in ("cs", "fas"):
        cfg = SolverConfig(cycle=CycleConfig("v", 0, 2, 2, scheme=scheme),
                           tol=0.0, max_cycles=5)
        solver = MultigridSolver(Poisson3D(), n, cfg, device="cuda")
        torch.cuda.synchronize()
        reset_counts()
        res = solver.solve_to_tolerance()
        h = solver.geoms[0].spacing[0]
        tag = f"{scheme} {n}^3 V(2, 2) x 5"
        log(f"{tag}: residual history {res.residual_history!r}, error_linf "
            f"{res.error_linf!r}, launches {read_counts()}")
        _check_solve(torch, tag, res, solver, 50 * h * h, f"fas3d_{scheme}")
        out[scheme] = res
    cs, fas = out["cs"], out["fas"]

    def rho(r):
        return r.residual_history[-1] / r.residual_history[-2]

    require(abs(cs.error_linf - fas.error_linf) < 1e-5
            and abs(rho(cs) - rho(fas)) < 0.15,
            f"FAS {n}^3 is not the correction scheme: error_linf "
            f"{fas.error_linf!r} vs {cs.error_linf!r}, last reduction "
            f"{rho(fas)!r} vs {rho(cs)!r}")
    return {"n": n, "problem": "poisson3d", "check": "fas == cs",
            "error_linf": {"cs": cs.error_linf, "fas": fas.error_linf},
            "residual_history": {"cs": cs.residual_history,
                                 "fas": fas.residual_history}}


FAS_N = 257
FAS_NUS = (2, 100, 100)
# the FAS 257^3 step with the resident kernel's levels relaxed by the
# half-sweeps instead (all of them, or 64^3 alone), ms per step (printed
# with the summaries)
FAS_AB = {}


def _fas_cfg(scheme: str = "fas", dtype: str = "float32"):
    from pde_multigrid_tpu_torch import CycleConfig, SolverConfig

    return SolverConfig(cycle=CycleConfig("fmg", *FAS_NUS, scheme=scheme,
                                          coarsest="relax"), dtype=dtype)


def fas_launches(solver) -> dict:
    """The launches `solver.solve()` implies on the FAS row: one FMG step,
    level l visited nu0 (l + 1) times, each visit two relax legs (the
    coarsest too) of the plan's tier: ceil(nu / T) wavefront launches or
    2 nu half-sweeps, each leg with a split of v and of f and a merge, or
    one launch of the resident kernel; each visit of a level above the
    coarsest restricts its residual (restrict-only mode), takes the
    residual on the level and, f-less, on the injected coarse iterate
    (FAS's coarse right side: residual_zero_f, no zero f filled) and
    prolongs the coarse change ('add'); the f-cascade
    restricts once per pair, the upward leg prolongs once per pair
    ('replace'); the result's residual norms take one residual.  The
    sub-lane pairs count as rows 23 and 24."""
    from pde_multigrid_tpu_torch.ops.cuda import relax as R

    cyc = solver.config.cycle
    geoms = solver.geoms
    want = dict.fromkeys(PATHS["fas257"], 0)
    for l, (g, tier) in enumerate(zip(geoms, solver.program.kernels.tiers)):
        visits = cyc.nu0 * (l + 1)
        for nu in (cyc.nu1, cyc.nu2):
            if tier == "timeskew":
                want[tier] += visits * -(-nu // R.TIMESKEW_T)
            elif tier == "half_sweep":
                want[tier] += visits * 2 * nu
            else:
                want[tier] += visits
            if tier in ("timeskew", "half_sweep"):
                want["split"] += 2 * visits
                want["merge"] += visits
        if l + 1 < len(geoms):
            small = tuple(g.padded_shape) in SMALL_PAIR_FINE
            want["small_restrict" if small else "residual_restrict"] += (
                visits + 1)
            want["small_prolong_blend" if small else "prolong_blend"] += (
                visits + 1)
            want["residual"] += visits
            want["residual_zero_f"] += visits
    want["residual"] += 1
    return want


def phase_fas3d_257(torch):
    """3D Poisson in the full approximation scheme at 257^3: FMG(2, 100,
    100), coarsest relaxed (8 levels to 2^3), f32, through
    `MultigridSolver.solve()` on "cuda".  The plan: the wavefront on
    256^3, the half-sweeps on 128^3, the whole-leg resident kernel's
    merged mode on 64^3, 32^3, 16^3 and its one-CTA mode on 8^3, 4^3, 2^3
    (JAX's plan_relax order).  error_linf < 50 h^2, finite residuals,
    exactly `fas_launches` and no other kernel; ms per step and
    DOF-updates/s eager and as one CUDA graph; the same step with the
    resident kernel's levels on the half-sweeps (all of them, and 64^3
    alone), bitwise the same solution, eager and graph ms; the
    correction-scheme solve of the same schedule (fused subtree on the
    roots of 64^3 and below): |error_linf - FAS's| < 1e-5; and the float64
    FAS solve on the plain tier (`dtype="float64"`): under 50 h^2, its gap
    to the f32 solve reported.  Returns (launch counts, summary)."""
    from pde_multigrid_tpu_torch import MultigridSolver, Poisson3D
    from pde_multigrid_tpu_torch.ops.cuda import relax as R

    n = FAS_N
    solver = MultigridSolver(Poisson3D(), n, _fas_cfg(), device="cuda")
    tiers = solver.program.kernels.tiers
    plan = ["timeskew", "half_sweep"] + ["merged_resident"] * 3 + [
        "resident3d"] * 3
    require(tiers == plan, f"fas {n}^3 plan {tiers}")
    want = fas_launches(solver)
    levels = solver.fresh_levels()
    torch.cuda.synchronize()
    reset_counts()
    res = solver.solve(levels)
    counts = read_counts()
    h = solver.geoms[0].spacing[0]
    tag = f"fas {n}^3 FMG{FAS_NUS} relax-coarsest"
    log(f"{tag}: levels {[g.padded_shape[0] for g in solver.geoms]}, plan "
        f"{tiers}, error_linf {res.error_linf!r} (limit 50 h^2 = "
        f"{50 * h * h!r}), residual_l2 {res.residual_l2!r}, launches "
        f"{counts}, the schedule's {want}")
    _check_solve(torch, tag, res, solver, 50 * h * h, "fas257", want)
    summary = {"n": n, "scheme": "fas", "nus": list(FAS_NUS),
               "coarsest": "relax", "plan": tiers,
               "error_linf": res.error_linf,
               "residual_l2": res.residual_l2, "launches": want}
    summary.update(time_step(torch, tag, solver, levels, 3, 2))
    # the per-level A/B end to end: the resident kernel's levels relaxed
    # by the half-sweeps (row 9) instead
    for name, moved in (("row9_below_128", ("merged_resident",
                                            "resident3d")),
                        ("row9_at_64", ())):
        alt = MultigridSolver(Poisson3D(), n, _fas_cfg(), device="cuda")
        for l, g in enumerate(alt.geoms):
            if tiers[l] in moved or (not moved and g.padded_shape[0] == 64):
                alt.program.kernels._relax[l] = R.make_split_relax(
                    alt.problem, g)
        alt_res = alt.solve()
        require(torch.equal(alt_res.v, res.v),
                f"{tag}: {name} changes the solution")
        lv = alt.fresh_levels()
        step = lambda: alt.program.solve_step(lv)  # noqa: E731
        FAS_AB[name] = {"eager": time_ms(torch, step, 3),
                        "graph": device_ms(torch, step, 2)}
        del alt, lv, alt_res
    FAS_AB["plan"] = {"eager": summary["ms_per_step"],
                      "graph": summary["graph_ms_per_step"]}
    log(f"{tag}: ms per step, plan vs the half-sweeps on the resident "
        f"kernel's levels (bitwise the same solution): {FAS_AB!r}")
    cs = MultigridSolver(Poisson3D(), n, _fas_cfg("cs"), device="cuda")
    res_cs = cs.solve()
    d_cs = abs(res_cs.error_linf - res.error_linf)
    log(f"{tag}: the correction scheme's error_linf {res_cs.error_linf!r}, "
        f"|difference| {d_cs!r} (limit 1e-5)")
    require(d_cs < 1e-5, f"{tag}: FAS is not the correction scheme")
    summary["error_linf_cs"] = res_cs.error_linf
    del cs, res_cs
    s64 = MultigridSolver(Poisson3D(), n, _fas_cfg(dtype="float64"),
                          device="cuda")
    require(type(s64.program.kernels).__name__ == "TorchKernels",
            f"{tag} float64: not the plain tier")
    r64 = s64.solve()
    m = s64.fresh_levels()[0].aux["m_int"]
    dv = float(torch.max(torch.abs((res.v.to(torch.float64) - r64.v) * m)))
    log(f"{tag} float64 (plain tier): error_linf {r64.error_linf!r}; the "
        f"f32 solve's gap {abs(res.error_linf - r64.error_linf)!r}, "
        f"max|v - v_float64| {dv!r}")
    require(r64.error_linf < 50 * h * h, f"{tag} float64: error_linf "
            f"{r64.error_linf!r}")
    summary.update({"f64_error_linf": r64.error_linf,
                    "max_abs_dv_vs_f64": dv, "ab_ms_per_step": FAS_AB})
    del s64, r64
    return counts, summary


VARCOEF_N = 1025
VARCOEF_NUS = (2, 40, 40)
VARCOEF_CYCLE = {"coarsest": "relax", "coarse_operator": "galerkin"}
# The float32 floor of the varcoef2d row.  The right side is manufactured
# discretely, so the float64 solve lies within ~1e-12 of the oracle and a
# float32 solve's error_linf and max|v - v_float64| are both its rounding
# floor: 1.47e-5 at 1025^2 on the CPU (5.4e-7 at 513^2, 1.2e-6 at 257^2;
# tests/test_torch_galerkin.py), under the bench's gate max(50 h^2, 5e-5),
# which the floor is.  It rejects a solve of another operator (the +-1
# coefficients swapped, as a kernel reading the wrong offset would: ~1e-3
# off at 257^2) but not the in-place 9-point sweep or rediscretized coarse
# operators, which converge to the same discrete solution within the same
# floor: the bitwise kernel checks reject the in-place sweep (PERF.md,
# Findings).
VARCOEF_F32_FLOOR = 5e-5
# per level of the varcoef2d row: ms of one 40-sweep leg by its planned
# kernel (phase_kernels_stencil), for the step's share by level
VARCOEF_LEG_MS = {}
# ms of one 40-sweep leg by the plan's kernel on phase_kernels_stencil's
# other levels (1D, 3D, odd 2D), by level
STENCIL_LEG_MS = {}


def _galerkin_solver(prob, n: int, nus=VARCOEF_NUS):
    from pde_multigrid_tpu_torch import (
        CycleConfig,
        MultigridSolver,
        SolverConfig,
    )

    cfg = SolverConfig(cycle=CycleConfig("fmg", *nus, **VARCOEF_CYCLE))
    return MultigridSolver(prob, n, cfg, device="cuda")


def _stencil_leg_cost(lvl, K: int, nsweeps: int, constant: bool):
    """(bytes, operations) of one relax leg of `nsweeps` sweeps: v and f
    read once, v written once, the coefficients read once (K per point,
    or K in all for a constant operator); per sweep and interior point
    K - 1 products and subtractions, the division and the blend's two."""
    pts = lvl.v.numel()
    n_int = int(lvl.aux["m_int"].sum())
    nbytes = 4 * (3 * pts + (K if constant else K * pts))
    return nbytes, (2 * K + 1) * n_int * nsweeps


def _random_stencil(torch, rng, g, offs):
    """Random coefficients for a level of no hierarchy (the odd 2D and 3D
    levels and the large 1D one), one set a point: off-center terms in
    [-1, 0), the center 2K, so a leg stays bounded."""
    import numpy as np

    K = len(offs)
    c = -rng.random(tuple(g.padded_shape) + (K,)).astype(np.float32)
    c[..., offs.index((0,) * g.ndim)] = 2.0 * K
    return torch.tensor(c, device="cuda")


def phase_kernels_stencil(torch):
    """The stencil-operator kernels against their plain version on the
    card, bit for bit, over 1, 40 and 7 sweeps: on the levels of the
    varcoef2d 1025^2 hierarchy with their own coefficients, the plan's form
    (stencil_slab2d on 1024^2-256^2, stencil_resident's leg on 128^2-2^2)
    and stencil_slab2d in its form on all ten (1024^2 K = 5, 512^2 to 2^2
    K = 9); then the plan's form on an odd 2D level (65^2 padded, K = 9,
    random coefficients, and the slab there), Galerkin varcoef1d 1025
    (1024 and 512 points, K = 3), a 1D level only the general form holds
    (8192, K = 3), Galerkin Poisson(3) 33^3 (32^3, the constant 7-point
    operator: coefficient stride 0; 16^3, 27 points), a padded 3D level
    only the general form holds (33^3, K = 7, random coefficients), and the
    slab on Galerkin Poisson(2) 129^2 (128^2, the constant 5-point
    operator).  A 40-sweep leg of the plan's form is timed on every level
    (graph-replayed; VARCOEF_LEG_MS for the varcoef2d row, STENCIL_LEG_MS
    for the others).  Returns {name: record}: stencil_slab2d per 40-sweep
    leg at 1024^2, stencil_resident per 40-sweep leg at 128^2 (the plan's
    leg)."""
    import numpy as np

    from pde_multigrid_tpu_torch import Poisson, VariableCoefficientPoisson
    from pde_multigrid_tpu_torch import grid as TG
    from pde_multigrid_tpu_torch.ops.cuda import stencilop as SO
    from pde_multigrid_tpu_torch.ops.galerkin import neighborhood_offsets

    rng = np.random.default_rng(2028)
    nsw = VARCOEF_NUS[1]
    out = {}

    def check(label, fn, v, f, c, offs, g, tag):
        """fn(v, f, c, nsweeps) against the plain version over 1, 40 and 7
        sweeps (7: not a multiple of T), bit for bit; returns the last
        max|kernel - plain|."""
        err = 0.0
        for ns in (1, nsw, 7):
            k = fn(v.clone(), f, c, ns)
            p = SO.stencil_relax_plain(v.clone(), f, c, offs, g, ns)
            err = _max_err(torch, k, p)
            require(torch.equal(k, p), f"{label} at {tag}, {ns} sweeps, not "
                    f"bitwise: max diff {err!r}")
        return err

    def rand_vf(g):
        return (torch.tensor(rng.standard_normal(g.padded_shape).astype(
            np.float32), device="cuda") for _ in range(2))

    def slab(offs, g):
        return lambda v, f, c, n: SO.stencil_slab2d(v, f, c, offs, g, n)

    solver = _galerkin_solver(VariableCoefficientPoisson(2), VARCOEF_N)
    kern = solver.program.kernels
    for l, (g, lvl) in enumerate(zip(solver.geoms, solver.fresh_levels())):
        offs = kern.offsets[l]
        plan = kern.plans[l]
        K = len(offs)
        tag = f"{g.padded_shape[0]}^2 K = {K}"
        c = lvl.aux["stencil_coeffs"]
        v, f = rand_vf(g)
        err = check(f"{plan!r}", plan, v, f, c, offs, g, tag)
        if plan.kernel != "stencil_slab2d":
            check("stencil_slab2d", slab(offs, g), v, f, c, offs, g, tag)
        w = v.clone()
        kern_fn = lambda: plan(w, f, c, nsw)  # noqa: E731
        big = (l == 0 and plan.kernel == "stencil_slab2d") or (
            g.padded_shape[0] == 128 and plan.kernel == "stencil_resident")
        if big:
            cost = _stencil_leg_cost(lvl, K, nsw, False)
            t = paired_times(torch, kern_fn, lambda: SO.stencil_relax_plain(
                w, f, c, offs, g, nsw), 1)
            res = {"max_abs_err": err, "ms": t["ms"],
                   "plain_ms": t["plain_ms"], **bound(*cost),
                   "library_ms": None}
            out[plan.kernel] = res
            log(f"kernel {plan.kernel} ({tag}, {plan!r}, one {nsw}-sweep "
                f"leg): max|kernel - plain| = {err!r}; device {t['ms']!r} "
                f"ms vs plain {t['plain_ms']!r} ms (bound "
                f"{res['bound_ms']!r} ms by {res['bound_by']}); eager call "
                f"{t['eager_ms']!r} ms vs plain {t['eager_plain_ms']!r} ms")
            VARCOEF_LEG_MS[l] = t["ms"]
        else:
            VARCOEF_LEG_MS[l] = device_ms(torch, kern_fn, 3)
        log(f"stencil leg at {tag} (one {nsw}-sweep leg, device ms; bitwise"
            f" over 1, {nsw}, 7 sweeps, and the slab): {plan!r} "
            f"{VARCOEF_LEG_MS[l]!r}")

    # the resident kernel's other views: an odd 2D level, 1D, 3D; the slab
    # on a constant operator
    odd = TG.build_geometries((65, 65), ((0.0, 1.0),) * 2, 1)[0]
    big1 = TG.build_geometries((8193,), ((0.0, 1.0),), 1, wrap=True)[0]
    odd3 = TG.build_geometries((33,) * 3, ((0.0, 1.0),) * 3, 1)[0]
    cases = [(odd, neighborhood_offsets(2), None),
             (big1, ((0,), (-1,), (1,)), None),
             (odd3, tuple(o for o in neighborhood_offsets(3)
                          if sum(map(abs, o)) <= 1), None)]
    for prob, n, ls in ((VariableCoefficientPoisson(1), 1025, (0, 1)),
                        (Poisson(3), 33, (0, 1)), (Poisson(2), 129, (0,))):
        s3 = _galerkin_solver(prob, n)
        lv = s3.fresh_levels()
        for l in ls:
            cases.append((s3.geoms[l], s3.program.kernels.offsets[l],
                          lv[l].aux["stencil_coeffs"]))
    for g, offs, c in cases:
        if c is None:
            c = _random_stencil(torch, rng, g, tuple(offs))
        plan = SO.plan_stencil_relax(offs, g)
        tag = (f"level {g.padded_shape} (wrap {g.wrap}) K = {len(offs)} "
               f"coefficients {tuple(c.shape)}")
        v, f = rand_vf(g)
        check(f"{plan!r}", plan, v, f, c, offs, g, tag)
        if g.ndim == 2 and plan.kernel != "stencil_slab2d":
            check("stencil_slab2d", slab(offs, g), v, f, c, offs, g, tag)
        w = v.clone()
        STENCIL_LEG_MS[tag] = device_ms(
            torch, lambda: plan(w, f, c, nsw), 3)
        log(f"stencil leg at {tag} (one {nsw}-sweep leg, device ms; bitwise"
            f" over 1, {nsw}, 7 sweeps): {plan!r} {STENCIL_LEG_MS[tag]!r}")
    torch.cuda.synchronize()
    return out


def phase_varcoef(torch):
    """The bench's varcoef2d row: 1025^2 (wrap storage, 1024^2 stored),
    FMG(2, 40, 40), coarse_operator="galerkin", coarsest="relax", f32,
    through `MultigridSolver.solve()` on "cuda": error_linf under the
    bench's gate max(50 h^2, 5e-5), finite residuals, exactly the
    launches of the plan (2 nu0 (l + 1) legs on level l: ceil(40 / T) slab
    launches per leg on the slab levels, one resident launch per leg on
    the others) and no other kernel; ms per step and DOF-updates/s eager and as one
    CUDA graph, the profiler's busy time split into the two kernels and
    plain ops, and the kernels' share by level (legs x the leg times of
    phase_kernels_stencil).  Returns (launch counts, summary, solution
    v)."""
    from pde_multigrid_tpu_torch import VariableCoefficientPoisson

    solver = _galerkin_solver(VariableCoefficientPoisson(2), VARCOEF_N)
    plans = solver.program.kernels.plans
    levels = solver.fresh_levels()
    torch.cuda.synchronize()
    reset_counts()
    res = solver.solve(levels)
    counts = read_counts()
    h = solver.geoms[0].spacing[0]
    limit = max(50 * h * h, 5e-5)
    nu0, nsw = VARCOEF_NUS[0], VARCOEF_NUS[1]
    legs = [2 * nu0 * (l + 1) for l in range(len(solver.geoms))]
    want = {k: sum(n * p.launches(nsw) for n, p in zip(legs, plans)
                   if p.kernel == k) for k in PATHS["varcoef"]}
    tag = f"varcoef2d {VARCOEF_N}^2 galerkin f32"
    log(f"{tag}: levels {[g.padded_shape for g in solver.geoms]} (wrap "
        f"{solver.geoms[0].wrap}), plan {plans!r}, error_linf "
        f"{res.error_linf!r} (limit max(50 h^2, 5e-5) = {limit!r}), "
        f"residual_l2 {res.residual_l2!r}, residual_linf "
        f"{res.residual_linf!r}, launches {counts} (want {want})")
    _check_solve(torch, tag, res, solver, limit, "varcoef", want)
    summary = {"n": VARCOEF_N, "problem": "varcoef2d",
               "coarse_operator": "galerkin", "precision": "f32",
               "levels": [g.padded_shape for g in solver.geoms],
               "plan": [p.kernel for p in plans],
               "error_linf": res.error_linf,
               "residual_l2": res.residual_l2}
    v = res.v.clone()
    summary.update(time_step(torch, tag, solver, levels, 3, 1))
    busy = busy_split_ms(
        torch, lambda: solver.program.solve_step(levels),
        {"stencil_resident": "stencil_resident",
         "stencil_slab2d": "stencil_slab2d_kernel"})
    summary["busy_ms_per_step"] = busy
    by_level = {solver.geoms[l].padded_shape[0]: legs[l] * ms
                for l, ms in sorted(VARCOEF_LEG_MS.items())}
    summary["kernel_ms_by_level"] = by_level
    log(f"{tag}: device busy ms per step (torch.profiler, eager): {busy!r}; "
        f"kernel ms per step by level (legs x one leg's time): {by_level!r}")
    return counts, summary, v


def phase_reference(torch, n: int, solves):
    """The float64 solution of the same FMG(2,100,100) exact-coarsest
    schedule at n^3 through `MultigridSolver(..., dtype="float64",
    device="cuda")`: the plain tensor tier on the card (the exact coarse
    solve contracts in float32, as the JAX package does).  `solves` maps
    precision -> (summary, solution v).  The mixed solve must reach the
    float64 solve's discretization error to 10 % and its solution to
    within 10 % of that error; the f32 solve's gaps are reported (the
    direct f32 sweeps round the O(1) iterate every sweep, the defect path
    only the small correction)."""
    from pde_multigrid_tpu_torch import (
        CycleConfig,
        MultigridSolver,
        Poisson3D,
        SolverConfig,
    )

    nlev = len(solves["mixed"][0]["levels"])
    cfg = SolverConfig(cycle=CycleConfig("fmg", 2, 100, 100,
                                         coarsest="exact"),
                       dtype="float64", num_levels=nlev)
    solver = MultigridSolver(Poisson3D(), n, cfg, device="cuda")
    require(solver.geoms[0].wrap and type(solver.program.kernels).__name__
            == "TorchKernels", f"{n}^3 float64: not the plain tier in wrap "
            "storage")
    res = solver.solve()
    v64 = res.v
    m = solver.fresh_levels()[0].aux["m_int"]
    err64 = res.error_linf
    F64_ERR[n] = err64
    log(f"reference {n}^3 float64 (plain tier): error_linf {err64!r}")
    for precision, (summary, v) in solves.items():
        gap = abs(summary["error_linf"] - err64)
        dv = float(torch.max(torch.abs((v.to(torch.float64) - v64) * m)))
        summary["f64_error_linf"] = err64
        summary["max_abs_dv_vs_f64"] = dv
        log(f"reference {n}^3 {precision}: |error_linf - float64's| = "
            f"{gap!r}, max|v - v_float64| = {dv!r} (limits for mixed: "
            f"{0.1 * err64!r} each)")
    summary, _ = solves["mixed"]
    require(abs(summary["error_linf"] - err64) <= 0.1 * err64,
            f"{n}^3 mixed: error_linf not within 10 % of the float64 "
            "solve's")
    require(summary["max_abs_dv_vs_f64"] <= 0.1 * err64,
            f"{n}^3 mixed: solution not within 10 % of the discretization "
            "error of the float64 solve")


F64_ERR = {}  # n -> the float64 FMG(2,100,100) error_linf of phase_reference


def preset_launches(solver, T: int) -> dict:
    """The launches one FMG step of the solver's schedule implies, by
    kernel: every cycle (nu0 from each level) launches one subtree kernel
    at its root, or mu^(lf - l) of them where a cycle rooted at l reaches
    the first fused level lf; a level l above lf is visited
    nu0 (1 + mu + ... + mu^l) times (nu0 (l + 1) for V-cycles), each
    visit two relax legs
    (the wavefront's ceil(nu / T) launches or 2 nu half-sweeps per leg, a
    split of v and of f and a merge per leg) and one residual_restrict and
    one prolong_blend ('add') to the level below; the FMG f-cascade
    restricts once per pair and its upward leg prolongs once per pair
    ('replace'), the sub-lane pairs counted as rows 23 and 24; the
    residual norms take 2 residual launches."""
    from pde_multigrid_tpu_torch.ops.cuda import relax as R

    cyc = solver.config.cycle
    geoms = solver.geoms
    fused = solver.program.kernels._sub_v
    lf = next(l for l, fn in enumerate(fused) if fn is not None)
    want = {"subtree": cyc.nu0 * (len(geoms) - lf + sum(
                cyc.mu ** (lf - l) for l in range(lf))),
            "split": 0, "merge": 0,
            "half_sweep": 0, "timeskew": 0, "residual_restrict": 0,
            "prolong_blend": 0, "small_restrict": 0,
            "small_prolong_blend": 0, "residual": 2}
    for l in range(lf):
        visits = cyc.nu0 * sum(cyc.mu ** (l - s) for s in range(l + 1))
        if R.timeskew_plan(geoms[l]):
            want["timeskew"] += visits * sum(-(-nu // T)
                                             for nu in (cyc.nu1, cyc.nu2))
        else:
            want["half_sweep"] += visits * 2 * (cyc.nu1 + cyc.nu2)
        want["split"] += visits * 4
        want["merge"] += visits * 2
        want["residual_restrict"] += visits
        want["prolong_blend"] += visits
    for gf in geoms[:-1]:
        small = tuple(gf.padded_shape) in SMALL_PAIR_FINE
        want["small_restrict" if small else "residual_restrict"] += 1
        want["small_prolong_blend" if small else "prolong_blend"] += 1
    return want


def phase_preset3d(torch):
    """The thesis' 3D presets through the CLI, in process, on "cuda":
    `--preset poisson3d` (129^3) and `--preset poisson3d-cuda` (257^3),
    FMG(2, 3000, 3000), relaxed down to 2^3.  error_linf < 50 h^2, finite
    residuals, exactly the launches of the schedule (`preset_launches`:
    the subtree kernel once per V-cycle, the half-sweeps on 128^3 only,
    the wavefront on 256^3 only, the transfer kernels on the pairs above
    the fused roots and, as rows 23 and 24, on the sub-lane pairs of the
    FMG f-cascade and upward leg) and no other kernel.  Each step timed
    eager and as one CUDA graph; at 129^3 also the A/B of the fused
    subtree: two steps eager from fresh levels with the hooks on and off
    (the levels then relaxed by the plan: the half-sweeps on 128^3, the
    whole-leg resident kernel below), the same solution bit for bit, and
    the plan with the 64^3-rooted V-cycles unfused and the roots below
    fused, its 64^3 level relaxed by the plan's kernel and by the
    half-sweeps (row 9, as ROADMAP queue 2 item 13's baseline was first
    measured), each eager and as one CUDA graph, bitwise the same too.
    Returns (129^3 launch counts, 257^3 launch counts, summaries)."""
    from pde_multigrid_tpu_torch import CycleConfig, MultigridSolver
    from pde_multigrid_tpu_torch import Poisson3D, SolverConfig
    from pde_multigrid_tpu_torch.__main__ import PRESETS
    from pde_multigrid_tpu_torch.__main__ import main as cli_main
    from pde_multigrid_tpu_torch.cycles import CycleProgram
    from pde_multigrid_tpu_torch.ops.cuda import relax as R
    from pde_multigrid_tpu_torch.ops.cuda.dispatch import CudaKernels

    all_counts, summaries = [], []
    for name in ("poisson3d", "poisson3d-cuda"):
        p = PRESETS[name]
        n = p["n"]
        cyc = CycleConfig("fmg", p["nu0"], p["nu1"], p["nu2"])
        solver = MultigridSolver(Poisson3D(), n, SolverConfig(cycle=cyc),
                                 device="cuda")
        want = preset_launches(solver, R.TIMESKEW_T)
        buf = io.StringIO()
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf), \
                contextlib.redirect_stderr(io.StringIO()):
            cli_main(["--preset", name, "--device", "cuda"])
        wall = time.perf_counter() - t0
        counts = read_counts()
        out = json.loads(buf.getvalue().strip().splitlines()[-1])
        h = 1.0 / (n - 1)
        tag = f"--preset {name}"
        log(f"{tag}: {len(solver.geoms)} levels "
            f"{[g.padded_shape[0] for g in solver.geoms]}, error_linf "
            f"{out['error_linf']!r} (limit 50 h^2 = {50 * h * h!r}; the "
            f"float64 FMG(2,100,100) exact-coarsest solve's "
            f"{F64_ERR.get(n)!r}), residual_l2 {out['residual_l2']!r}, "
            f"solve {out['wall_time_s']!r} s, command {wall!r} s, launches "
            f"{counts}")
        require(out["error_linf"] < 50 * h * h, f"{tag}: error_linf too "
                "large")
        require(all(x == x and abs(x) != float("inf")
                    for x in out["residual_history"]) and not out["diverged"],
                f"{tag}: non-finite residuals")
        path = "preset129" if n == 129 else "preset257"
        _check_counts(tag, path, {k: want[k] for k in PATHS[path]})
        require(all(counts.get(k, 0) == want[k] for k in want),
                f"{tag}: launches {counts}, the schedule implies {want}")
        all_counts.append(counts)
        summary = {"preset": name, "n": n, "nus": [cyc.nu0, cyc.nu1,
                                                   cyc.nu2],
                   "error_linf": out["error_linf"],
                   "f64_error_linf_fmg100_exact": F64_ERR.get(n),
                   "residual_l2": out["residual_l2"], "launches": want}
        levels = solver.fresh_levels()
        summary.update(time_step(torch, tag, solver, levels, 1, 1))
        if n == 129:
            # the A/B: the same steps with the hooks off (a tier without
            # the cycle has no fused plan), eager, each side from fresh
            # levels (time_ms: a warm-up step, then the timed one); the two
            # solutions must agree bit for bit
            geoms = solver.geoms
            off = CudaKernels(solver.problem, geoms, torch.float32)
            prog_off = CycleProgram(solver.problem, geoms, cyc, off,
                                    device=solver.device)
            lv_on, lv_off = solver.fresh_levels(), solver.fresh_levels()
            ms_on = time_ms(torch, lambda: solver.program.solve_step(lv_on),
                            1)
            ms_off = time_ms(torch, lambda: prog_off.solve_step(lv_off), 1)
            require(torch.equal(lv_on[0].v, lv_off[0].v),
                    f"{tag}: the fused and the unfused steps differ")
            summary["ab_eager_ms_per_step"] = {"fused": ms_on,
                                               "unfused": ms_off}
            log(f"{tag}: two steps from fresh levels with the fused hooks on "
                f"and off, bitwise the same solution; eager ms per step "
                f"{ms_on!r} fused, {ms_off!r} unfused")
            # the plan a redesign of the fused 64^3 level must beat: the
            # 64^3-rooted V-cycles unfused (the whole card's half-sweeps
            # on 64^3), the roots 32^3 and below fused; two steps from
            # fresh levels, bitwise the fused plan's, then as one graph
            alt = MultigridSolver(Poisson3D(), n, SolverConfig(cycle=cyc),
                                  device="cuda")
            l64 = [g.padded_shape[0] for g in geoms].index(64)
            alt.program.kernels._sub_v[l64] = None
            lv_alt = alt.fresh_levels()
            step = lambda: alt.program.solve_step(lv_alt)  # noqa: E731
            ms_alt = time_ms(torch, step, 1)
            require(torch.equal(lv_alt[0].v, lv_on[0].v),
                    f"{tag}: the 64^3-unfused plan changes the solution")
            graph_alt = device_ms(torch, step, 1)
            # the same with the 64^3 level relaxed by the half-sweeps (row
            # 9), the baseline's relax when it was first measured; the
            # plan's kernel there is the whole-leg resident kernel
            alt9 = MultigridSolver(Poisson3D(), n, SolverConfig(cycle=cyc),
                                   device="cuda")
            alt9.program.kernels._sub_v[l64] = None
            alt9.program.kernels._relax[l64] = R.make_split_relax(
                alt9.problem, geoms[l64])
            lv9 = alt9.fresh_levels()
            step9 = lambda: alt9.program.solve_step(lv9)  # noqa: E731
            ms9 = time_ms(torch, step9, 1)
            require(torch.equal(lv9[0].v, lv_on[0].v),
                    f"{tag}: the 64^3-unfused plan on row 9 changes the "
                    "solution")
            graph9 = device_ms(torch, step9, 1)
            summary["plan_64_unfused_ms_per_step"] = {
                "eager": ms_alt, "graph": graph_alt,
                "tier_64": alt.program.kernels.tiers[l64],
                "row9_eager": ms9, "row9_graph": graph9}
            log(f"{tag}: the 64^3-rooted V-cycles unfused, the roots below "
                f"fused: bitwise the same solution; 64^3 relaxed by "
                f"{alt.program.kernels.tiers[l64]}: {ms_alt!r} ms/step "
                f"eager, {graph_alt!r} as one CUDA graph; by the half-sweeps "
                f"(row 9): {ms9!r} eager, {graph9!r} graph (the fused plan "
                f"{summary['graph_ms_per_step']!r})")
        summaries.append(summary)
    return all_counts[0], all_counts[1], summaries


def phase_subtree_identity(torch):
    """129^3, FMG(2, 4, 4), coarsest="relax", then two V-cycles, on the
    card through the fused plan and with the hooks off: the same residual
    history and the same solution, bit for bit."""
    from pde_multigrid_tpu_torch import CycleConfig, MultigridSolver
    from pde_multigrid_tpu_torch import Poisson3D, SolverConfig
    from pde_multigrid_tpu_torch.cycles import CycleProgram
    from pde_multigrid_tpu_torch.ops.cuda import subtree as S
    from pde_multigrid_tpu_torch.ops.cuda.dispatch import CudaKernels

    cfg = SolverConfig(cycle=CycleConfig("fmg", 2, 4, 4), tol=0.0,
                       max_cycles=3)
    res = {}
    for hooks in (True, False):
        solver = MultigridSolver(Poisson3D(), 129, cfg, device="cuda")
        if not hooks:
            solver.program = CycleProgram(
                solver.problem, solver.geoms, cfg.cycle,
                CudaKernels(solver.problem, solver.geoms, torch.float32),
                device=solver.device)
        S.reset_launches()
        res[hooks] = solver.solve_to_tolerance()
        require((S.launches["subtree"] > 0) == hooks,
                f"hooks {hooks}: {S.launches['subtree']} subtree launches")
    on, off = res[True], res[False]
    log(f"identity 129^3 FMG(2,4,4) relax-coarsest: residual history fused "
        f"{on.residual_history!r}, unfused {off.residual_history!r}; "
        f"error_linf {on.error_linf!r} / {off.error_linf!r}")
    require(on.residual_history == off.residual_history
            and torch.equal(on.v, off.v),
            "the fused plan changes the 129^3 FMG(2,4,4) solve")
    return {"check": "fused == unfused, 129^3 FMG(2,4,4) relax coarsest",
            "residual_history": on.residual_history,
            "error_linf": on.error_linf}


# the sizes of the float32-against-float64 witness of the presets'
# schedule (`phase_rounding`); the float64 side takes the plain tier, some
# 1e7 PyTorch operations a size, and runs on the host CPU in a child
# process (one thread) beside the rest of the script, collected last
ROUNDING_N = (17, 33, 65)


def f64_preset_schedule(n: int) -> None:
    """Print, as one JSON line, the float64 solve of the presets'
    schedule, FMG(2, 3000, 3000) relaxed to 2^3, at n^3 on the host CPU
    (the plain tier, one thread): its error_linf, solution and seconds.
    `start_rounding_witness` runs it in a child process."""
    import torch

    from pde_multigrid_tpu_torch import CycleConfig, MultigridSolver
    from pde_multigrid_tpu_torch import Poisson3D, SolverConfig

    torch.set_num_threads(1)
    nu = SUBTREE_LONG
    cfg = SolverConfig(cycle=CycleConfig("fmg", 2, nu, nu), dtype="float64")
    t0 = time.perf_counter()
    res = MultigridSolver(Poisson3D(), n, cfg, device="cpu").solve()
    print(json.dumps({"error_linf": res.error_linf,
                      "shape": list(res.v.shape),
                      "v": res.v.flatten().tolist(),
                      "seconds": time.perf_counter() - t0}))


def start_rounding_witness() -> dict:
    """One child process per size of ROUNDING_N, each running
    `f64_preset_schedule`; `phase_rounding` collects them."""
    return {n: subprocess.Popen(
        [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]);"
         " import chip_smoke; chip_smoke.f64_preset_schedule(int(sys.argv[2]))",
         HERE, str(n)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=HERE)
        for n in ROUNDING_N}


def phase_rounding(torch, procs) -> dict:
    """The presets' schedule, FMG(2, 3000, 3000) relaxed to 2^3, at the
    sizes ROUNDING_N: float32 on the card (the fused plan: every V-cycle
    one subtree launch) against float64 (the plain tier on the host CPU,
    from the children of `start_rounding_witness`).  Logs each side's
    error_linf and max|v32 - v64| on the interior: the float32 side's
    rounding, which the presets' error_linf carries at 129^3 and 257^3.
    Gate: both solves finite and under 50 h^2."""
    from pde_multigrid_tpu_torch import CycleConfig, MultigridSolver
    from pde_multigrid_tpu_torch import Poisson3D, SolverConfig

    nu = SUBTREE_LONG
    out = {"check": "float32 (card) vs float64 (plain tier), FMG(2,3000,"
                    "3000) relaxed to 2^3"}
    for n in ROUNDING_N:
        text, err = procs[n].communicate(timeout=600)
        require(procs[n].returncode == 0,
                f"float64 {n}^3 child failed: {err[-2000:]}")
        r64 = json.loads(text.strip().splitlines()[-1])
        solver = MultigridSolver(Poisson3D(), n, SolverConfig(
            cycle=CycleConfig("fmg", 2, nu, nu)), device="cuda")
        require(all(fn is not None for fn in solver.program.kernels._sub_v),
                f"{n}^3: not every root fused")
        res = solver.solve()
        v64 = torch.tensor(r64["v"], dtype=torch.float64,
                           device="cuda").reshape(r64["shape"])
        m = solver.fresh_levels()[0].aux["m_int"]
        dv = float(torch.max(torch.abs((res.v.to(torch.float64) - v64) * m)))
        h = 1.0 / (n - 1)
        row = {"error_linf_f32": res.error_linf,
               "error_linf_f64": r64["error_linf"], "max_abs_dv": dv,
               "f64_seconds": r64["seconds"]}
        out[f"{n}^3"] = row
        log(f"rounding {n}^3 FMG(2,{nu},{nu}) relaxed to 2^3: error_linf "
            f"float32 {res.error_linf!r}, float64 {r64['error_linf']!r} "
            f"(host CPU, {r64['seconds']!r} s), max|v32 - v64| {dv!r}")
        require(dv == dv and max(res.error_linf, r64["error_linf"])
                < 50 * h * h, f"rounding {n}^3: {row}")
    return out


# the sharded solve's row: 257^3 FMG(2, 100, 100), exact coarsest, f32
SHARD_N = 257
SHARD_NUS = (2, 100, 100)
# the sharded FAS row (ROADMAP queue 3 F3): small, so that over 2 and 4
# ranks the coarse levels are replicated (4^3 and 2^3; 8^3 too over 4) and
# the injection into them gathers the fine level
SHARD_FAS_N = 65
SHARD_FAS_NUS = (2, 20, 20)
SHARD_RANKS = (2, 4)
# phase 5's unsharded 257^3 f32 solve: (summary, solution v)
UNSHARDED = {}


def phase_kernels_shard(torch):
    """The per-shard kernels against their plain versions on the card,
    bitwise.  The time-skew chunk (`relax.timeskew_shard`, timeskew.cu's
    shard mode) on every shard of the 256^3 level split over 1, 2 and 4
    ranks at t = 1, 2, 4 and 2T + 1 (random slabs, the raw halo planes
    included) and on odd-tiled small levels; the shards' owned windows composed equal
    the single-chip wavefront's t sweeps; the masked block
    (`masked_block.masked_block`) on the extended blocks of every shard
    of the 257^3 row's 128^3 level and of the FAS 65^3 row's sharded
    levels over 1, 2 and 4 ranks at t = 1 and T with the shards' own
    masks, the whole block, in the form `masked_block.form` plans and in
    the chunk form wherever its layout holds the block, a t = T chunk of
    both forms timed at each block shape (`masked_ab`), the one-colour
    form also at the one-rank 128^3 block.  One chunk of each kernel at
    the one-rank main path's shapes (t = 4) timed beside its plain
    version.  Returns the two records."""
    from types import SimpleNamespace

    import numpy as np

    from pde_multigrid_tpu_torch.grid import build_geometries
    from pde_multigrid_tpu_torch.models import Poisson3D
    from pde_multigrid_tpu_torch.ops.cuda import masked_block as MB
    from pde_multigrid_tpu_torch.ops.cuda import relax as R
    from pde_multigrid_tpu_torch.parallel import halo
    from pde_multigrid_tpu_torch.parallel.mesh import level_sharding

    dev = torch.device("cuda")
    prob = Poisson3D()
    rng = np.random.default_rng(2029)
    out = {}

    def rand(shape):
        return torch.tensor(rng.standard_normal(shape).astype(np.float32),
                            device=dev)

    def geom(shape):
        return build_geometries(shape, prob.domain, 1, wrap=True)[0]

    def ts_check(g, n, t):
        """Every shard of `g` over n ranks, t sweeps: kernel == plain on
        the owned window; returns the max error."""
        X, Y, Z = g.padded_shape
        x_loc = X // n
        XE = x_loc + 4 * t
        b, fr, fb = (rand((XE, Y // 2, Z)) for _ in range(3))
        err = 0.0
        for i in range(n):
            g0 = i * x_loc - 2 * t
            bo, ro = (torch.empty((x_loc, Y // 2, Z), device=dev)
                      for _ in range(2))
            R.timeskew_shard(b, fr, fb, g0, t, prob, g, x_loc, bo, ro)
            pr, pb = R.timeskew_shard_plain(b, fr, fb, g0, t, prob, g, x_loc)
            w = slice(2 * t, 2 * t + x_loc)
            err = max(err, _max_err(torch, ro, pr[w]),
                      _max_err(torch, bo, pb[w]))
            require(torch.equal(ro, pr[w]) and torch.equal(bo, pb[w]),
                    f"timeskew_shard {g.padded_shape} n={n} shard {i} t={t}"
                    f" not bitwise: max diff {err!r}")
        return err

    g256 = geom((257,) * 3)
    err = 0.0
    # t = 2T + 1: a launch of T and a remainder launch over a wider window
    long_t = 2 * R.TIMESKEW_T + 1
    for n in (1, 2, 4):
        for t in (1, 2, 4, long_t):
            err = max(err, ts_check(g256, n, t))
    small = (((17, 27, 39), 2), ((33, 131, 101), 4), ((33, 33, 33), 8))
    for shape, n in small:
        for t in (1, 2):
            ts_check(geom(shape), n, t)
    # composed: the owned windows of every shard == the single-chip
    # wavefront's t sweeps on the whole level (plane 0 of b zero: the
    # single-chip kernel never reads it, the shard chunk reads its halos)
    X, Y, Z = g256.padded_shape
    b, fr, fb = (rand((X, Y // 2, Z)) for _ in range(3))
    b[0] = 0.0
    for n in (2, 4):
        x_loc, t = X // n, 4
        want = R.timeskew_relax_halves(b, fr, fb, t, prob, g256)
        got_r, got_b = torch.empty_like(b), torch.empty_like(b)
        for i in range(n):
            idx = (i * x_loc - 2 * t + torch.arange(x_loc + 4 * t,
                                                    device=dev)) % X
            sl = slice(i * x_loc, (i + 1) * x_loc)
            R.timeskew_shard(b[idx], fr[idx], fb[idx], i * x_loc - 2 * t, t,
                             prob, g256, x_loc, got_b[sl], got_r[sl])
        require(torch.equal(got_r, want[0]) and torch.equal(got_b, want[1]),
                f"timeskew_shard composed over {n} ranks differs from the "
                "single-chip wavefront")
    # timed: the one-rank main path's chunk, t = 4 sweeps with r written
    t, x_loc = 4, X
    XE = x_loc + 4 * t
    b, fr, fb = (rand((XE, Y // 2, Z)) for _ in range(3))
    bo, ro = (torch.empty((x_loc, Y // 2, Z), device=dev) for _ in range(2))
    tm = paired_times(
        torch,
        lambda: R.timeskew_shard(b, fr, fb, -2 * t, t, prob, g256, x_loc, bo,
                                 ro),
        lambda: R.timeskew_shard_plain(b, fr, fb, -2 * t, t, prob, g256,
                                       x_loc), 1)
    # the chunk reads b, fr and fb once and writes r and b once; 13
    # float32 operations per updated owned point and sweep (the one rank
    # owns x = 0 ... X - 1), as the other rows
    out["timeskew_shard"] = {"max_abs_err": err, "ms": tm["ms"],
                             "plain_ms": tm["plain_ms"],
                             **bound(3 * b.nbytes + 2 * bo.nbytes,
                                     13 * t * updated_points((x_loc, Y, Z))),
                             "library_ms": None}
    log(f"kernel timeskew_shard: bitwise against its plain version on every "
        f"shard of 256^3 over 1, 2, 4 ranks at t = 1, 2, 4, {long_t}, on "
        f"{small}, and "
        f"composed over 2 and 4 ranks against the single-chip wavefront; "
        f"one t = {t} chunk ({XE} slab planes, "
        f"{len(R.shard_windows(t, x_loc))} "
        f"launches): device {tm['ms']!r} ms vs plain {tm['plain_ms']!r} ms "
        f"(bound {out['timeskew_shard']['bound_ms']!r} ms by "
        f"{out['timeskew_shard']['bound_by']}); eager {tm['eager_ms']!r} ms")

    # the masked block: the blocks of every shard of the 257^3 row's 128^3
    # level and of the FAS 65^3 row's sharded levels over 1, 2, 4 ranks
    # (x_loc + 4T planes, T = min(4, x_loc // 2)), t = 1 and T sweeps, the
    # whole block bitwise in the planned form and in the chunk form where
    # its layout holds the block; each block's t = T chunk timed in both
    # forms (the A/B `masked_block.form` rests on)
    sms = R._sm_count(0)
    err, blocks = 0.0, []
    for size, sizes in ((129, (128,)), (65, (64, 32, 16, 8, 4, 2))):
        for lvl in sizes:
            g = geom((lvl + 1,) * 3)
            X, Y, Z = g.padded_shape
            for n in (1, 2, 4):
                if not level_sharding(SimpleNamespace(n=n), g):
                    continue  # replicated: the single-device tier's
                x_loc = X // n
                T = min(4, x_loc // 2)
                shape = (x_loc + 4 * T, Y, Z)
                v, f = rand(shape), rand(shape)
                lay = MB.chunk_layout(*shape, sms)
                for i in range(n):
                    pre, mr, mb = halo.coords_and_masks(
                        prob, g, shape, i * x_loc - 2 * T, torch.float32, dev)
                    for t in sorted({1, T}):
                        p = MB.masked_block_plain(v, f, pre, mr, mb, t, prob,
                                                  g)
                        k = MB.masked_block(v.clone(), f, pre, mr, mb, t,
                                            prob, g)
                        outs = [k]
                        if lay is not None:  # the chunk form, planned or not
                            kc = v.clone()
                            MB._chunk(kc, f, mr, mb, t, g,
                                      MB._chunk_launch(*shape, sms))
                            outs.append(kc)
                        for o in outs:
                            err = max(err, _max_err(torch, o, p))
                            require(torch.equal(o, p),
                                    f"masked_block {shape} n={n} shard {i} "
                                    f"t={t} not bitwise: max diff {err!r}")
                vk = v.clone()
                MASKED_AB[str(shape)] = {
                    "T": T, "form": MB.form(shape, sms), "layout": lay,
                    "chunk_ms": None if lay is None else device_ms(
                        torch, lambda: MB._chunk(
                            vk, f, mr, mb, T, g, MB._chunk_launch(
                                *shape, sms)), 5),
                    "half_sweeps_ms": device_ms(torch, lambda: MB.
                                                _half_sweeps(vk, f, mr, mb,
                                                             T, g), 5)}
                blocks.append(shape)
    # the one-colour form (planned where the chunk form loses) also on the
    # one-rank 128^3 block, bitwise
    g128 = geom((129,) * 3)
    X, Y, Z = g128.padded_shape
    x_loc, t = X, 4
    shape = (x_loc + 4 * t, Y, Z)
    v, f = rand(shape), rand(shape)
    pre, mr, mb = halo.coords_and_masks(prob, g128, shape, -2 * t,
                                        torch.float32, dev)
    p = MB.masked_block_plain(v, f, pre, mr, mb, t, prob, g128)
    k = v.clone()
    MB._half_sweeps(k, f, mr, mb, t, g128)
    require(torch.equal(k, p), "masked_block's one-colour form (128^3, t = 4)"
            " not bitwise")
    tm = paired_times(
        torch, lambda: MB.masked_block(v, f, pre, mr, mb, t, prob, g128),
        lambda: MB.masked_block_plain(v, f, pre, mr, mb, t, prob, g128), 1)
    # reads v, f and both masks once, writes v once; 13 operations per
    # updated owned point and sweep (the one rank owns x = 0 ... X - 1)
    out["masked_block"] = {"max_abs_err": err, "ms": tm["ms"],
                           "plain_ms": tm["plain_ms"],
                           **bound(5 * v.nbytes,
                                   13 * t * updated_points((x_loc, Y, Z))),
                           "library_ms": None}
    log(f"kernel masked_block: bitwise against its plain version on every "
        f"shard's extended block {blocks} (the 257^3 row's 128^3 level and "
        f"the FAS 65^3 row's levels over 1, 2, 4 ranks) at t = 1 and T, "
        f"in the form `masked_block.form` gives each; the one-colour form "
        f"bitwise at {shape}; one "
        f"t = {t} chunk ({shape}, "
        f"{MB.chunk_launches(shape, t, sms)} launch): device "
        f"{tm['ms']!r} ms vs plain {tm['plain_ms']!r} ms (bound "
        f"{out['masked_block']['bound_ms']!r} ms by "
        f"{out['masked_block']['bound_by']}), the one-colour form's "
        f"{2 * t} launches {MASKED_AB[str(shape)]['half_sweeps_ms']!r} ms; "
        f"eager {tm['eager_ms']!r} ms")
    by_block = {k: (a["T"], a["form"], a["chunk_ms"], a["half_sweeps_ms"])
                for k, a in MASKED_AB.items()}
    log(f"kernel masked_block: a t = T chunk by block (T, the planned "
        f"form, the chunk form's ms, the one-colour form's ms): {by_block}")
    torch.cuda.synchronize()
    return out


def sharded_launches(solver) -> dict:
    """The kernel launches one FMG step of a sharded solver implies: level
    l is visited nu0 (l + 1) times, two relax legs a visit; a leg of nu
    sweeps runs nu // T chunks of T sweeps and one of nu % T; on a
    time-skew level each chunk of t sweeps is ceil(t / 2) launches and the
    leg splits v's black half and f and merges once; on a masked-block
    level each chunk is `masked_block.chunk_launches` of its block (one
    where `masked_block.form` plans the chunk form, else 2t); on a
    split2d level each chunk is one launch (a level that runs whole legs
    on chip: one launch a leg) and
    the leg splits v and f and merges once; a replicated 3D
    level ("whole") relaxes by the single-device plan, here one resident
    kernel launch a leg.  The transfers, residuals, FAS's injection and
    the exact coarse solve launch no kernel."""
    from pde_multigrid_tpu_torch.ops.cuda import masked_block as MB
    from pde_multigrid_tpu_torch.ops.cuda import relax as R

    cyc = solver.config.cycle
    kern = solver.program.kernels
    want = {}

    def add(name, k):
        want[name] = want.get(name, 0) + k

    for l, engine in enumerate(kern.plan):
        if engine is None:
            continue
        if engine == "whole":
            tier = kern._whole.tiers[l]
            require(tier in ("merged_resident", "resident3d"),
                    f"replicated level {l}: tier {tier}")
            add(tier, 2 * cyc.nu0 * (l + 1))
            continue
        require(engine in ("timeskew", "masked-block", "split2d"),
                f"level {l}: engine {engine}, not a sharded one")
        T = kern._relax[l].T
        legs = 2 * cyc.nu0 * (l + 1)
        for nu in (cyc.nu1, cyc.nu2):
            ts = [T] * (nu // T) + [nu % T] * (nu % T > 0)
            if engine == "timeskew":
                add("timeskew_shard",
                    legs // 2 * sum(-(-t // R.TIMESKEW_T) for t in ts))
                add("split", legs // 2 * 2)
                add("merge", legs // 2)
            elif engine == "split2d":
                if kern._relax[l].leg:
                    add("color_slab2d_leg", legs // 2 * (nu > 0))
                else:
                    add("color_slab2d_shard", legs // 2 * len(ts))
                add("split2d", legs // 2 * 2)
                add("merge2d", legs // 2)
            else:
                X, Y, Z = kern.geoms[l].padded_shape
                shape = (X // kern.mesh.n + 4 * T, Y, Z)
                add("masked_block", legs // 2 * sum(
                    MB.chunk_launches(shape, t, R._sm_count(0)) for t in ts))
    return want


def _shard_cfg():
    from pde_multigrid_tpu_torch import CycleConfig, SolverConfig

    return SolverConfig(cycle=CycleConfig("fmg", *SHARD_NUS,
                                          coarsest="exact"))


def _sha(v) -> str:
    return hashlib.sha256(v.detach().cpu().numpy().tobytes()).hexdigest()


def _sha_logical(v, n: int) -> str:
    """The SHA-256 of `v`'s first n points on every axis: the logical
    level (its padded rows differ with the number of ranks)."""
    return _sha(v[(slice(0, n),) * v.dim()].contiguous())


def phase_sharded(torch):
    """257^3 FMG(2, 100, 100), exact coarsest, f32, `--mesh 1` through the
    CLI in process (a one-rank NCCL group made in process): error_linf <
    50 h^2, finite residuals, exactly `sharded_launches` (the time-skew
    chunk on 256^3, the masked block on 128^3, 64^3 solved exactly) and no
    other kernel; ms per step eager and as one CUDA graph (a one-rank
    exchange is a local copy, so the step captures); the solution against
    phase 5's unsharded 257^3 f32 solve within JAX's sharded-vs-single
    tolerance (rtol 2e-5, atol 2e-6; error_linf within 1e-6).  Returns
    (launch counts, summary, the solution's SHA-256)."""
    from pde_multigrid_tpu_torch import MultigridSolver, Poisson3D
    from pde_multigrid_tpu_torch.__main__ import main as cli_main
    from pde_multigrid_tpu_torch.parallel.mesh import make_mesh

    n = SHARD_N
    args = ["--n", str(n), "--nu0", str(SHARD_NUS[0]), "--nu1",
            str(SHARD_NUS[1]), "--nu2", str(SHARD_NUS[2]), "--coarsest",
            "exact", "--device", "cuda", "--mesh", "1"]
    solver = MultigridSolver(Poisson3D(), n, _shard_cfg(), device="cuda",
                             mesh=make_mesh(1))
    kern = solver.program.kernels
    require(kern.plan == ["timeskew", "masked-block", None],
            f"sharded {n}^3 plan {kern.plan}")
    want = sharded_launches(solver)
    buf, err = io.StringIO(), io.StringIO()
    torch.cuda.synchronize()
    reset_counts()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(err):
        res = cli_main(args)
    counts = read_counts()
    out = json.loads(buf.getvalue().strip().splitlines()[-1])
    h = 1.0 / (n - 1)
    tag = f"sharded {n}^3 --mesh 1"
    ts = [getattr(fn, "T", None) for fn in kern._relax]
    log(f"{tag}: plan {kern.plan}, T {ts}, "
        f"error_linf {out['error_linf']!r} (limit 50 h^2 = {50 * h * h!r}), "
        f"residual_l2 {out['residual_l2']!r}, launches {counts}, the "
        f"schedule's {want}; {err.getvalue().strip().splitlines()[-1]}")
    _check_solve(torch, tag, res, solver, 50 * h * h, "sharded257", want)
    require(out["error_linf"] == res.error_linf and not out["diverged"],
            f"{tag}: the CLI's summary and its result differ")
    sum_un, v_un = UNSHARDED["f32"]
    dv = _max_err(torch, res.v, v_un)
    derr = abs(res.error_linf - sum_un["error_linf"])
    ok = bool(torch.all(torch.abs(res.v - v_un)
                        <= 2e-6 + 2e-5 * torch.abs(v_un)))
    log(f"{tag}: max|v - v_unsharded| {dv!r}, |error_linf - unsharded's| "
        f"{derr!r} (unsharded {sum_un['error_linf']!r})")
    require(ok and derr < 1e-6, f"{tag}: not within JAX's tolerance of the "
            "unsharded solve")
    summary = {"sharded": n, "ranks": 1, "plan": kern.plan,
               "error_linf": res.error_linf, "residual_l2": res.residual_l2,
               "launches": want, "max_abs_dv_unsharded": dv,
               "error_linf_diff_unsharded": derr,
               "unsharded_graph_ms_per_step": sum_un["graph_ms_per_step"]}
    summary.update(time_step(torch, tag, solver, solver.fresh_levels(), 3, 1))
    return counts, summary, _sha_logical(res.v, n)


def _sharded_row(row: str):
    """(problem, points per axis, config, error_linf limit) of the rank
    solves of a sharded row: "poisson3d", the 257^3 FMG(2, 100, 100) row,
    "poisson3d-fas", the FAS row SHARD_FAS_N^3 FMG(2, 20, 20) relaxed to
    2^3, or "lyapunov2d", 4097^2 at the reduced schedule
    SHARD2D_RANK_NUS."""
    from pde_multigrid_tpu_torch import (
        CycleConfig,
        Lyapunov2D,
        Poisson3D,
        SolverConfig,
    )

    if row == "poisson3d":
        return Poisson3D(), SHARD_N, _shard_cfg(), 50.0 / (SHARD_N - 1) ** 2
    if row == "poisson3d-fas":
        cfg = SolverConfig(cycle=CycleConfig("fmg", *SHARD_FAS_NUS,
                                             scheme="fas", coarsest="relax"))
        return (Poisson3D(), SHARD_FAS_N, cfg,
                50.0 / (SHARD_FAS_N - 1) ** 2)
    return (Lyapunov2D(), LYAP_N, _lyap_cfg(SHARD2D_RANK_NUS),
            max(10.0 / (LYAP_N - 1), 5e-5))


def sharded_rank(addr: str, n: int, rank: int, row: str) -> None:
    """One rank of a sharded row's solve (`_sharded_row`) over `n` ranks on
    cuda:0 (gloo): prints one JSON line with its launches, the schedule's,
    its error_linf, the eager ms of a second step and, on rank 0, the
    logical solution's SHA-256.  `phase_sharded_ranks` starts it."""
    import torch
    import torch.distributed as dist

    from pde_multigrid_tpu_torch import MultigridSolver
    from pde_multigrid_tpu_torch.parallel.mesh import make_mesh

    prob, size, cfg, _ = _sharded_row(row)
    dist.init_process_group("gloo", init_method=f"tcp://{addr}",
                            world_size=n, rank=rank)
    solver = MultigridSolver(prob, size, cfg, device="cuda",
                             mesh=make_mesh(n, "gloo"))
    want = sharded_launches(solver)
    levels = solver.fresh_levels()
    torch.cuda.synchronize()
    reset_counts()
    res = solver.solve(levels)
    counts = read_counts()
    levels = solver.fresh_levels()
    torch.cuda.synchronize()
    dist.barrier()
    t0 = time.perf_counter()
    solver.program.solve_step(levels)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    print(json.dumps({"rank": rank, "n": n, "counts": counts, "want": want,
                      "plan": solver.program.kernels.plan,
                      "error_linf": res.error_linf, "eager_ms": ms,
                      "sha": (_sha_logical(res.v, size) if rank == 0
                              else None)}))
    dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def phase_sharded_ranks(torch, sha1: str, row: str = "poisson3d") -> dict:
    """A sharded row's solve (`_sharded_row`) over 2 and 4 ranks sharing
    cuda:0, one child process a rank over gloo (halos staged through the
    host), both groups at once: every rank's launches exactly
    `sharded_launches`, and no other kernel, error_linf under the row's
    gate, rank 0's logical solution bitwise the one-rank solve's of the
    same schedule (its SHA-256 `sha1`).  Eager ms of a step per rank: a
    check of exactness, not of speed."""
    _, size, cfg, limit = _sharded_row(row)
    nus = (cfg.cycle.nu0, cfg.cycle.nu1, cfg.cycle.nu2)
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo")
    procs = {}
    for n in SHARD_RANKS:
        addr = f"localhost:{_free_port()}"
        procs[n] = [subprocess.Popen(
            [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]);"
             " import chip_smoke; chip_smoke.sharded_rank(sys.argv[2], "
             "int(sys.argv[3]), int(sys.argv[4]), sys.argv[5])", HERE, addr,
             str(n), str(r), row], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, cwd=HERE, env=env)
            for r in range(n)]
    out = {}
    try:
        for n, group in procs.items():
            rows = []
            for r, p in enumerate(group):
                text, err = p.communicate(timeout=600)
                require(p.returncode == 0,
                        f"sharded {row} rank {r} of {n} failed: "
                        f"{err[-3000:]}")
                rows.append(json.loads(text.strip().splitlines()[-1]))
            for rec in rows:
                tag = f"sharded {row} {size} rank {rec['rank']} of {n}"
                c = rec["counts"]
                require(all(c.get(k, 0) == v for k, v in rec["want"].items())
                        and not [k for k in KERNELS if c.get(k, 0)
                                 and k not in rec["want"]],
                        f"{tag}: launches {c}, the schedule implies "
                        f"{rec['want']}")
                require(rec["error_linf"] < limit,
                        f"{tag}: error_linf {rec['error_linf']!r}")
            require(rows[0]["sha"] == sha1, f"sharded {row} over {n} ranks: "
                    "rank 0's solution differs from the one-rank solve's")
            out[f"{n}_ranks"] = {"nus": nus, "eager_ms_per_step":
                                 [rec["eager_ms"] for rec in rows],
                                 "error_linf": rows[0]["error_linf"],
                                 "launches": rows[0]["want"],
                                 "plan": rows[0]["plan"]}
            log(f"sharded {row} {size} FMG{nus} over {n} ranks on cuda:0 "
                f"(gloo): plan {rows[0]['plan']}, every rank's launches the "
                f"schedule's {rows[0]['want']}, rank 0's logical solution "
                f"bitwise the one-rank solve's, error_linf "
                f"{rows[0]['error_linf']!r}, eager ms per step by rank "
                f"{[rec['eager_ms'] for rec in rows]!r}")
    finally:
        for group in procs.values():
            for p in group:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    return out


def phase_sharded_fas(torch):
    """The sharded FAS row (ROADMAP queue 3 F3): SHARD_FAS_N^3 FMG(2, 20,
    20), scheme="fas", coarsest relaxed, f32, `mesh=make_mesh(1)` in
    process (every level split, so the masked block relaxes all of them):
    error_linf < 50 h^2, exactly `sharded_launches` and no other kernel;
    then over 2 and 4 gloo ranks (`phase_sharded_ranks`), where the
    replicated coarse levels relax by the resident kernel and the FAS
    injection into them gathers the fine level: every rank's launches,
    rank 0's logical solution bitwise the one-rank solve's.  Returns
    (launch counts, summary)."""
    from pde_multigrid_tpu_torch import MultigridSolver
    from pde_multigrid_tpu_torch.parallel.mesh import make_mesh

    prob, n, cfg, limit = _sharded_row("poisson3d-fas")
    solver = MultigridSolver(prob, n, cfg, device="cuda", mesh=make_mesh(1))
    kern = solver.program.kernels
    want = sharded_launches(solver)
    torch.cuda.synchronize()
    reset_counts()
    res = solver.solve()
    counts = read_counts()
    tag = f"sharded fas {n}^3 --mesh 1"
    log(f"{tag}: plan {kern.plan}, error_linf {res.error_linf!r} (limit "
        f"{limit!r}), launches {counts}, the schedule's {want}")
    _check_solve(torch, tag, res, solver, limit, "sharded_fas", want)
    summary = {"sharded": n, "scheme": "fas", "nus": list(SHARD_FAS_NUS),
               "ranks": 1, "plan": kern.plan, "error_linf": res.error_linf,
               "launches": want}
    summary["ranks_2_4"] = phase_sharded_ranks(
        torch, _sha_logical(res.v, n), "poisson3d-fas")
    return counts, summary


# the sharded 2D Lyapunov row: the path's schedule on one rank, a reduced
# one over the gloo ranks (each halo a host round; ~14 000 chunks a step
# at FMG(2, 500, 500))
SHARD2D_RANK_NUS = (2, 20, 20)
# row 17 on the one-rank path, device ms (printed with the summaries;
# ROADMAP queue 2 items 27 and 44): the 4097^2 t = 4 chunk beside the 8
# half-sweeps it replaces, and by level the t = 4 chunk on ext halves,
# with the halo copies, in the one-rank form, and the 500-sweep leg
SHARD2D_AB = {}
# the leg lengths the whole-leg form is held bitwise at, and the levels:
# the path's (257^2 ... 65^2) and the smaller clusters and one CTA below
SHARD2D_LEGS = (1, 2, 3, 4, 5, 7, 9, 100, 500)
SHARD2D_LEG_LEVELS = (257, 129, 65, 33, 17, 9)
# float32 operations of one Lyapunov point's coefficients (lyap_coef:
# two clamped coordinates 8, k1 and k2 6, the denominator 4, one
# division, ae, as, af 5)
LYAP_COEF_OPS = 24


def slab_bound(ins, outs, geom, g0: int, x_loc: int, t: int) -> dict:
    """`bound` of t sweeps on a shard's x_loc rows from global row g0: the
    inputs (r, b and, for the form with f, fr, fb) read once, the outputs
    written once; per interior point of either colour (global rows 1 ..
    nx - 2, columns 1 .. ny - 2) its coefficients (LYAP_COEF_OPS) and f a_f
    once, and an update of two products and two sums (one sum less
    without f)."""
    nx, ny = geom.shape
    rows = max(0, min(g0 + x_loc, nx - 1) - max(g0, 1))
    pts = rows * (ny - 2)
    with_f = len(ins) > 2
    return bound(sum(a.nbytes for a in (*ins, *outs)),
                 (LYAP_COEF_OPS + with_f + (3 + with_f) * t) * pts)


def phase_kernels_shard2d(torch):
    """The per-shard colour slab (color_slab2d_shard.cu) against its plain
    version on the card, bitwise, in each form the path takes: the chunk
    on ext halves (`relax2d.color_slab2d_shard`) on every shard of 4097^2
    over 1, 2 and 4 ranks (the port's padded rows: 4097, 4098, 4100) at
    t = 1-4 (the engine's T = 4 chunks and its remainder chunks) on
    random ext halves of x_loc + 2t rows; its one-rank form (rows past
    x_loc read as 0, `one_rank=True`) on every relaxed level 4097^2 ...
    65^2 at t = 1-4 (the kernel's two forms: 1024 threads a CTA where
    512-thread tiles take more than one wave, 512 below); the whole-leg
    form (`relax2d.color_slab2d_leg`) on SHARD2D_LEG_LEVELS over legs of
    SHARD2D_LEGS sweeps (clusters of 16, 15, 9, 4, 2 CTAs and one CTA).
    Timed: the 4097^2 one-rank t = 4 chunk beside its plain version
    (P, K, K, P); the 257^2 500-sweep leg beside its plain version; by
    level the t = 4 chunk on ext halves, with the engine's two halo copies
    before it, and in the one-rank form, and the 500-sweep leg beside 125
    one-rank chunks.  Returns the records."""
    from pde_multigrid_tpu_torch.grid import build_geometries
    from pde_multigrid_tpu_torch.models import Lyapunov2D
    from pde_multigrid_tpu_torch.ops.cuda import relax2d as R2

    dev = torch.device("cuda")
    prob = Lyapunov2D()
    gen = torch.Generator(device=dev).manual_seed(2031)
    n = LYAP_N
    Y2 = (n + 1) // 2
    src = [torch.randn((n + 3 + 8, Y2), generator=gen, device=dev)
           for _ in range(4)]

    def same(out, want, what):
        e = max(_max_err(torch, o, w) for o, w in zip(out, want))
        require(all(torch.equal(o, w) for o, w in zip(out, want)),
                f"{what}: not bitwise, max diff {e!r}")
        return e

    err, checked = 0.0, 0
    for ranks in (1, 2, 4):
        g = build_geometries((n, n), prob.domain, 1, pad_axis0_to=ranks)[0]
        x_loc = g.padded_shape[0] // ranks
        for t in (1, 2, 3, 4):
            ins = [a[:x_loc + 2 * t] for a in src]
            for i in range(ranks):
                out = tuple(torch.empty((x_loc, Y2), device=dev)
                            for _ in range(2))
                R2.color_slab2d_shard(*ins, i * x_loc, t, prob, g, x_loc,
                                      out)
                want = R2.color_slab2d_shard_plain(*ins, i * x_loc, t, prob,
                                                   g, x_loc)
                err = max(err, same(out, want, f"color_slab2d_shard {n}^2 "
                                    f"over {ranks} ranks, shard {i} (g0 "
                                    f"{i * x_loc}), t = {t}"))
                checked += 1
    levels = (4097, 2049, 1025, 513, 257, 129, 65)
    geoms, own = {}, {}
    leg_err, legs_checked, forms = 0.0, 0, set()
    for m in (*levels, *SHARD2D_LEG_LEVELS[3:]):
        gm = geoms[m] = build_geometries((m, m), prob.domain, 1)[0]
        y2 = (m + 1) // 2
        own[m] = [a[:m, :y2].contiguous() for a in src]
        for t in (1, 2, 3, 4) if m in levels else ():
            want = R2.color_slab2d_shard_plain(*own[m], 0, t, prob, gm, m)
            out = tuple(torch.empty((m, y2), device=dev) for _ in range(2))
            R2.color_slab2d_shard(*own[m], 0, t, prob, gm, m, out,
                                  one_rank=True)
            forms.add(R2.slab_tile(m, y2, t)[4])
            err = max(err, same(out, want, f"color_slab2d_shard one-rank "
                                f"form {m}^2, t = {t}"))
            checked += 1
        if m not in SHARD2D_LEG_LEVELS:
            continue
        for ns in SHARD2D_LEGS:
            want = R2.color_slab2d_shard_plain(*own[m], 0, ns, prob, gm, m)
            out = tuple(torch.empty((m, y2), device=dev) for _ in range(2))
            R2.color_slab2d_leg(*own[m], ns, prob, gm, out)
            leg_err = max(leg_err, same(
                out, want, f"color_slab2d_leg {m}^2 "
                f"({R2.leg_layout(gm)}), {ns} sweeps"))
            legs_checked += 1
    require(forms == set(R2.SLAB_POINTS), f"the chunk's forms {forms}")
    require([m for m in levels if R2.leg_layout(geoms[m])] == [257, 129, 65],
            "the whole-leg form's levels")
    require([R2.leg_layout(geoms[m])[2] for m in SHARD2D_LEG_LEVELS]
            == [16, 15, 9, 4, 2, 1], "the whole-leg form's clusters")

    # the records: the path's forms, a t = 4 chunk at 4097^2 (one-rank)
    # and a 500-sweep leg at 257^2
    g, t, x_loc = geoms[n], 4, n
    out = tuple(torch.empty((x_loc, Y2), device=dev) for _ in range(2))
    tm = paired_times(
        torch,
        lambda: R2.color_slab2d_shard(*own[n], 0, t, prob, g, x_loc, out,
                                      one_rank=True),
        lambda: R2.color_slab2d_shard_plain(*own[n], 0, t, prob, g, x_loc),
        1)
    rec = {"max_abs_err": err, "ms": tm["ms"], "plain_ms": tm["plain_ms"],
           **slab_bound(own[n], out, g, 0, x_loc, t), "library_ms": None}
    m, ns = 257, 500
    out_l = tuple(torch.empty((m, (m + 1) // 2), device=dev)
                  for _ in range(2))
    tl = paired_times(
        torch, lambda: R2.color_slab2d_leg(*own[m], ns, prob, geoms[m],
                                           out_l),
        lambda: R2.color_slab2d_shard_plain(*own[m], 0, ns, prob, geoms[m],
                                            m), 1)
    rec_leg = {"max_abs_err": leg_err, "ms": tl["ms"],
               "plain_ms": tl["plain_ms"],
               **slab_bound(own[m], out_l, geoms[m], 0, m, ns),
               "library_ms": None}
    SHARD2D_AB["chunk_t4_ms"] = tm["ms"]
    # by level: the t = 4 chunk on ext halves, with the two halo copies
    # the engine takes before it on more ranks, in the one-rank form (the
    # path's on 4097^2 ... 513^2), and the 500-sweep leg (the path's on
    # 257^2 ... 65^2) beside 125 one-rank chunks of the same sweeps
    by_level = {}
    for m in levels:
        gm, y2 = geoms[m], (m + 1) // 2
        ext = [a[:m + 2 * t, :y2].contiguous() for a in src]
        halo = [torch.zeros((2 * t, y2), device=dev) for _ in range(2)]
        out_m = tuple(torch.empty((m, y2), device=dev) for _ in range(2))

        def ext_chunk():
            R2.color_slab2d_shard(*ext, 0, t, prob, gm, m, out_m)

        def copies_chunk():
            for h, a in zip(halo, ext[:2]):
                a[m:m + 2 * t].copy_(h)
            ext_chunk()

        def one_chunk():
            R2.color_slab2d_shard(*own[m], 0, t, prob, gm, m, out_m,
                                  one_rank=True)

        row = {"ext": device_ms(torch, ext_chunk, 10),
               "ext_copies": device_ms(torch, copies_chunk, 10),
               "one_rank": device_ms(torch, one_chunk, 10),
               "threads": R2.slab_tile(m, y2, t)[4]}
        if R2.leg_layout(gm) is not None:
            row["leg_ctas"] = R2.leg_layout(gm)[2]
            row["leg_500"] = device_ms(torch, lambda: R2.color_slab2d_leg(
                *own[m], 500, prob, gm, out_m), 4)

            def chunks_500():
                for _ in range(125):
                    one_chunk()

            row["chunks_500"] = device_ms(torch, chunks_500, 2)
        by_level[m] = row
    SHARD2D_AB["chunk_t4_ms_by_level"] = {
        m: r["one_rank"] for m, r in by_level.items()}
    SHARD2D_AB["leg_500_ms_by_level"] = {
        m: r["leg_500"] for m, r in by_level.items() if "leg_500" in r}
    SHARD2D_AB["forms_ms_by_level"] = by_level
    log(f"kernel color_slab2d_shard: bitwise against its plain version on "
        f"{checked} chunks (every shard of {n}^2 over 1, 2, 4 ranks at t = "
        f"1-4; the one-rank form on {levels} at t = 1-4; max diff {err!r}); "
        f"one t = {t} chunk, one-rank form ({x_loc} x {Y2} halves): device "
        f"{tm['ms']!r} ms vs plain {tm['plain_ms']!r} ms (bound "
        f"{rec['bound_ms']!r} ms by {rec['bound_by']}); eager "
        f"{tm['eager_ms']!r} ms")
    log(f"kernel color_slab2d_leg: bitwise against its plain version on "
        f"{legs_checked} legs ({SHARD2D_LEG_LEVELS} at {SHARD2D_LEGS} "
        f"sweeps; max diff {leg_err!r}); a {ns}-sweep leg at 257^2 "
        f"({R2.leg_layout(geoms[257])}): device {tl['ms']!r} ms vs plain "
        f"{tl['plain_ms']!r} ms (bound {rec_leg['bound_ms']!r} ms by "
        f"{rec_leg['bound_by']}); by level: {by_level!r}")
    torch.cuda.synchronize()
    return {"color_slab2d_shard": rec, "color_slab2d_leg": rec_leg}


def _lyap_cfg(nus):
    from pde_multigrid_tpu_torch import CycleConfig, SolverConfig

    return SolverConfig(cycle=CycleConfig("fmg", *nus, coarsest="exact"))


def phase_sharded2d(torch, sum_un, v_un):
    """Lyapunov 4097^2 FMG(2, 500, 500), exact coarsest, f32, `--mesh 1`
    through the CLI in process: error_linf < max(10 h, 5e-5), finite
    residuals, exactly the schedule's launches of the color slab chunk
    (4097^2 ... 513^2, the one-rank form), its whole-leg form (257^2 ...
    65^2), split2d and merge2d (`sharded_launches`) and no other kernel
    (no resident); ms per step eager and as one CUDA
    graph;
    the solution against phase 6's unsharded solve `v_un` (summary
    `sum_un`) within JAX's sharded-vs-single tolerance (rtol 2e-5, atol
    2e-6; error_linf within 1e-6), max|dv| printed.  Then the one-rank
    solve of the gloo ranks' reduced schedule.  Returns (launch counts,
    summary, the reduced solve's logical SHA-256)."""
    from pde_multigrid_tpu_torch import Lyapunov2D, MultigridSolver
    from pde_multigrid_tpu_torch.__main__ import main as cli_main
    from pde_multigrid_tpu_torch.parallel.mesh import make_mesh

    n = LYAP_N
    args = ["--problem", "lyapunov2d", "--n", str(n), "--nu0",
            str(LYAP_NUS[0]), "--nu1", str(LYAP_NUS[1]), "--nu2",
            str(LYAP_NUS[2]), "--coarsest", "exact", "--device", "cuda",
            "--mesh", "1"]
    solver = MultigridSolver(Lyapunov2D(), n, _lyap_cfg(LYAP_NUS),
                             device="cuda", mesh=make_mesh(1))
    kern = solver.program.kernels
    require(kern.plan == ["split2d"] * 7 + [None],
            f"sharded {n}^2 plan {kern.plan}")
    legs = [fn.leg for fn in kern._relax[:-1]]
    require(legs == [False] * 4 + [True] * 3,
            f"sharded {n}^2: whole legs on chip by level {legs}, want "
            "257^2, 129^2 and 65^2")
    want = sharded_launches(solver)
    buf, err = io.StringIO(), io.StringIO()
    torch.cuda.synchronize()
    reset_counts()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(err):
        res = cli_main(args)
    counts = read_counts()
    out = json.loads(buf.getvalue().strip().splitlines()[-1])
    h = 1.0 / (n - 1)
    limit = max(10 * h, 5e-5)
    tag = f"sharded lyapunov {n}^2 --mesh 1"
    ts = [getattr(fn, "T", None) for fn in kern._relax]
    log(f"{tag}: plan {kern.plan}, T {ts}, error_linf {out['error_linf']!r}"
        f" (limit max(10 h, 5e-5) = {limit!r}), residual_l2 "
        f"{out['residual_l2']!r}, launches {counts}, the schedule's {want}; "
        f"{err.getvalue().strip().splitlines()[-1]}")
    _check_solve(torch, tag, res, solver, limit, "sharded_lyap", want)
    require(out["error_linf"] == res.error_linf and not out["diverged"],
            f"{tag}: the CLI's summary and its result differ")
    dv = _max_err(torch, res.v, v_un)
    derr = abs(res.error_linf - sum_un["error_linf"])
    ok = bool(torch.all(torch.abs(res.v - v_un)
                        <= 2e-6 + 2e-5 * torch.abs(v_un)))
    log(f"{tag}: max|v - v_unsharded| {dv!r} "
        f"({'bitwise' if dv == 0.0 else 'not bitwise'}), |error_linf - "
        f"unsharded's| {derr!r} (unsharded {sum_un['error_linf']!r})")
    require(ok and derr < 1e-6, f"{tag}: not within JAX's tolerance of the "
            "unsharded solve")
    summary = {"sharded": n, "problem": "lyapunov2d", "ranks": 1,
               "plan": kern.plan, "error_linf": res.error_linf,
               "residual_l2": res.residual_l2, "launches": want,
               "max_abs_dv_unsharded": dv, "error_linf_diff_unsharded": derr,
               "unsharded_graph_ms_per_step": sum_un["graph_ms_per_step"],
               "unsharded_ms_per_step": sum_un["ms_per_step"]}
    del res
    summary.update(time_step(torch, tag, solver, solver.fresh_levels(), 2, 1))
    levels = solver.fresh_levels()
    busy = busy_split_ms(
        torch, lambda: solver.program.solve_step(levels),
        {"chunk": "color_slab2d_kernel<false",
         "leg": "color_slab2d_kernel<true, false",
         "split2d": "split2d_kernel",
         "merge2d": "merge2d_kernel"})
    summary["busy_ms"] = busy
    log(f"{tag}: device busy ms per step by kernel (profiler) {busy!r}")
    del levels
    # row 17's device ms per step by level: launches (4 (l + 1) legs, each
    # of ceil(nu / T) chunks or one whole leg) times phase_kernels_shard2d's
    # t = 4 one-rank chunk or 500-sweep leg
    chunk_ms = SHARD2D_AB.get("chunk_t4_ms_by_level", {})
    leg_ms = SHARD2D_AB.get("leg_500_ms_by_level", {})
    per = {}
    for l, (g, fn) in enumerate(zip(solver.geoms, kern._relax)):
        m = g.shape[0]
        if fn is None or m not in chunk_ms:
            continue
        if fn.leg:
            per[m] = ("leg", 4 * (l + 1), leg_ms[m])
        else:
            per[m] = ("chunk", 4 * (l + 1) * -(-LYAP_NUS[1] // fn.T),
                      chunk_ms[m])
    summary["chunk_ms_per_step_by_level"] = {
        m: k * ms for m, (_, k, ms) in per.items()}
    log(f"{tag}: row 17 launches by level (form, launches, device ms a "
        f"launch) {per}, their device ms per step "
        f"{summary['chunk_ms_per_step_by_level']!r} (sum "
        f"{sum(summary['chunk_ms_per_step_by_level'].values())!r})")
    del solver
    small = MultigridSolver(Lyapunov2D(), n, _lyap_cfg(SHARD2D_RANK_NUS),
                            device="cuda", mesh=make_mesh(1))
    r1 = small.solve()
    summary["reduced"] = {"nus": SHARD2D_RANK_NUS,
                          "error_linf": r1.error_linf}
    return counts, summary, _sha_logical(r1.v, n)


# the bench's anis3d row (bench.py:397-433): Poisson(3) on a domain
# squashed 20x along x, FMG(2, 16, 16) W-cycles (mu = 2) with zebra lines
# along x (line-0), the exact coarsest level (9^3, the dense inverse), f32
ANIS_DOMAIN = ((0.0, 0.05), (0.0, 1.0), (0.0, 1.0))
ANIS_N = 257
ANIS_NUS = (2, 16, 16)
# the line kernel's levels: (shape, domain, line axis); every relaxed level
# of the anis3d row along x, 257^3 ... 17^3 (17^3 the one 3D layout with
# two columns of lines a CTA), a 65^3 level along y and z, and a 2D level
# along both axes; each bitwise its plain version at LINE_SWEEPS
LINE_LEVELS = (*(((n,) * 3, ANIS_DOMAIN, 0) for n in (257, 129, 65, 33, 17)),
               ((65,) * 3, ANIS_DOMAIN, 1), ((65,) * 3, ANIS_DOMAIN, 2),
               ((1025, 1025), ANIS_DOMAIN[:2], 0),
               ((1025, 1025), ANIS_DOMAIN[:2], 1))
LINE_SWEEPS = (1, 2, 16)
# the anis3d 129^3 f32 solve against its float64 solve: float32 ulp of
# max|u| (17 measured on the H100, PR 25's first run)
ANIS_F32_ULPS = 64
# a half-sweep by level and axis: kernel and plain ms, its bound
LINE_AB = {}
# row 22's W-cycle (mu = 2) beside its V-cycle, ms a call by root and nu
WCYCLE_AB = {}


def _line_cost(p, g) -> tuple:
    """(bytes, operations) of one zebra half-sweep: v read once and f read
    on the colour's lines, the colour's interior points of v written;
    about 12 float operations a point of the colour's lines (the d terms,
    the blend into d, the two recurrences, the blend into v)."""
    n = 1
    for d in g.padded_shape:
        n *= d
    lines = p.n_zeb_lines * p.n_thr_lines
    inter = lines * (p.row_hi - p.row_lo + 1)
    return 4 * n + 4 * lines * p.n_line + 4 * inter, 12 * lines * p.n_line


def phase_kernels_line(torch):
    """The zebra line kernel (csrc/zebra_line.cu) bitwise (torch.equal)
    against its plain version (`relax_zebra_line` on the card, float32) on
    LINE_LEVELS at LINE_SWEEPS sweeps from random v and f; each level's
    half-sweep of each colour timed (graph-replayed) beside the plain
    half-sweep's eager time (a few thousand PyTorch operations with a few
    host-to-device copies of the line's constants: not captured; its masks
    made once before) and its byte bound.  Returns {"zebra_line":
    the 257^3 line-0 half-sweep's record}."""
    import numpy as np

    from pde_multigrid_tpu_torch.grid import build_geometries
    from pde_multigrid_tpu_torch.models import Poisson
    from pde_multigrid_tpu_torch.ops.cuda import zebra_line as ZL

    dev = torch.device("cuda")
    rng = np.random.default_rng(2045)
    out, max_err = {}, 0.0
    for shape, dom, axis in LINE_LEVELS:
        g = build_geometries(shape, dom, 1)[0]
        prob = Poisson(len(shape), dom)
        plan = ZL.LinePlan(prob, g, axis, dev)
        v0 = torch.tensor(rng.standard_normal(g.padded_shape).astype(
            np.float32), device=dev)
        f = torch.tensor(rng.standard_normal(g.padded_shape).astype(
            np.float32), device=dev)
        tag = f"zebra_line {shape} line-{axis}"
        for ns in LINE_SWEEPS:
            k = ZL.zebra_relax(v0.clone(), f, ns, plan)
            p = plan.plain.relax(v0, f, ns)
            err = _max_err(torch, k, p)
            max_err = max(max_err, err)
            require(torch.equal(k, p), f"{tag}: {ns} sweeps not bitwise "
                    f"the plain version, max diff {err!r}")
            require(bool(torch.isfinite(k).all()), f"{tag}: non-finite")
        ab = LINE_AB[f"{shape} line-{axis}"] = {}
        for colour in (0, 1):
            pc = plan.params[colour]
            vk = v0.clone()
            kms = device_ms(torch, lambda: ZL.zebra_half_sweep(
                vk, f, colour, plan), 20 if len(shape) == 3 else 5)
            pms = time_ms(torch,
                          lambda: plan.plain.half_sweep(v0, f, colour), 2)
            nbytes, ops = _line_cost(pc, g)
            ab[f"colour {colour}"] = {
                "ms": kms, "plain_ms": pms, **bound(nbytes, ops),
                "lines": pc.n_zeb_lines * pc.n_thr_lines,
                "ctas": pc.ctas, "threads": pc.threads}
            if shape == (ANIS_N,) * 3 and colour == 0:
                out["zebra_line"] = {"max_abs_err": 0.0, "ms": kms,
                                     "plain_ms": pms, **bound(nbytes, ops),
                                     "library_ms": None}
        log(f"kernel {tag}: bitwise its plain version at {LINE_SWEEPS} "
            f"sweeps; a half-sweep, device ms (graph) vs the plain "
            f"version's eager ms and the bound: {ab!r}")
    out["zebra_line"]["max_abs_err"] = max_err
    torch.cuda.synchronize()
    return out


def phase_subtree_mu2(torch):
    """Row 22's W-cycle form: the fused subtree (csrc/subtree.cu) with
    mu = 2 bitwise its plain version (`subtree_vcycle_plain(mu=2)`) at the
    64^3 and 32^3 roots of the 65^3 wrap hierarchy, nu = (1, 1), (2, 3),
    the whole cycle and the correction alone, and mu = 3 at 32^3; the
    64^3- and 32^3-rooted W-cycle timed at nu = (2, 2) and 100 beside the
    V-cycle (mu = 1), the plain version at nu = (2, 2), into WCYCLE_AB
    (with the 64^3 nu = 100 W-cycle's bound)."""
    import numpy as np

    from pde_multigrid_tpu_torch.grid import build_geometries, wrap_interior
    from pde_multigrid_tpu_torch.models import Poisson3D
    from pde_multigrid_tpu_torch.ops.cuda import subtree as S

    dev = torch.device("cuda")
    prob = Poisson3D()
    geoms = build_geometries((65,) * 3, prob.domain, wrap=True)
    rng = np.random.default_rng(2046)
    max_err = 0.0
    for l in (0, 1):
        sub = tuple(geoms[l:])
        shp = sub[0].padded_shape
        v = torch.tensor((rng.standard_normal(shp) * wrap_interior(shp))
                         .astype(np.float32), device=dev)
        f = torch.tensor(rng.standard_normal(shp).astype(np.float32),
                         device=dev)
        cases = [(1, 1, 2), (2, 3, 2)] + ([(1, 2, 3)] if l == 1 else [])
        for nu1, nu2, mu in cases:
            for wr in (True, False):
                k = S.subtree_vcycle(v.clone(), f, prob, sub, nu1, nu2, wr,
                                     mu)
                p = S.subtree_vcycle_plain(v, f, prob, sub, nu1, nu2, wr,
                                           mu)
                err = _max_err(torch, k, p)
                max_err = max(max_err, err)
                require(torch.equal(k, p), f"subtree root {shp[0]}^3 nu = "
                        f"({nu1}, {nu2}) mu = {mu} with_root_relax={wr}: "
                        f"not bitwise the plain version, max diff {err!r}")
        ab = WCYCLE_AB[f"{shp[0]}^3"] = {}
        for nu in (2, 100):
            for mu in (1, 2):
                vk = v.clone()
                ab[f"nu={nu} mu={mu}"] = device_ms(
                    torch, lambda: S.subtree_vcycle(vk, f, prob, sub, nu, nu,
                                                    True, mu), 5)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        S.subtree_vcycle_plain(v, f, prob, sub, 2, 2, True, 2)
        e1.record()
        e1.synchronize()
        ab["plain nu=2 mu=2"] = e0.elapsed_time(e1)
        log(f"kernel subtree mu=2 (root {shp[0]}^3): bitwise the plain "
            f"version at (nu1, nu2, mu) {cases}, with and without the "
            f"root's relax; device ms a call {ab!r}")
        if l == 0:
            nbytes, ops = _subtree_mu_cost(sub, 100, 100, 2)
            ab["nu=100 mu=2 bound"] = bound(nbytes, ops)
    WCYCLE_AB["max_abs_err"] = max_err
    torch.cuda.synchronize()


def _subtree_mu_cost(geoms, nu1: int, nu2: int, mu: int) -> tuple:
    """(bytes, operations) of a fused cycle with mu visits: the root's v
    read and written and its f read once; 13 operations an updated point
    and sweep, level k relaxed in mu^k visits of nu1 + nu2 sweeps."""
    n0 = 1
    for d in geoms[0].padded_shape:
        n0 *= d
    ops = sum(13 * updated_points(g.padded_shape) * (nu1 + nu2) * mu ** k
              for k, g in enumerate(geoms))
    return 12 * n0, ops


def line_launches(solver) -> int:
    """zebra_line launches of one FMG step of the solver's schedule: level
    l (relaxed) is visited nu0 (1 + mu + ... + mu^l) times (nu0 cycles
    from each level at or above it, each reaching it mu^(l - s) times),
    each visit nu1 + nu2 sweeps of one launch a colour with lines."""
    cyc = solver.config.cycle
    total = 0
    for l, plan in enumerate(solver.program.kernels.plans):
        if plan is not None:
            visits = cyc.nu0 * sum(cyc.mu ** (l - s) for s in range(l + 1))
            total += visits * plan.launches(cyc.nu1 + cyc.nu2)
    return total


def _anis_solver(n: int, dtype: str = "float32"):
    from pde_multigrid_tpu_torch import (
        CycleConfig,
        MultigridSolver,
        Poisson,
        SolverConfig,
    )

    cyc = CycleConfig("fmg", *ANIS_NUS, mu=2, smoother="line-0",
                      coarsest="exact")
    return MultigridSolver(Poisson(3, ANIS_DOMAIN), n,
                           SolverConfig(cycle=cyc, dtype=dtype),
                           device="cuda")


def phase_anis3d(torch):
    """The bench's anis3d row through `MultigridSolver(...,
    device="cuda")`, as bench.py:397-433 builds it: 257^3 on the squashed
    domain, FMG(2, 16, 16), mu = 2, line-0, exact coarsest, f32; the line
    kernel's tier (LineKernels: the zebra kernel on 257^3 ... 17^3, the
    plain ops on the card).  error_linf < 50 h^2 with h the largest
    spacing (bench.py:714-733), finite residuals, exactly `line_launches`
    zebra_line launches and no other kernel, the schedule's relaxed visits
    and ms per step eager and as one CUDA graph, DOF-updates/s, the
    profiler's busy time split into the line kernel and plain ops.  Then
    129^3: the f32 solve against the float64 solve of the same schedule
    (the plain tier on the card, its Thomas scans a Python loop): both
    under 50 h^2, and since the discretization error there (2.5e-8)
    lies under float32's resolution of the solution, the f32 solution
    held to the float32 floor: max|v32 - v64| and its error_linf's excess
    over float64's within ANIS_F32_ULPS ulp of max|u|.  Returns (launch
    counts of the 257^3 solve, summary)."""
    from pde_multigrid_tpu_torch.utils.updates import count_smoother_updates

    from pde_multigrid_tpu_torch.ops.cuda.zebra_line import LineKernels

    solver = _anis_solver(ANIS_N)
    require(isinstance(solver.program.kernels, LineKernels),
            f"anis3d: tier {type(solver.program.kernels).__name__}")
    want = line_launches(solver)
    levels = solver.fresh_levels()
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    res = solver.solve(levels)
    wall = time.perf_counter() - t0
    counts = read_counts()
    h = max(solver.geoms[0].spacing)
    tag = f"anis3d {ANIS_N}^3"
    cyc = solver.config.cycle
    visits = [cyc.nu0 * sum(cyc.mu ** (l - s) for s in range(l + 1))
              for l in range(len(solver.geoms) - 1)]
    log(f"{tag}: levels {[g.padded_shape for g in solver.geoms]}, relaxed "
        f"visits by level {visits} ({sum(visits)}), error_linf "
        f"{res.error_linf!r} (limit 50 h^2 = {50 * h * h!r}), residual_l2 "
        f"{res.residual_l2!r}, first solve {wall!r} s, launches "
        f"{ {k: c for k, c in counts.items() if c} }")
    _check_solve(torch, tag, res, solver, 50 * h * h, "anis3d",
                 {"zebra_line": want})
    summary = {"row": "anis3d", "n": ANIS_N, "nus": list(ANIS_NUS), "mu": 2,
               "smoother": "line-0",
               "levels": [g.padded_shape for g in solver.geoms],
               "relaxed_visits": visits, "zebra_line_launches": want,
               "error_linf": res.error_linf,
               "residual_l2": res.residual_l2}
    summary.update(time_step(torch, tag, solver, levels, 3, 1))
    busy = busy_split_ms(torch, lambda: solver.program.solve_step(levels),
                         {"zebra_line": "zebra_line_kernel"})
    summary["busy_ms"] = busy
    # the line kernel by level: a half-sweep (graph-replayed, the level's
    # own v and f) beside the plain one (eager) and its bound, and times
    # the level's launches a step
    from pde_multigrid_tpu_torch.ops.cuda import zebra_line as ZL

    by_level = {}
    for l, plan in enumerate(solver.program.kernels.plans):
        if plan is None:
            continue
        lv = levels[l]
        vk = lv.v.clone()
        ms = device_ms(torch, lambda: ZL.zebra_half_sweep(vk, lv.f, 0, plan),
                       10)
        pms = time_ms(torch,
                      lambda: plan.plain.half_sweep(lv.v, lv.f, 0), 2)
        n = visits[l] * plan.launches(cyc.nu1 + cyc.nu2)
        by_level[plan.geom.padded_shape[0]] = {
            "half_sweep_ms": ms, "plain_ms": pms,
            **bound(*_line_cost(plan.params[0], plan.geom)),
            "launches": n, "ms_a_step": ms * n}
    summary["line_by_level"] = by_level
    log(f"{tag}: device busy ms a step {busy!r}; the line kernel by level "
        f"{by_level!r}")
    shapes = [g.shape for g in solver.geoms]
    require(summary["updates_per_step"] == count_smoother_updates(
        shapes, "fmg", *ANIS_NUS, 2, "exact"), f"{tag}: update count")
    del levels, res
    # 129^3: f32 against float64
    s32, s64 = _anis_solver(129), _anis_solver(129, "float64")
    r32 = s32.solve()
    t0 = time.perf_counter()
    r64 = s64.solve()
    t64 = time.perf_counter() - t0
    dv = float(torch.max(torch.abs(r32.v.double() - r64.v)))
    h = max(s32.geoms[0].spacing)
    floor = ANIS_F32_ULPS * 2.0 ** -23 * float(torch.max(torch.abs(r64.v)))
    log(f"anis3d 129^3: f32 error_linf {r32.error_linf!r}, float64 "
        f"{r64.error_linf!r} (plain tier on the card, {t64:.1f} s), "
        f"max|v32 - v64| {dv!r} (the float32 floor, {ANIS_F32_ULPS} ulp "
        f"of max|u|: {floor!r}); limit 50 h^2 = {50 * h * h!r}")
    require(r32.error_linf < 50 * h * h and r64.error_linf < 50 * h * h,
            "anis3d 129^3: error_linf over 50 h^2")
    require(dv <= floor and r32.error_linf <= r64.error_linf + floor,
            "anis3d 129^3: f32 off its float64 solve by more than the "
            "float32 floor")
    summary["f64_129"] = {"error_linf_f32": r32.error_linf,
                          "error_linf_f64": r64.error_linf,
                          "max_dv": dv, "floor": floor, "f64_s": t64}
    return counts, summary


def phase_wcycle_cli(torch):
    """`python -m pde_multigrid_tpu_torch --n 129 --kind fmg --mu 2` in
    process on "cuda": 3D wrap Poisson, FMG(2, 2, 2) W-cycles relaxed to
    2^3, every cycle rooted at 64^3 or below one launch of the fused
    subtree with mu = 2 inside, the 128^3 cycles calling it twice each:
    error_linf < 50 h^2, exactly the schedule's launches
    (`preset_launches` with mu) and no other kernel.  Returns (launch
    counts, summary)."""
    from pde_multigrid_tpu_torch import (
        CycleConfig,
        MultigridSolver,
        Poisson3D,
        SolverConfig,
    )
    from pde_multigrid_tpu_torch.__main__ import main as cli_main
    from pde_multigrid_tpu_torch.ops.cuda import relax as R

    n = 129
    solver = MultigridSolver(Poisson3D(), n, SolverConfig(
        cycle=CycleConfig("fmg", 2, 2, 2, 2)), device="cuda")
    want = preset_launches(solver, R.TIMESKEW_T)
    buf = io.StringIO()
    torch.cuda.synchronize()
    reset_counts()
    with contextlib.redirect_stdout(buf), \
            contextlib.redirect_stderr(io.StringIO()):
        cli_main(["--n", str(n), "--kind", "fmg", "--mu", "2", "--device",
                  "cuda"])
    counts = read_counts()
    out = json.loads(buf.getvalue().strip().splitlines()[-1])
    h = 1.0 / (n - 1)
    tag = f"poisson3d {n}^3 --kind fmg --mu 2"
    log(f"{tag}: error_linf {out['error_linf']!r} (limit 50 h^2 = "
        f"{50 * h * h!r}), residual_l2 {out['residual_l2']!r}, solve "
        f"{out['wall_time_s']!r} s, launches "
        f"{ {k: c for k, c in counts.items() if c} }, the schedule's {want}")
    require(out["cycle"]["mu"] == 2, f"{tag}: cycle {out['cycle']}")
    require(out["error_linf"] < 50 * h * h, f"{tag}: error_linf too large")
    require(all(x == x and abs(x) != float("inf")
                for x in out["residual_history"]) and not out["diverged"],
            f"{tag}: non-finite residuals")
    _check_counts(tag, "wcycle129", {k: want[k] for k in PATHS["wcycle129"]})
    return counts, {"row": "wcycle_cli", "n": n, "mu": 2,
                    "error_linf": out["error_linf"],
                    "residual_l2": out["residual_l2"],
                    "launches": want}


# ----------------------------------------------------------- 2D Poisson

P2D_N = 4097
P2D_NUS = (2, 500, 500)
# padded storage's domain upper bound: sin(1.5 pi) = -1 on the far edges,
# a nonzero boundary, so the solver builds the padded hierarchy
P2D_PADDED_HI = 1.5
# ms of the 2D Poisson forms by storage and level (phase_kernels_poisson2d)
P2D_AB = {}


def _p2d_problem(wrap: bool):
    """Poisson(2) on [0, 1]^2 (zero boundary: wrap storage) or on [0,
    P2D_PADDED_HI]^2 (padded storage)."""
    from pde_multigrid_tpu_torch import Poisson

    hi = 1.0 if wrap else P2D_PADDED_HI
    return Poisson(2, domain=((0.0, hi), (0.0, hi)))


def _p2d_inputs(torch, rng, prob, g):
    """(v, f, fixed) of a 2D Poisson level on the card: the initial level
    (its boundary as the solver holds it) plus N(0, 1) on the interior, f
    N(0, 1) everywhere, and the mask of the points no sweep may write."""
    import numpy as np

    lvl = prob.init_level(g, torch.float32, "cuda")
    noise, f = (torch.tensor(rng.standard_normal(g.padded_shape).astype(
        np.float32), device="cuda") for _ in range(2))
    m = lvl.aux["m_int"]
    return (lvl.v + m * noise).contiguous(), f, m == 0


def _p2d_cost(g, nsweeps: int, form: str):
    """(bytes, operations) of `nsweeps` red-black sweeps of a 2D Poisson
    form on level `g`: the dense forms ("dense": the leg, the slab) read v
    and f and write v, 12 B a stored point, and do 9 operations an
    updated point and sweep (the update's 7: two pair sums, two products,
    two sums, the reciprocal's product; the blend's 2); the chunk on
    halves reads r, b, fr, fb and writes r, b, 24 B a slot of a half
    ("chunk"), or 16 B and 6 operations without f ("chunk_no_f")."""
    n_int = (g.shape[0] - 2) * (g.shape[1] - 2)
    X, Y = g.padded_shape
    if form == "dense":
        return 12 * X * Y, 9 * n_int * nsweeps
    Y2 = (Y + 1) // 2
    if form == "chunk":
        return 24 * X * Y2, 7 * n_int * nsweeps
    return 16 * X * Y2, 6 * n_int * nsweeps


def _p2d_chunks_plain(r, b, fr, fb, nsweeps, prob, g):
    """The one-rank chunks' schedule in the plain version: chunks of
    CHUNK_T sweeps, the remainder last, of color_slab2d_shard_plain."""
    from pde_multigrid_tpu_torch.ops.cuda import relax2d as R2

    done = 0
    while done < nsweeps:
        t = min(R2.CHUNK_T, nsweeps - done)
        r, b = R2.color_slab2d_shard_plain(r, b, fr, fb, 0, t, prob, g,
                                           g.padded_shape[0])
        done += t
    return r, b


def phase_kernels_poisson2d(torch):
    """The 2D Poisson forms of rows 1, 3 and 16 against their plain
    versions on the card, bitwise (torch.equal: a boundary zero the plain
    version's masked blend turns from -0 to +0 compares equal; the kernels
    never write the boundary, which stays as it was), on every level of
    both 4097^2 hierarchies in the form the plan gives it (`CudaKernels`):
    wrap storage 4096^2 ... 512^2 the slab (`slab2d.slab_relax`, T = 4
    sweeps a launch, a whole leg a launch on 512^2), 256^2 ... 2^2 the
    dense leg (`resident.resident_relax`); padded storage 4097^2 ... 513^2
    row 16's one-rank chunk on the level's halves
    (`relax2d.color_slab2d_shard` at t = 1, 3, 4, `relax_halves2d` over 5
    and 500 sweeps), 257^2 ... 3^2 the dense leg, each dense form at 1,
    T - 1, T, T + 1 and 500 sweeps (T its sweeps between refreshes or a
    launch's; a one-CTA leg's T is the leg), with f; the leg also f-less
    on 256^2 and 257^2, the chunk f-less at t = 4 on 4097^2.  A 500-sweep
    leg of every level's form graph-replayed (ms into P2D_AB, by storage
    and level), and each form's record timed beside its plain version in
    turns (graph replay): slab2d_poisson one T = 4 launch at 4096^2
    (wrap), resident_poisson a 500-sweep leg at 256^2 (wrap),
    color_slab2d_poisson a t = 4 chunk at 4097^2 with f (f-less beside
    it).  Returns {name: record}."""
    import numpy as np

    from pde_multigrid_tpu_torch.grid import build_geometries
    from pde_multigrid_tpu_torch.ops.cuda import relax2d as R2
    from pde_multigrid_tpu_torch.ops.cuda import resident as RS
    from pde_multigrid_tpu_torch.ops.cuda import slab2d as SL
    from pde_multigrid_tpu_torch.ops.cuda.dispatch import CudaKernels

    rng = np.random.default_rng(2031)
    nsw = P2D_NUS[1]
    out = {}

    def record(name, err, t, what, cost, **extra):
        res = {"max_abs_err": err, "ms": t["ms"], "plain_ms": t["plain_ms"],
               **bound(*cost), "library_ms": None, **extra}
        log(f"kernel {name} ({what}): max|kernel - plain| = {err!r}; device "
            f"{t['ms']!r} ms vs "
            f"plain {t['plain_ms']!r} ms (bound {res['bound_ms']!r} ms by "
            f"{res['bound_by']}); eager call {t['eager_ms']!r} ms vs plain "
            f"{t['eager_plain_ms']!r} ms")
        return res

    def same(tag, k, p, v=None, fixed=None):
        err = _max_err(torch, k, p)
        require(torch.equal(k, p), f"{tag}: not bitwise its plain version: "
                f"max diff {err!r}")
        if fixed is not None:
            require(torch.equal(k[fixed], v[fixed]),
                    f"{tag}: a boundary point changed")
        return err

    for wrap in (True, False):
        prob = _p2d_problem(wrap)
        geoms = build_geometries((P2D_N,) * 2, prob.domain, wrap=wrap)
        kern = CudaKernels(prob, geoms, torch.float32)
        store = "wrap" if wrap else "padded"
        legs = P2D_AB.setdefault(f"{store} leg_{nsw}_ms", {})
        for l, g in enumerate(geoms):
            v, f, fixed = _p2d_inputs(torch, rng, prob, g)
            n = g.shape[0]
            fn = kern._relax[l]
            if fn == kern._relax_slab:
                lay = SL.slab_layout(g)
                T = lay.T
                tag = (f"slab2d_poisson {store} {n}^2 ({lay.ntx} x {lay.nty} "
                       f"tiles of {lay.BX} x {lay.BY}, T = {T}, "
                       f"{SL.slab_launches(nsw, g)} launch(es) a "
                       f"{nsw}-sweep leg)")
                for ns in sorted({1, T - 1, T, T + 1, nsw} - {0}):
                    err = same(f"{tag}, {ns} sweeps",
                               SL.slab_relax(v, f, ns, prob, g),
                               SL.slab_relax_plain(v, f, ns, prob, g), v,
                               fixed)
                legs[n] = device_ms(
                    torch, lambda: SL.slab_relax(v, f, nsw, prob, g), 1)
                if n == P2D_N:
                    t = paired_times(
                        torch, lambda: SL.slab_relax(v, f, T, prob, g),
                        lambda: SL.slab_relax_plain(v, f, T, prob, g), 1)
                    out["slab2d_poisson"] = record(
                        "slab2d_poisson", err, t,
                        f"{tag}: one T = {T} launch",
                        _p2d_cost(g, T, "dense"))
            elif fn == kern._relax_resident:
                lay = RS.poisson_leg_layout(g)
                T = lay.T or nsw
                tag = (f"resident_poisson {store} {n}^2 ({lay.nctas} CTA(s) "
                       f"of {lay.threads} threads, T = {T}, {lay.G} "
                       f"segment(s) of {lay.L} rows)")
                for ns in sorted({1, T - 1, T, T + 1, nsw} - {0}):
                    err = same(f"{tag}, {ns} sweeps",
                               RS.resident_relax(v.clone(), f, ns, prob, g),
                               RS.resident_relax_plain(v.clone(), f, ns,
                                                       prob, g), v, fixed)
                if n == 257:  # the first level of the leg, either storage
                    same(f"{tag}, f-less, {nsw} sweeps",
                         RS.resident_relax(v.clone(), None, nsw, prob, g),
                         RS.resident_relax_plain(v.clone(), None, nsw, prob,
                                                 g), v, fixed)
                w = v.clone()
                legs[n] = device_ms(
                    torch, lambda: RS.resident_relax(w, f, nsw, prob, g), 1)
                if wrap and n == 257:
                    t = paired_times(
                        torch, lambda: RS.resident_relax(w, f, nsw, prob, g),
                        lambda: RS.resident_relax_plain(w, f, nsw, prob, g),
                        1)
                    out["resident_poisson"] = record(
                        "resident_poisson", err, t,
                        f"{tag}: one {nsw}-sweep leg",
                        _p2d_cost(g, nsw, "dense"))
            else:
                require(fn == kern._relax_split,
                        f"{store} {n}^2: not a planned Poisson form")
                X, Y = g.padded_shape
                r, b = R2.split_colors_2d(v)
                fr, fb = R2.split_colors_2d(f)
                tiles = R2.slab_tile(X, (Y + 1) // 2, R2.CHUNK_T, 2)
                tag = (f"color_slab2d_poisson {n}^2 (tiles of {tiles[0]} x "
                       f"{tiles[1]} loaded, {tiles[2]} x {tiles[3]} owned, "
                       f"{tiles[4]} threads)")
                o = (torch.empty_like(r), torch.empty_like(b))
                for t_ in (1, R2.CHUNK_T - 1, R2.CHUNK_T):
                    R2.color_slab2d_shard(r, b, fr, fb, 0, t_, prob, g, X, o,
                                          one_rank=True)
                    pr, pb = R2.color_slab2d_shard_plain(r, b, fr, fb, 0, t_,
                                                         prob, g, X)
                    err = max(same(f"{tag}, t = {t_}, r", o[0], pr),
                              same(f"{tag}, t = {t_}, b", o[1], pb))
                if l == 0:
                    R2.color_slab2d_shard(r, b, None, None, 0, R2.CHUNK_T,
                                          prob, g, X, o, one_rank=True)
                    pr, pb = R2.color_slab2d_shard_plain(
                        r, b, None, None, 0, R2.CHUNK_T, prob, g, X)
                    same(f"{tag}, f-less t = {R2.CHUNK_T}, r", o[0], pr)
                    same(f"{tag}, f-less t = {R2.CHUNK_T}, b", o[1], pb)
                for ns in (R2.CHUNK_T + 1, nsw):
                    kr, kb = R2.relax_halves2d(r.clone(), b.clone(), fr, fb,
                                               ns, prob, g)
                    pr, pb = _p2d_chunks_plain(r, b, fr, fb, ns, prob, g)
                    same(f"{tag}, {ns} sweeps, r", kr, pr)
                    same(f"{tag}, {ns} sweeps, b", kb, pb)
                    dense = R2.merge_colors_2d(kr, kb, Y)
                    require(torch.equal(dense[fixed], v[fixed]),
                            f"{tag}: a boundary point changed")
                rr, bb = r.clone(), b.clone()
                spare = (torch.empty_like(r), torch.empty_like(b))
                legs[n] = device_ms(
                    torch, lambda: R2.relax_halves2d(rr, bb, fr, fb, nsw,
                                                     prob, g, spare=spare), 1)
                chunk = lambda fs: lambda: R2.color_slab2d_shard(  # noqa
                    r, b, *fs, 0, R2.CHUNK_T, prob, g, X, o, one_rank=True)
                plain = lambda fs: lambda: R2.color_slab2d_shard_plain(  # noqa
                    r, b, *fs, 0, R2.CHUNK_T, prob, g, X)
                P2D_AB.setdefault("chunk_t4_ms", {})[n] = {
                    "f": device_ms(torch, chunk((fr, fb)), 10),
                    "no_f": device_ms(torch, chunk((None, None)), 10)}
                if l == 0:
                    t = paired_times(torch, chunk((fr, fb)), plain((fr, fb)),
                                     3)
                    t0 = paired_times(torch, chunk((None, None)),
                                      plain((None, None)), 3)
                    nf = {"ms": t0["ms"], "plain_ms": t0["plain_ms"],
                          **bound(*_p2d_cost(g, R2.CHUNK_T, "chunk_no_f"))}
                    out["color_slab2d_poisson"] = record(
                        "color_slab2d_poisson", err, t,
                        f"{tag}: one t = {R2.CHUNK_T} chunk with f; f-less "
                        f"{nf}", _p2d_cost(g, R2.CHUNK_T, "chunk"),
                        no_f=nf)
            log(f"{tag}: bitwise; a {nsw}-sweep leg {legs[n]!r} ms")
    torch.cuda.synchronize()
    return out


def poisson2d_launches(solver) -> dict:
    """The relax launches of one FMG step of the 2D Poisson plan: level l
    takes nu0 (l + 1) V-cycles, each a nu1 and a nu2 leg: ceil(nu /
    CHUNK_T) chunks of row 16 on a split level, `slab_launches` launches
    of the slab, one launch of the dense leg."""
    from pde_multigrid_tpu_torch.ops.cuda import slab2d as SL
    from pde_multigrid_tpu_torch.ops.cuda.relax2d import CHUNK_T

    kern = solver.program.kernels
    cyc = solver.config.cycle
    want = {"color_slab2d_poisson": 0, "slab2d_poisson": 0,
            "resident_poisson": 0}
    for l, fn in enumerate(kern._relax):
        if fn is None:
            continue
        cycles = cyc.nu0 * (l + 1)
        g = solver.geoms[l]
        if kern._split[l]:
            want["color_slab2d_poisson"] += cycles * (
                -(-cyc.nu1 // CHUNK_T) - (-cyc.nu2 // CHUNK_T))
        elif fn == kern._relax_slab:
            want["slab2d_poisson"] += cycles * (
                SL.slab_launches(cyc.nu1, g) + SL.slab_launches(cyc.nu2, g))
        else:
            want["resident_poisson"] += 2 * cycles
    return want


def phase_poisson2d(torch):
    """2D Poisson at 4097^2: FMG(2, 500, 500) with the exact coarsest
    level, f32, through `MultigridSolver.solve()` on "cuda", in wrap
    storage (Poisson(2) on [0, 1]^2: the slab on 4096^2 ... 512^2, the
    dense leg on 256^2 and 128^2, fast diagonalization on 64^2) and in
    padded storage (on [0, 1.5]^2: row 16's chunks on the split levels
    4097^2 ... 513^2, the dense leg on 257^2 ... 65^2, the dense inverse
    on 33^2).  Each: error_linf under the bench's gate max(10 h, 5e-5),
    finite residuals, exactly the schedule's relax launches
    (`poisson2d_launches`), padded also split2d / merge2d within the
    persistent halves' budget, and no other kernel; the solution's
    SHA-256; ms per step eager and as one CUDA graph, the profiler's busy
    time by kernel; then the float64 solve of the same schedule on the
    card (plain tier), |v - v_float64| and the error gap reported (the
    float32 solve's error is float32 rounding: the discretization error,
    ~5e-8, lies below float32's reach, so no 1 % gate).  Returns (launch
    counts by path, summaries)."""
    from pde_multigrid_tpu_torch import (
        CycleConfig,
        MultigridSolver,
        SolverConfig,
    )

    counts_by, out = {}, []
    for wrap in (True, False):
        prob = _p2d_problem(wrap)
        store = "wrap" if wrap else "padded"
        path = f"poisson2d_{store}"
        cfg = SolverConfig(cycle=CycleConfig("fmg", *P2D_NUS,
                                             coarsest="exact"))
        solver = MultigridSolver(prob, P2D_N, cfg, device="cuda")
        kern = solver.program.kernels
        require(solver.geoms[0].wrap == wrap,
                f"poisson2d {store}: the solver chose other storage")
        levels = solver.fresh_levels()
        torch.cuda.synchronize()
        reset_counts()
        res = solver.solve(levels)
        counts = read_counts()
        conv = dict(kern.conversions)
        h = max(solver.geoms[0].spacing)
        limit = max(10 * h, 5e-5)
        tag = f"poisson2d {P2D_N}^2 {store}"
        want = {k: c for k, c in poisson2d_launches(solver).items()
                if k in PATHS[path]}
        log(f"{tag}: levels {[g.padded_shape for g in solver.geoms]}, relax "
            f"{[getattr(fn, '__name__', None) for fn in kern._relax]}, "
            f"error_linf {res.error_linf!r} (limit max(10 h, 5e-5) = "
            f"{limit!r}), residual_l2 {res.residual_l2!r}, residual_linf "
            f"{res.residual_linf!r}, launches {counts}, conversions {conv}")
        counts_by[path] = _check_solve(torch, tag, res, solver, limit, path,
                                       want)
        # the budget: per visit of a split level at most one split of v
        # and one merge, one split of f per visit as a coarse level (nu0
        # l: its restricted residual) and one for the FMG stage it tops
        # (its f is not rewritten there), plus the solution's merge
        split = [l for l, s_ in enumerate(kern._split) if s_]
        nu0 = P2D_NUS[0]
        visits = sum(nu0 * (l + 1) for l in split)
        budget = {"split_v": visits,
                  "split_f": sum(nu0 * l + 1 for l in split),
                  "merge": visits + bool(split)}
        require(all(conv[k] <= budget[k] for k in budget)
                and counts["split2d"] == conv["split_v"] + conv["split_f"]
                and counts["merge2d"] == conv["merge"],
                f"{tag}: conversions {conv} (budget {budget}), split2d "
                f"{counts['split2d']}, merge2d {counts['merge2d']}")
        sha = _sha(res.v)
        log(f"{tag}: relax launches {want} as the schedule implies, "
            f"conversions {conv} within {budget}; solution SHA-256 {sha}")
        summary = {"n": P2D_N, "problem": "poisson2d", "storage": store,
                   "precision": "f32",
                   "levels": [g.padded_shape for g in solver.geoms],
                   "error_linf": res.error_linf,
                   "residual_l2": res.residual_l2, "conversions": conv,
                   "launches_per_step": want, "sha256": sha}
        v = res.v.clone()
        summary.update(time_step(torch, tag, solver, levels, 1, 1))
        busy = busy_split_ms(
            torch, lambda: solver.program.solve_step(levels),
            {"chunk": "color_slab2d_kernel", "slab": "slab2d_kernel",
             "resident": "resident2d_kernel", "split2d": "split2d_kernel",
             "merge2d": "merge2d_kernel"})  # the chunk's name holds the
        # slab's: the first name a kernel holds labels it
        summary["busy_ms"] = busy
        log(f"{tag}: device busy ms per step by kernel (profiler) {busy!r}")
        del solver, levels, res
        phase_f64_reference(torch, prob, P2D_N, P2D_NUS, summary, v, tag,
                            wrap=wrap, gate=False)
        out.append(summary)
    return counts_by, out


def phase_poisson2d_cli(torch):
    """`python -m pde_multigrid_tpu_torch --problem poisson2d --n 4097` in
    process on "cuda" (FMG(2, 2, 2), relaxed to the coarsest level: wrap
    storage, the slab and the dense leg), and the same with `--domain
    1.5` (padded storage: row 16's chunks, the conversions and the leg);
    then at 1025^2 the CLI's other cycles: `--kind v --cycles 3`,
    `--kind w --mu 2 --cycles 3` in both storages, and `--coarsest exact`
    (wrap: fast diagonalization on 64^2).  Each: finite residuals,
    error_linf under max(10 h, 5e-5), the plan's kernels launched and no
    other.  Returns (launch counts by path, summaries)."""
    from pde_multigrid_tpu_torch.__main__ import main as cli_main

    counts_by, out = {}, []
    pad = ["--domain", str(P2D_PADDED_HI)]
    for n, extra, store in (
            (P2D_N, [], "wrap"), (P2D_N, pad, "padded"),
            (1025, ["--kind", "v", "--cycles", "3"], "wrap"),
            (1025, ["--kind", "w", "--mu", "2", "--cycles", "3"], "wrap"),
            (1025, ["--kind", "w", "--mu", "2", "--cycles", "3", *pad],
             "padded"),
            (1025, ["--coarsest", "exact"], "wrap")):
        args = ["--problem", "poisson2d", "--n", str(n), *extra,
                "--device", "cuda"]
        buf = io.StringIO()
        torch.cuda.synchronize()
        reset_counts()
        with contextlib.redirect_stdout(buf), \
                contextlib.redirect_stderr(io.StringIO()):
            cli_main(args)
        res = json.loads(buf.getvalue().strip().splitlines()[-1])
        hi = P2D_PADDED_HI if store == "padded" else 1.0
        limit = max(10 * hi / (n - 1), 5e-5)
        tag = f"CLI {' '.join(args)}"
        launched = {k: c for k, c in read_counts().items() if c}
        log(f"{tag}: error_linf {res['error_linf']!r} (limit {limit!r}), "
            f"residual_l2 {res['residual_l2']!r}, solve "
            f"{res['wall_time_s']!r} s, launches {launched}")
        require(res["error_linf"] < limit and not res["diverged"] and all(
            x == x and abs(x) != float("inf")
            for x in res["residual_history"]), f"{tag}: failed its gate")
        counts = _check_counts(tag, f"poisson2d_{store}")
        if n == P2D_N:
            counts_by[f"poisson2d_{store}"] = counts
        out.append({"cli": args, "error_linf": res["error_linf"],
                    "residual_l2": res["residual_l2"],
                    "wall_time_s": res["wall_time_s"], "launches": launched})
    return counts_by, out


def phase_wcycle2d(torch):
    """One W-cycle (mu = 2, nu = (4, 4), relaxed to the coarsest level) of
    every 2D and 1D plan on the card, from the initial level, against the
    plain tensor tier on the card (`cycles.TorchKernels`, the same
    schedule): 2D Poisson at 513^2 in wrap storage (the slab's leg on
    512^2, the dense leg below) and in padded storage (row 16's chunks on
    the persistent halves of 513^2, whose visits a W-cycle orders as no
    V-cycle does; the leg below), 2D Lyapunov at 513^2 (the same halves),
    HJB at 513^2 in FAS (the slab, the HJB leg) and Ode1D at 1025 points
    (relax1d).  Each: the plan's kernels launched and no other, finite
    residuals, max|v - v_plain| under 1e-4 of max(1, max|v_plain|) (the
    kernels round as the Pallas forms do, the plain tier as the jnp one;
    both float32).  Returns the summaries."""
    from pde_multigrid_tpu_torch import (
        CycleConfig,
        HJBMinTime,
        Lyapunov2D,
        MultigridSolver,
        Ode1D,
        SolverConfig,
    )
    from pde_multigrid_tpu_torch.cycles import CycleProgram, TorchKernels

    out = []
    for name, prob, n, kw in (
            ("poisson2d_wrap", _p2d_problem(True), 513, {}),
            ("poisson2d_padded", _p2d_problem(False), 513, {}),
            ("lyapunov", Lyapunov2D(), 513, {}),
            ("hjb", HJBMinTime(), 513, {"scheme": "fas"}),
            ("ode1d", Ode1D(), 1025, {})):
        cyc = CycleConfig("w", 1, 4, 4, 2, coarsest="relax", **kw)
        solver = MultigridSolver(prob, n, SolverConfig(cycle=cyc),
                                 device="cuda")
        torch.cuda.synchronize()
        reset_counts()
        lv = solver.program.solve_step(solver.fresh_levels())
        torch.cuda.synchronize()
        tag = f"W-cycle {name} {n}"
        counts = _check_counts(tag, f"wcycle_{name}")
        plain = CycleProgram(prob, solver.geoms, cyc,
                             TorchKernels(prob, solver.geoms),
                             device=solver.device)
        pl = plain.solve_step(solver.fresh_levels())
        v, vp = lv[0].v, pl[0].v
        dv = _max_err(torch, v, vp)
        scale = max(1.0, float(torch.max(torch.abs(vp))))
        l2, _ = solver.program.residual_norms(lv)
        l2p, _ = plain.residual_norms(pl)
        l2, l2p = float(l2), float(l2p)
        mine = {k: counts[k] for k in PATHS[f"wcycle_{name}"]}
        log(f"{tag}: launches {mine}, residual_l2 {l2!r} (plain tier "
            f"{l2p!r}), max|v - v_plain| {dv!r} (limit {1e-4 * scale!r})")
        require(l2 == l2 and abs(l2) != float("inf")
                and dv <= 1e-4 * scale,
                f"{tag}: outside the plain tier's gate")
        out.append({"w_cycle": name, "n": n, "residual_l2": l2,
                    "plain_residual_l2": l2p, "max_abs_dv_vs_plain": dv,
                    "launches": mine})
        del solver, lv, pl
    return out


P3D_NS = (257, 513)
P3D_NUS = (2, 100, 100)
# the domain's upper bound: sin(1.5 pi) = -1 on the far faces, a nonzero
# boundary, so the solver builds the padded hierarchy
P3D_HI = 1.5
# the sweep counts each padded form is held at: 1, 2, 3 (T, T + 1, T + 2
# of the leg's cycle of two copies, a sweep, and of the half-sweep
# kernel's pair of launches through the scratch, a sweep) and a bench leg
P3D_SWEEPS = (1, 2, 3, 100)
# ms of the padded forms by level (phase_kernels_poisson3d_padded)
P3D_AB = {}


def _p3d_problem():
    """Poisson(3) on [0, P3D_HI]^3: a nonzero boundary, padded storage."""
    from pde_multigrid_tpu_torch import Poisson3D

    return Poisson3D(((0.0, P3D_HI),) * 3)


def _p3d_cost(g, nsweeps: int):
    """(bytes, operations) of `nsweeps` red-black sweeps on a padded 3D
    level: v and f read once and v written once, 12 B a point, and 13
    float32 operations an interior point and sweep (three pair sums,
    three products, three sums, the negation, the scale, the blend's
    difference and sum)."""
    X, Y, Z = g.shape
    return 12 * X * Y * Z, 13 * (X - 2) * (Y - 2) * (Z - 2) * nsweeps


def phase_kernels_poisson3d_padded(torch):
    """The padded 3D Poisson forms of rows 1 and 3 against their plain
    version `padded3d.sweeps_plain` on the card, bitwise (torch.equal),
    on every level of the 513^3 padded hierarchy in the form the plan
    gives it (`CudaKernels.tiers`): 513^3, 257^3 and 129^3 the half-sweep
    kernel (`slab3d.slab3d_relax`, two launches a sweep), 65^3 ... 3^3
    the whole leg (`padded3d.padded3d_relax`, one launch a leg), at
    P3D_SWEEPS sweeps with f and at 3 and 100 f-less, from v and f
    N(0, 1) everywhere (the boundary values nonzero: they must come out
    as they went in).  A 100-sweep leg of every level's form
    graph-replayed (ms into P3D_AB by level); the records: padded3d a
    100-sweep leg at 65^3, slab3d one sweep (a red and a black launch
    through the scratch, as in the solver's legs) at 513^3, each beside
    its plain version in turns (graph replay).  Returns {name: record}."""
    from pde_multigrid_tpu_torch.grid import build_geometries
    from pde_multigrid_tpu_torch.ops.cuda import padded3d as PD
    from pde_multigrid_tpu_torch.ops.cuda import slab3d as SB
    from pde_multigrid_tpu_torch.ops.cuda.dispatch import CudaKernels

    prob = _p3d_problem()
    geoms = build_geometries((P3D_NS[-1],) * 3, prob.domain, wrap=False)
    kern = CudaKernels(prob, geoms, torch.float32)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2027)
    nsw = P3D_SWEEPS[-1]
    legs = P3D_AB.setdefault(f"leg_{nsw}_ms", {})
    out = {}

    def record(name, err, t, what, cost):
        res = {"max_abs_err": err, "ms": t["ms"], "plain_ms": t["plain_ms"],
               **bound(*cost), "library_ms": None}
        log(f"kernel {name} ({what}): max|kernel - plain| = {err!r}; device "
            f"{t['ms']!r} ms vs plain {t['plain_ms']!r} ms (bound "
            f"{res['bound_ms']!r} ms by {res['bound_by']}); eager call "
            f"{t['eager_ms']!r} ms vs plain {t['eager_plain_ms']!r} ms")
        return res

    for l, g in enumerate(geoms):
        n = g.shape[0]
        v = torch.randn(g.shape, generator=gen, device="cuda")
        f = torch.randn(g.shape, generator=gen, device="cuda")
        m_red, m_black = PD.masks(*g.shape, torch.float32, "cuda")
        fixed = (m_red + m_black) == 0
        if kern.tiers[l] == "padded3d":
            lay = PD.leg_layout(g)
            relax = lambda w, ff, ns, g=g: PD.padded3d_relax(  # noqa: E731
                w, ff, ns, prob, g)
            tag = (f"padded3d {n}^3 ({lay.nctas} CTA(s) of {lay.threads} "
                   f"threads, {lay.planes} plane(s) x {lay.slots} slot(s) a "
                   f"thread, instance <{lay.pm}, {lay.jm}>, "
                   f"{lay.smem_bytes} B of shared memory)")
        else:
            require(kern.tiers[l] == "slab3d",
                    f"{n}^3: not a planned padded form ({kern.tiers[l]})")
            scratch = torch.empty_like(v)
            relax = lambda w, ff, ns, g=g, s_=scratch: (  # noqa: E731
                SB.slab3d_relax(w, ff, ns, prob, g, scratch=s_))
            tag = f"slab3d {n}^3 (a launch a colour half-sweep)"
        err = 0.0
        for ff, fl in ((f, "f"), (None, "f-less")):
            for ns in P3D_SWEEPS:
                if ff is None and ns not in (3, nsw):
                    continue
                k = relax(v.clone(), ff, ns)
                p = PD.sweeps_plain(v, ff, ns, prob, g)
                err = max(err, _max_err(torch, k, p))
                require(torch.equal(k, p), f"{tag}, {fl}, {ns} sweeps: not "
                        f"bitwise its plain version: max diff "
                        f"{_max_err(torch, k, p)!r}")
                require(torch.equal(k[fixed], v[fixed]),
                        f"{tag}, {fl}, {ns} sweeps: a boundary point changed")
                del k, p
        w = v.clone()
        legs[n] = device_ms(torch, lambda: relax(w, f, nsw), 1)
        if n == 65 and kern.tiers[l] == "padded3d":
            t = paired_times(torch, lambda: relax(w, f, nsw),
                             lambda: PD.sweeps_plain(v, f, nsw, prob, g), 1)
            out["padded3d"] = record("padded3d", err, t,
                                     f"{tag}: one {nsw}-sweep leg",
                                     _p3d_cost(g, nsw))
        if l == 0:
            t = paired_times(torch, lambda: relax(w, f, 1),
                             lambda: PD.sweeps_plain(v, f, 1, prob, g), 3)
            out["slab3d"] = record("slab3d", err, t,
                                   f"{tag}: one sweep (two launches)",
                                   _p3d_cost(g, 1))
        log(f"{tag}: bitwise; a {nsw}-sweep leg {legs[n]!r} ms "
            f"({legs[n] / (2 * nsw) * 1e3!r} us a half-sweep)")
        del v, f, w, fixed
    torch.cuda.synchronize()
    return out


def poisson3d_padded_launches(solver) -> dict:
    """The relax launches of one FMG step of the padded 3D plan: level l
    takes nu0 (l + 1) V-cycles, each a nu1 and a nu2 leg: one launch of
    the whole leg on its levels, two launches a sweep (red, black) of the
    half-sweep kernel on the others."""
    kern = solver.program.kernels
    cyc = solver.config.cycle
    want = {"padded3d": 0, "slab3d": 0}
    for l, tier in enumerate(kern.tiers):
        if tier is None:
            continue
        cycles = cyc.nu0 * (l + 1)
        if tier == "padded3d":
            want["padded3d"] += 2 * cycles
        else:
            want["slab3d"] += 2 * cycles * (cyc.nu1 + cyc.nu2)
    return want


def _p3d_solve(torch, n: int, timing: bool):
    """FMG(2, 100, 100) exact-coarsest f32 at n^3 on [0, 1.5]^3 through
    `MultigridSolver.solve()` on "cuda": the padded hierarchy, every
    relaxed level on a padded form, error_linf < 50 h^2, exactly the
    schedule's launches and no other kernel; with `timing`, ms a step
    eager and as one CUDA graph and the busy split.  Returns (launch
    counts, summary, solution)."""
    from pde_multigrid_tpu_torch import (
        CycleConfig,
        MultigridSolver,
        SolverConfig,
    )

    prob = _p3d_problem()
    cfg = SolverConfig(cycle=CycleConfig("fmg", *P3D_NUS, coarsest="exact"))
    solver = MultigridSolver(prob, n, cfg, device="cuda")
    kern = solver.program.kernels
    tag = f"poisson3d padded {n}^3"
    relaxed = [t for t in kern.tiers if t is not None]
    require(not solver.geoms[0].wrap and relaxed
            and set(relaxed) <= {"padded3d", "slab3d"}
            and kern._relax[-1] is None,
            f"{tag}: the plan {kern.tiers} is not the padded forms' (wrap "
            f"{solver.geoms[0].wrap})")
    levels = solver.fresh_levels()
    torch.cuda.synchronize()
    reset_counts()
    res = solver.solve(levels)
    h = max(solver.geoms[0].spacing)
    want = poisson3d_padded_launches(solver)
    log(f"{tag}: levels {[g.shape for g in solver.geoms]}, tiers "
        f"{kern.tiers}, error_linf {res.error_linf!r} (limit 50 h^2 = "
        f"{50 * h * h!r}), residual_l2 {res.residual_l2!r}, residual_linf "
        f"{res.residual_linf!r}, launches {read_counts()}; the schedule's "
        f"{want}")
    counts = _check_solve(torch, tag, res, solver, 50 * h * h,
                          f"poisson3d_padded_{n}", want)
    summary = {"n": n, "problem": "poisson3d", "storage": "padded",
               "domain": [0.0, P3D_HI], "precision": "f32",
               "levels": [g.padded_shape for g in solver.geoms],
               "tiers": kern.tiers, "error_linf": res.error_linf,
               "residual_l2": res.residual_l2, "launches_per_step": want,
               "sha256": _sha(res.v)}
    v = res.v.clone()
    if timing:
        summary.update(time_step(torch, tag, solver, levels, 1, 1))
        busy = busy_split_ms(
            torch, lambda: solver.program.solve_step(levels),
            {"padded3d": "padded3d_leg_kernel",
             "slab3d": "slab3d_half_sweep_kernel"})
        summary["busy_ms"] = busy
        log(f"{tag}: device busy ms per step by kernel (profiler) {busy!r}")
    return counts, summary, v


def phase_poisson3d_padded(torch):
    """3D Poisson in padded storage: FMG(2, 100, 100) exact-coarsest at
    257^3 and 513^3 (`_p3d_solve`, timed), the mixed plan at 257^3 (the
    same kernels, float32: no defect plan covers a padded level), at
    129^3 the f32 solve against the float64 solve of the same schedule on
    the card (plain tier): the error_linf gap within 1 % and max|v -
    v_float64| within ANIS_F32_ULPS ulp of max|v|, the float32 floor; and
    at 65^3 one W-cycle (mu = 2) and one FAS V-cycle (nu = (4, 4),
    relaxed to 3^3) against the plain tier on the card: the leg launched
    and no other kernel, v bitwise the plain tier's (the same blend, the
    same plain transfers).  Returns (launch counts by path,
    summaries)."""
    from pde_multigrid_tpu_torch import (
        CycleConfig,
        MultigridSolver,
        SolverConfig,
    )
    from pde_multigrid_tpu_torch.cycles import CycleProgram, TorchKernels

    counts_by, out = {}, []
    for n in P3D_NS:
        counts_by[f"poisson3d_padded_{n}"], summary, v = _p3d_solve(
            torch, n, True)
        out.append(summary)
        del v
    prob = _p3d_problem()
    mixed = MultigridSolver(prob, P3D_NS[0], SolverConfig(
        cycle=CycleConfig("fmg", *P3D_NUS, coarsest="exact"),
        precision="mixed"), device="cuda").program.kernels
    require(all(d is None for d in mixed._defect)
            and mixed.tiers == out[0]["tiers"],
            f"mixed {P3D_NS[0]}^3: tiers {mixed.tiers}, defect plans "
            f"{mixed._defect}")
    log(f"mixed {P3D_NS[0]}^3: the f32 plan {mixed.tiers}, no defect form")
    _, s129, v129 = _p3d_solve(torch, 129, False)
    phase_f64_reference(
        torch, prob, 129, P3D_NUS, s129, v129, "poisson3d padded 129^3",
        dv_limit=ANIS_F32_ULPS * 2.0 ** -23 * float(torch.max(torch.abs(
            v129))))
    out.append(s129)
    for name, cyc in (
            ("wcycle_poisson3d_padded",
             CycleConfig("w", 1, 4, 4, 2, coarsest="relax")),
            ("fas_poisson3d_padded",
             CycleConfig("v", 1, 4, 4, scheme="fas", coarsest="relax"))):
        solver = MultigridSolver(prob, 65, SolverConfig(cycle=cyc),
                                 device="cuda")
        torch.cuda.synchronize()
        reset_counts()
        lv = solver.program.solve_step(solver.fresh_levels())
        torch.cuda.synchronize()
        tag = f"{name} 65^3"
        counts = _check_counts(tag, name)
        plain = CycleProgram(prob, solver.geoms, cyc,
                             TorchKernels(prob, solver.geoms),
                             device=solver.device)
        pl = plain.solve_step(solver.fresh_levels())
        dv = _max_err(torch, lv[0].v, pl[0].v)
        l2, _ = solver.program.residual_norms(lv)
        l2p, _ = plain.residual_norms(pl)
        l2, l2p = float(l2), float(l2p)
        same = torch.equal(lv[0].v, pl[0].v)
        log(f"{tag}: launches {counts['padded3d']} padded3d, residual_l2 "
            f"{l2!r} (plain tier {l2p!r}), max|v - v_plain| {dv!r}, "
            f"bitwise: {same}")
        require(l2 == l2 and abs(l2) != float("inf") and same,
                f"{tag}: not bitwise the plain tier's solution")
        out.append({"cycle": name, "n": 65, "residual_l2": l2,
                    "plain_residual_l2": l2p, "max_abs_dv_vs_plain": dv,
                    "launches": counts["padded3d"]})
        del solver, lv, pl
    return counts_by, out


def phase_poisson3d_padded_cli(torch):
    """`python -m pde_multigrid_tpu_torch --problem poisson3d --domain 1.5
    --n 257 --nu1 100 --nu2 100` in process on "cuda", with `--coarsest
    exact` (9^3 the dense inverse) and with the CLI's default relaxed
    coarsest level (the hierarchy to 3^3, the leg on 65^3 ... 3^3): finite
    residuals, error_linf < 50 h^2, both padded forms launched and no
    other kernel.  Returns (launch counts, summaries)."""
    from pde_multigrid_tpu_torch.__main__ import main as cli_main

    counts, out = {}, []
    n = 257
    for extra in (["--coarsest", "exact"], []):
        args = ["--problem", "poisson3d", "--domain", str(P3D_HI), "--n",
                str(n), "--nu1", "100", "--nu2", "100", *extra,
                "--device", "cuda"]
        buf = io.StringIO()
        torch.cuda.synchronize()
        reset_counts()
        with contextlib.redirect_stdout(buf), \
                contextlib.redirect_stderr(io.StringIO()):
            cli_main(args)
        res = json.loads(buf.getvalue().strip().splitlines()[-1])
        limit = 50 * (P3D_HI / (n - 1)) ** 2
        tag = f"CLI {' '.join(args)}"
        launched = {k: c for k, c in read_counts().items() if c}
        log(f"{tag}: error_linf {res['error_linf']!r} (limit {limit!r}), "
            f"residual_l2 {res['residual_l2']!r}, solve "
            f"{res['wall_time_s']!r} s, launches {launched}")
        require(res["error_linf"] < limit and not res["diverged"] and all(
            x == x and abs(x) != float("inf")
            for x in res["residual_history"]), f"{tag}: failed its gate")
        counts = _check_counts(tag, "poisson3d_padded_cli")
        out.append({"cli": args, "error_linf": res["error_linf"],
                    "residual_l2": res["residual_l2"],
                    "wall_time_s": res["wall_time_s"], "launches": launched})
    return counts, out


PHASE_S = {}


def timed(name, fn, *args, **kw):
    """fn(*args, **kw), its seconds logged as it ends and summed into
    PHASE_S under `name`."""
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    dt = time.perf_counter() - t0
    PHASE_S[name] = PHASE_S.get(name, 0.0) + dt
    log(f"phase {name}: {dt:.1f} s")
    return out


T0 = time.perf_counter()


def tables() -> dict:
    """The timing tables the phases fill, and each phase's seconds."""
    return {"barrier_floors": FLOORS, "timeskew_ab": TIMESKEW_AB,
            "subtree_ab": SUBTREE_AB, "shard2d_ab": SHARD2D_AB,
            "resident3d_ab": RESIDENT3D_AB, "fas_ab": FAS_AB,
            "masked_ab": MASKED_AB,
            "reduced_ab": REDUCED_AB, "blocked_ab": BLOCKED_AB,
            "lyap2d_ab": LYAP2D_AB, "error_ab": ERROR_AB,
            "hjb_leg_ms": HJB_LEG_MS, "hjb_slab_ms": HJB_SLAB_MS,
            "merge2d_ab": MERGE2D_AB, "transfer_ab": TRANSFER_AB,
            "residual_ab": RESIDUAL_AB,
            "relax1d_leg_ms": RELAX1D_LEG_MS,
            "line_ab": LINE_AB, "wcycle_ab": WCYCLE_AB,
            "poisson2d_ab": P2D_AB, "poisson3d_padded_ab": P3D_AB,
            "phase_s": PHASE_S}


def run_phases(names) -> int:
    """The card, the build, then each named phase alone (`phase_NAME`,
    which must take the torch module alone); their results (tensors by
    type name) and `tables()` as one JSON line, also written to
    chiprun_out/chip_smoke_phases.json.  Non-zero on any failure."""
    import inspect

    sys.path.insert(0, HERE)
    fns = {}
    for name in names:
        fn = globals().get(f"phase_{name}")
        if fn is None or list(inspect.signature(fn).parameters) != ["torch"]:
            print(f"chip_smoke: no phase {name!r} that takes torch alone",
                  file=sys.stderr)
            return 2
        fns[name] = fn
    out = {}
    try:
        import torch

        phase_card(torch)
        timed("build", phase_build)
        for name, fn in fns.items():
            out[name] = timed(name, fn, torch)
    except Exception as e:
        traceback.print_exc()
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    text = json.dumps({"phases": out, **tables()},
                      default=lambda o: type(o).__name__)
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "chip_smoke_phases.json"),
              "w") as fh:
        fh.write(text)
    log(text)
    return 0


def main() -> int:
    sys.path.insert(0, HERE)
    witness = {}
    try:
        import torch

        card = phase_card(torch)
        # fails outside a checkout
        from pde_multigrid_tpu_torch import (
            HJBMinTime,
            Lyapunov2D,
            Ode1D,
            VariableCoefficientPoisson,
        )

        timed("build", phase_build)
        witness = start_rounding_witness()
        results = timed("kernels3d", phase_kernels, torch)
        results.update(timed("kernels_timeskew", phase_kernels_timeskew,
                             torch))
        results.update(timed("kernels_subtree", phase_kernels_subtree,
                             torch))
        timed("subtree_mu2", phase_subtree_mu2, torch)
        results.update(timed("kernels_line", phase_kernels_line, torch))
        results.update(timed("kernels_resident3d", phase_kernels_resident3d,
                             torch))
        results.update(timed("kernels_blocked3d", phase_kernels_blocked3d,
                             torch))
        results.update(timed("kernels_shard", phase_kernels_shard, torch))
        results.update(timed("kernels2d", phase_kernels2d, torch))
        results.update(timed("kernels_reduced2d", phase_kernels_reduced2d,
                             torch))
        summaries, counts = [], {}
        for n in (129, 257, 513):
            c32, s32, v32 = timed("poisson3d", phase_main_path, torch, n,
                                  "f32")
            cmx, smx, vmx = timed("poisson3d", phase_main_path, torch, n,
                                  "mixed")
            timed("poisson3d", phase_reference, torch, n,
                  {"f32": (s32, v32), "mixed": (smx, vmx)})
            summaries += [s32, smx]
            counts.setdefault(row_path(n, "f32"), c32)
            counts.setdefault(row_path(n, "mixed"), cmx)
            if n == SHARD_N:
                UNSHARDED["f32"] = (s32, v32)
                counts["f32_257_blocked"], sbl = timed(
                    "f32_257_blocked", phase_f32_257_blocked, torch, s32, v32)
                summaries.append(sbl)
            del v32, vmx
        counts["sharded257"], ssh, sha1 = timed("sharded", phase_sharded,
                                                torch)
        UNSHARDED.clear()
        ssh["ranks_2_4"] = timed("sharded_ranks", phase_sharded_ranks, torch,
                                 sha1)
        summaries.append(ssh)
        counts["sharded_fas"], ssf = timed("sharded_fas", phase_sharded_fas,
                                           torch)
        summaries.append(ssf)
        counts["preset129"], counts["preset257"], spre = timed(
            "preset3d", phase_preset3d, torch)
        summaries += [*spre, timed("preset3d", phase_subtree_identity,
                                   torch)]
        counts["anis3d"], san = timed("anis3d", phase_anis3d, torch)
        counts["wcycle129"], swc = timed("wcycle_cli", phase_wcycle_cli,
                                         torch)
        summaries += [san, swc]
        counts["fas257"], sfas = timed("fas3d_257", phase_fas3d_257, torch)
        summaries.append(sfas)
        counts["lyapunov"], sly, vly = timed("lyapunov", phase_lyapunov,
                                             torch)
        timed("lyapunov", phase_f64_reference, torch, Lyapunov2D(), LYAP_N,
              LYAP_NUS, sly, vly, f"lyapunov {LYAP_N}^2")
        summaries.append(sly)
        counts["lyapunov_reduced"], slr = timed(
            "lyapunov_reduced", phase_lyapunov_reduced, torch, sly, vly,
            counts["lyapunov"])
        summaries.append(slr)
        cpre, spre2 = timed("lyapunov_presets", phase_lyapunov_presets,
                            torch)
        counts.update(cpre)
        summaries += spre2
        results.update(timed("kernels_shard2d", phase_kernels_shard2d,
                             torch))
        counts["sharded_lyap"], ssl, sha2 = timed(
            "sharded2d", phase_sharded2d, torch, sly, vly)
        del vly
        ssl["ranks_2_4"] = timed("sharded2d_ranks", phase_sharded_ranks,
                                 torch, sha2, "lyapunov2d")
        summaries.append(ssl)
        results.update(timed("kernels1d", phase_kernels1d, torch))
        counts["ode1d"], sod, vod = timed("ode1d", phase_ode1d, torch)
        timed("ode1d", phase_f64_reference, torch, Ode1D(), ODE_N, ODE_NUS,
              sod, vod, f"ode1d {ODE_N}", ODE_F32_FLOOR)
        summaries += [sod, timed("ode1d", phase_ode1d_preset, torch),
                      timed("ode1d", phase_poisson1d, torch),
                      *timed("ode1d", phase_f32_floors, torch)]
        results.update(timed("kernels_hjb", phase_kernels_hjb, torch))
        counts["hjb"], shj, vhj = timed("hjb", phase_hjb, torch)
        timed("hjb", phase_f64_reference, torch, HJBMinTime(), HJB_N,
              HJB_NUS, shj, vhj, f"hjb2d {HJB_N}^2",
              cycle_kw={"scheme": "fas", "coarsest": "relax"},
              dv_limit=HJB_DV_LIMIT)
        summaries.append(shj)
        results.update(timed("kernels_poisson2d", phase_kernels_poisson2d,
                             torch))
        cp2, sp2 = timed("poisson2d", phase_poisson2d, torch)
        counts.update(cp2)
        summaries += sp2
        summaries += timed("poisson2d_cli", phase_poisson2d_cli, torch)[1]
        summaries += timed("wcycle2d", phase_wcycle2d, torch)
        results.update(timed("kernels_poisson3d_padded",
                             phase_kernels_poisson3d_padded, torch))
        cp3, sp3 = timed("poisson3d_padded", phase_poisson3d_padded, torch)
        counts.update(cp3)
        summaries += sp3
        summaries += timed("poisson3d_padded_cli",
                           phase_poisson3d_padded_cli, torch)[1]
        summaries.append(timed("fas3d", phase_fas3d, torch))
        results.update(timed("kernels_stencil", phase_kernels_stencil,
                             torch))
        counts["varcoef"], svc, vvc = timed("varcoef", phase_varcoef, torch)
        timed("varcoef", phase_f64_reference, torch,
              VariableCoefficientPoisson(2), VARCOEF_N, VARCOEF_NUS, svc,
              vvc, f"varcoef2d {VARCOEF_N}^2", VARCOEF_F32_FLOOR, wrap=True,
              err64_limit=50 * (1.0 / (VARCOEF_N - 1)) ** 2,
              cycle_kw=VARCOEF_CYCLE, dv_limit=0.0)
        summaries.append(svc)
        # last: the float64 children have run beside every phase above
        summaries.append(timed("rounding", phase_rounding, torch, witness))
    except Exception as e:  # report any phase's failure, then fail
        traceback.print_exc()
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        for proc in witness.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        # the one-rank group of the sharded phase
        dist = sys.modules.get("torch.distributed")
        if dist is not None and dist.is_initialized():
            dist.destroy_process_group()
    # launches: each kernel's count from the solve of the path it serves
    # (the 3D kernels' from the 129^3 solves: the bench's default
    # precision, mixed, for the defect trio and the transfers, f32 for the
    # f32 split relax; row 10's wavefront error mode from the 257^3 mixed
    # solve, its half-sweep chain from the 129^3 one (0: no bench level
    # fits neither form); the wavefront's from the 257^3 f32 solve (row 11,
    # 256^3) and the 513^3 one (row 13, 512^3); the 2D kernels' from the
    # 4097^2 Lyapunov solve; relax1d's from the ode1d 8193 solve; slab2d's
    # and resident_hjb's from the hjb2d 513^2 solve; the stencil kernels'
    # from the varcoef2d 1025^2 solve; the subtree kernel's and rows 23
    # and 24's from the --preset poisson3d solve; the per-shard chunks'
    # from the sharded solves: rows 6 and 12 the 257^3 one, row 17 the
    # 4097^2 Lyapunov one, each over one rank; the whole-leg 3D resident
    # kernel's from the FAS 257^3 solve, where its halves mode, which no
    # plan selects (as in JAX), launches 0 times)
    # row 16's record counts the chunk's launches on the unsharded
    # Lyapunov path, row 17's on the sharded one
    off_path = {"split_merged": "fas257", "color_slab2d": "lyapunov",
                "color_slab2d_shard": "sharded_lyap", "error_sweep": "mixed"}
    counter = {"color_slab2d": "color_slab2d_shard"}

    def path_of(name):
        return off_path.get(name) or next(
            p for p in ("ode1d", "lyapunov", "hjb", "varcoef", "mixed",
                        "mixed_257", "f32", "f32_257", "f32_513",
                        "preset129", "fas257",
                        "sharded257", "sharded_lyap", "lyapunov_reduced",
                        "f32_257_blocked", "anis3d", "poisson2d_wrap",
                        "poisson2d_padded", "poisson3d_padded_513")
            if name in PATHS[p])

    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": counts[path_of(name)][counter.get(name, name)],
         **results[name]}
        for name, (src, rep) in KERNELS.items()
    ]
    log(f"chip_smoke: {time.perf_counter() - T0:.1f} s")
    log(json.dumps({"card": card, "main_path": summaries, **tables()}))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(run_phases(sys.argv[1:]) if sys.argv[1:] else main())
