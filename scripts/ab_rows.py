#!/usr/bin/env python3
"""A/B of rows of the port between two checkouts, on one card, in turns.

    python3 scripts/ab_rows.py PARENT_DIR CHANGE_DIR ROW [ROW ...]

A ROW is
  mixed:N   `chip_smoke.phase_main_path(torch, N, "mixed")`: the 3D row at
            N^3, FMG(2, 100, 100), exact coarsest, the solve with its gate
            and launch checks, ms a step eager and as one CUDA graph;
  f32:N     the same in precision "f32";
  transfers rows 25 and 26 (`transfer.residual_restrict` with and without
            the residual, `transfer.prolong_blend` add and replace in
            place) timed graph-replayed on every fine level of the 513^3
            path (512^3 ... 128^3), on 64^3 and on the sub-lane pairs
            (32^3 ... 4^3) and a non-cubic pair, the SHA-256 of their
            outputs on seeded inputs, and the launches by fine level
            (`transfer.launches_by_fine`) of one step of the 129^3, 257^3
            and 513^3 f32 rows, the FAS 257^3 row and the two 3D presets;
  residual  row 27 (`transfer.residual`) timed graph-replayed on every
            level of the 513^3 path and of FAS 257^3 (512^3 ... 2^3), a
            non-cubic and a non-power-of-two level, with f and f-less as
            FAS's coarse right side takes it (`transfer.residual_zero_f`
            where the side has it, else the residual of a zeros_like f,
            the fill included), the SHA-256 of their outputs on seeded
            inputs, and the residual launches by level of one FAS 257^3
            step (`transfer.launches_by_fine`);
  varcoef   `chip_smoke.phase_kernels_stencil(torch)` then
            `chip_smoke.phase_varcoef(torch)`: the varcoef2d 1025^2
            Galerkin row (its gate, the plan's launches, ms a step, the
            busy split) and a 40-sweep leg of each level's planned kernel;
  stencil   a 40-sweep leg of `plan_stencil_relax`'s kernel, timed
            graph-replayed, on every level of the Galerkin varcoef1d 1025,
            Poisson(3) 33 and varcoef3d 33 hierarchies and on an odd 2D
            (65^2, K = 9) and a padded 3D (33^3, K = 7) level with random
            coefficients;
  fas257    `chip_smoke.phase_fas3d_257(torch)`: the 3D FAS row at 257^3
            (its gate, `fas_launches`, ms a step eager and as one CUDA
            graph, the same step with the resident kernel's levels on the
            half-sweeps, `row9_below_128` and `row9_at_64`), the SHA-256
            of a fresh solve's solution;
  sharded257  `chip_smoke.phase_main_path(torch, 257, "f32")` (the
            unsharded solve it is held against), then
            `chip_smoke.phase_sharded(torch)`: the 257^3 row on `--mesh 1`
            (its gate, `sharded_launches`, ms a step eager and as one CUDA
            graph), the SHA-256 of its logical solution;
  hjb       `chip_smoke.phase_kernels_hjb(torch)` then
            `chip_smoke.phase_hjb(torch)`: the HJB 513^2 FAS row (its gate,
            the plan's launches, ms a step eager and as one CUDA graph, the
            busy split), a 30-sweep leg of the HJB leg kernel on every
            level from 257^2 to 3^2 and of the slab kernel (row 3,
            `slab2d.slab_relax`) at 513^2 and 1025^2, eight more samples
            of the graph step (two steps a graph) and their median, the
            solution's SHA-256;
  merge2d   row 15 (`relax2d.from_halves`) timed graph-replayed on every
            split level of the Lyapunov 4097^2 path (4097^2 ... 513^2) and
            on two odd non-square shapes, the merges one default 4097^2
            FMG(2, 500, 500) step makes by level (its `from_halves` calls
            counted) and their ms a step, the SHA-256 of the merged levels;
  sharded2d `chip_smoke.phase_lyapunov(torch)` (the unsharded solve it is
            held against), then `chip_smoke.phase_sharded2d(torch, ...)`:
            the 4097^2 Lyapunov row on `--mesh 1` (its gate, launches, ms a
            step eager and as one CUDA graph), the SHA-256 of its logical
            solution;
  ode1d     `chip_smoke.phase_kernels1d(torch)`, `phase_ode1d(torch)` and
            `phase_ode1d_preset(torch)`: the ode1d 8193 row (its gate, 12
            launches, ms a step, the busy split), `--preset ode1d` (364
            launches, its gate) and a 1000-sweep relax1d leg on every level
            of the preset's hierarchy (Ode1D 16385 to 3) and on Poisson(1)
            at 8193 and 16385, the row's solution's SHA-256;
  resident3d  a 100-sweep dense leg of the whole-leg 3D resident kernel
            (`merged_resident_relax`, or `resident3d_relax` off the merged
            gate) on every level of 65^3, timed graph-replayed, and the
            SHA-256 of the legs' results on seeded inputs;
  reduced   `chip_smoke.phase_lyapunov(torch)` (the default 4097^2
            Lyapunov solve, row 16), `phase_kernels_reduced2d(torch)` and
            `phase_lyapunov_reduced(torch, ...)` (the same solve with the
            reduced opt-in, row 18: its gate, launches, ms a step), a chunk
            of row 18 timed on every level the plan reduces (4097^2 ...
            513^2, at its T and the legs' remainder, with and without f),
            and the SHA-256 of both solutions;
  subtree   row 22's V-cycle (`subtree.subtree_vcycle`, mu = 1, the root
            relaxed) at nu = 3000 and nu = (2, 3) on every root of the
            65^3 wrap hierarchy (64^3 ... 2^3), timed graph-replayed, and
            the SHA-256 of the results on seeded inputs;
  blocked   `chip_smoke.phase_main_path(torch, 257, "f32")` (the
            wavefront solve), `phase_kernels_blocked3d(torch)` and
            `phase_f32_257_blocked(torch, ...)` (the same solve with
            PDE_MG_TIMESKEW=0, row 19: its gate, launches, ms a step), a
            T = 1 launch of row 19 timed at 256^3 and 512^3, and the
            SHA-256 of both solutions.
Each side runs every ROW in its own process with its own kernels build,
in the order PARENT, CHANGE, CHANGE, PARENT, and prints one `AB` JSON line
a row (its summary, launch counts and the result's SHA-256).  Then one
line a row: whether every side's result is bitwise the first parent
run's, and the mean of each side for every number in the summaries.
Every `AB` line and every row's line also go to
chiprun_out/ab_rows.jsonl, whole, for runs whose printed output is kept
only in part.
Exits 1 if any side failed or a result differs.  Imports nothing of JAX;
needs a CUDA card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

SIDE = r"""
import hashlib, json, sys, torch
sys.path.insert(0, ".")
import chip_smoke as c


def sha(*ts):
    h = hashlib.sha256()
    for t in ts:
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()


def stencil_row():
    import numpy as np
    from pde_multigrid_tpu_torch import (Poisson, VariableCoefficientPoisson,
                                         grid as TG)
    from pde_multigrid_tpu_torch.ops.cuda import stencilop as SO
    from pde_multigrid_tpu_torch.ops.galerkin import neighborhood_offsets

    rng = np.random.default_rng(2029)
    cases = []
    for prob, n in ((VariableCoefficientPoisson(1), 1025), (Poisson(3), 33),
                    (VariableCoefficientPoisson(3), 33)):
        s = c._galerkin_solver(prob, n)
        for g, o, lvl in zip(s.geoms, s.program.kernels.offsets,
                             s.fresh_levels()):
            cases.append((f"{prob.name} {g.padded_shape}", g, o,
                          lvl.aux["stencil_coeffs"]))
    for shape, K in (((65, 65), 9), ((33,) * 3, 7)):
        g = TG.build_geometries(shape, ((0.0, 1.0),) * len(shape), 1)[0]
        o = tuple(x for x in neighborhood_offsets(len(shape))
                  if K == 3 ** len(shape) or sum(map(abs, x)) <= 1)
        cc = -rng.random(g.padded_shape + (K,)).astype(np.float32)
        cc[..., o.index((0,) * len(shape))] = 2.0 * K  # a bounded leg
        cases.append((f"random {g.padded_shape} K {K}", g, o,
                      torch.tensor(cc, device="cuda")))
    summary, outs = {}, []
    for tag, g, o, cc in cases:
        plan = SO.plan_stencil_relax(o, g)
        v, f = (torch.tensor(rng.standard_normal(g.padded_shape).astype(
            np.float32), device="cuda") for _ in range(2))
        outs.append(plan(v.clone(), f, cc, 40))
        w = v.clone()
        summary[tag] = {"plan": repr(plan), "ms": c.device_ms(
            torch, lambda: plan(w, f, cc, 40), 3)}
    return {}, summary, sha(*outs)


def resident3d_row():
    import numpy as np
    from pde_multigrid_tpu_torch.grid import build_geometries, wrap_interior
    from pde_multigrid_tpu_torch.models import Poisson3D
    from pde_multigrid_tpu_torch.ops.cuda import resident3d as RS3

    prob = Poisson3D()
    rng = np.random.default_rng(2031)
    summary, outs = {}, []
    for g in build_geometries((65,) * 3, prob.domain, wrap=True):
        fn = (RS3.merged_resident_relax if RS3.merged_gate(g)
              else RS3.resident3d_relax)
        shape = g.padded_shape
        v = torch.tensor((rng.standard_normal(shape) * wrap_interior(shape))
                         .astype(np.float32), device="cuda")
        f = torch.tensor(rng.standard_normal(shape).astype(np.float32),
                         device="cuda")
        outs.append(fn(v.clone(), f, 100, prob, g))
        w = v.clone()
        summary[f"{shape[0]}^3"] = {"ms": c.device_ms(
            torch, lambda: fn(w, f, 100, prob, g), 3)}
    return {}, summary, sha(*outs)


def subtree_row():
    import numpy as np
    from pde_multigrid_tpu_torch.grid import build_geometries, wrap_interior
    from pde_multigrid_tpu_torch.models import Poisson3D
    from pde_multigrid_tpu_torch.ops.cuda import subtree as S

    prob = Poisson3D()
    geoms = build_geometries((65,) * 3, prob.domain, wrap=True)
    rng = np.random.default_rng(2047)
    summary, outs = {}, []
    for l, g in enumerate(geoms):
        shape = g.padded_shape
        v = torch.tensor((rng.standard_normal(shape) * wrap_interior(shape))
                         .astype(np.float32), device="cuda")
        f = torch.tensor(rng.standard_normal(shape).astype(np.float32),
                         device="cuda")
        for nu1, nu2 in ((3000, 3000), (2, 3)):
            outs.append(S.subtree_vcycle(v.clone(), f, prob, geoms[l:], nu1,
                                         nu2))
            w = v.clone()
            summary[f"{shape[0]}^3 nu=({nu1},{nu2})"] = {"ms": c.device_ms(
                torch, lambda: S.subtree_vcycle(w, f, prob, geoms[l:], nu1,
                                                nu2), 1 if nu1 > 100 else 20)}
    return {}, summary, sha(*outs)


def hjb_legs():
    import numpy as np
    from pde_multigrid_tpu_torch.grid import build_geometries
    from pde_multigrid_tpu_torch.models import HJBMinTime
    from pde_multigrid_tpu_torch.ops.cuda import resident as RS

    prob = HJBMinTime()
    rng = np.random.default_rng(2033)
    out = {}
    for g in build_geometries((513, 513), prob.domain)[1:]:
        v, f, _ = c._hjb_inputs(torch, rng, prob, g)
        out[f"{g.padded_shape[0]}^2"] = c.device_ms(
            torch, lambda: RS.resident_relax(v, f, 30, prob, g), 3)
    return out


def slab_legs():
    import numpy as np
    from pde_multigrid_tpu_torch.grid import build_geometries
    from pde_multigrid_tpu_torch.models import HJBMinTime
    from pde_multigrid_tpu_torch.ops.cuda import slab2d as SL

    prob = HJBMinTime()
    rng = np.random.default_rng(2054)
    out = {}
    for n in (513, 1025):
        g = build_geometries((n, n), prob.domain, 1)[0]
        v, f, _ = c._hjb_inputs(torch, rng, prob, g)
        out[f"{n}^2"] = c.device_ms(
            torch, lambda: SL.slab_relax(v, f, 30, prob, g), 3)
    return out


def hjb_graph_runs():
    from pde_multigrid_tpu_torch import (CycleConfig, HJBMinTime,
                                         MultigridSolver, SolverConfig)

    solver = MultigridSolver(HJBMinTime(), c.HJB_N, SolverConfig(
        cycle=CycleConfig("fmg", *c.HJB_NUS, scheme="fas",
                          coarsest="relax")), device="cuda")
    levels = solver.fresh_levels()
    runs = [c.device_ms(torch, lambda: solver.program.solve_step(levels), 2)
            for _ in range(8)]
    return runs, sorted(runs)[len(runs) // 2 - 1:len(runs) // 2 + 1]


def merge2d_row():
    import numpy as np
    from pde_multigrid_tpu_torch import (CycleConfig, Lyapunov2D,
                                         MultigridSolver, SolverConfig)
    from pde_multigrid_tpu_torch.ops.cuda import relax2d as R2

    solver = MultigridSolver(Lyapunov2D(), c.LYAP_N, SolverConfig(
        cycle=CycleConfig("fmg", *c.LYAP_NUS, coarsest="exact"),
        precision="mixed"), device="cuda")
    per_step, merge = {}, R2.from_halves

    def counted(r, b, out):
        key = f"{out.shape[0]}x{out.shape[1]}"
        per_step[key] = per_step.get(key, 0) + 1
        return merge(r, b, out)

    R2.from_halves = counted
    try:
        solver.solve()
    finally:
        R2.from_halves = merge
    rng = np.random.default_rng(2053)
    ms, outs = {}, []
    for X, Y in [(n, n) for n in (4097, 2049, 1025, 513)] + [
            (1025, 2047), (515, 333)]:
        r, b = (torch.tensor(rng.standard_normal((X, (Y + 1) // 2)).astype(
            np.float32), device="cuda") for _ in range(2))
        v = torch.empty((X, Y), device="cuda")
        R2.from_halves(r, b, v)
        outs.append(v.clone())
        ms[f"{X}x{Y}"] = c.device_ms(torch,
                                     lambda: R2.from_halves(r, b, v), 10)
    summary = {"ms": ms, "merges_per_step": per_step,
               "ms_per_step": sum(ms[k] * n for k, n in per_step.items())}
    return {}, summary, sha(*outs)


def relax1d_legs():
    import numpy as np
    from pde_multigrid_tpu_torch.grid import build_geometries
    from pde_multigrid_tpu_torch.models import Ode1D, Poisson
    from pde_multigrid_tpu_torch.ops.cuda import relax1d as R1

    rng = np.random.default_rng(2034)
    out = {}
    cases = [(Ode1D(), 2 ** k + 1, False) for k in range(14, 0, -1)]
    cases += [(Poisson(1), n, True) for n in (8193, 16385)]
    for prob, n, wrap in cases:
        g = build_geometries((n,), prob.domain, 1, wrap=wrap)[0]
        v, f = (torch.tensor(rng.standard_normal(g.padded_shape).astype(
            np.float32), device="cuda") for _ in range(2))
        out[f"{prob.name} {n}"] = c.device_ms(
            torch, lambda: R1.relax1d(v, f, 1000, prob, g), 3)
    return out


def reduced_row():
    import numpy as np
    from pde_multigrid_tpu_torch import (CycleConfig, Lyapunov2D,
                                         MultigridSolver, SolverConfig)
    from pde_multigrid_tpu_torch.grid import build_geometries
    from pde_multigrid_tpu_torch.ops.cuda import dispatch
    from pde_multigrid_tpu_torch.ops.cuda import reduced2d as RD

    counts_ly, sly, vly = c.phase_lyapunov(torch)
    c.phase_kernels_reduced2d(torch)
    counts, s = c.phase_lyapunov_reduced(torch, sly, vly, counts_ly)
    saved = dispatch.SPLIT2D_REDUCED
    dispatch.SPLIT2D_REDUCED = True
    try:
        solver = MultigridSolver(Lyapunov2D(), c.LYAP_N, SolverConfig(
            cycle=CycleConfig("fmg", *c.LYAP_NUS, coarsest="exact"),
            precision="mixed"), device="cuda")
    finally:
        dispatch.SPLIT2D_REDUCED = saved
    v = solver.solve().v
    rng = np.random.default_rng(2043)
    chunks, prob = {}, Lyapunov2D()
    for g in build_geometries((c.LYAP_N,) * 2, prob.domain, 4):
        n, T = g.shape[0], RD.chunk_sweeps(g)
        r, b, fr, fb = (torch.tensor(rng.standard_normal(
            (n, (n + 1) // 2)).astype(np.float32), device="cuda")
            for _ in range(4))
        ko = (torch.empty_like(r), torch.empty_like(b))
        for t in (T, c.LYAP_NUS[1] % T):
            for hf, fk in (((fr, fb), "f"), ((None, None), "no_f")):
                chunks[f"{n}^2 T={t} {fk}"] = c.device_ms(
                    torch, lambda t=t, hf=hf: RD.reduced_chunk(
                        r, b, *hf, t, prob, g, ko), 5)
    s["chunk_ms"] = chunks
    s["default"] = sly
    s["sha256_default"], s["sha256_reduced"] = sha(vly), sha(v)
    return counts, s, f"{sha(vly)} {sha(v)}"


def transfers_row():
    import numpy as np
    from pde_multigrid_tpu_torch import (CycleConfig, MultigridSolver,
                                         Poisson3D, SolverConfig)
    from pde_multigrid_tpu_torch.grid import build_geometries, wrap_interior
    from pde_multigrid_tpu_torch.ops.cuda import transfer as T

    prob = Poisson3D()
    rng = np.random.default_rng(2056)
    ms, digests = {}, []
    shapes = [(n,) * 3 for n in (512, 256, 128, 64, 32, 16, 8, 4)]
    for shape in shapes + [(64, 32, 128)]:
        gf, gc = build_geometries(tuple(n + 1 for n in shape),
                                  ((0.0, 1.0),) * 3, 2, wrap=True)
        cs = gc.padded_shape
        v = torch.tensor((rng.standard_normal(shape) * wrap_interior(shape))
                         .astype(np.float32), device="cuda")
        f = torch.tensor(rng.standard_normal(shape).astype(np.float32),
                         device="cuda")
        cc = torch.tensor((rng.standard_normal(cs) * wrap_interior(cs))
                          .astype(np.float32), device="cuda")
        tag = "x".join(map(str, shape))
        outs = []
        reps = 10 if shape[0] >= 256 else 50
        for name, fn in (
                ("residual_restrict", lambda: T.residual_restrict(
                    v, f, prob, gf, gc)),
                ("restrict", lambda: T.residual_restrict(
                    f, None, prob, gf, gc, with_residual=False))):
            outs.append(fn())
            ms[f"{name} {tag}"] = c.device_ms(torch, fn, reps)
        for mode in ("add", "replace"):
            w = v.clone()
            outs.append(T.prolong_blend(cc, w, mode, gc, gf, out=w).clone())
            ms[f"prolong_{mode} {tag}"] = c.device_ms(
                torch, lambda mode=mode: T.prolong_blend(
                    cc, w, mode, gc, gf, out=w), reps)
        digests.append(sha(*outs))
        del v, f, cc, w, outs
        torch.cuda.empty_cache()
    by_path = {}
    cfgs = {f"{n}^3 f32": (n, CycleConfig("fmg", 2, 100, 100,
                                         coarsest="exact"))
            for n in (129, 257, 513)}
    cfgs["fas 257^3"] = (c.FAS_N, c._fas_cfg().cycle)
    for n in (129, 257):
        cfgs[f"preset {n}^3"] = (n, CycleConfig("fmg", 2, 3000, 3000,
                                                coarsest="relax"))
    for key, (n, cyc) in cfgs.items():
        solver = MultigridSolver(prob, n, SolverConfig(
            cycle=cyc, precision="f32"), device="cuda")
        T.reset_launches()
        solver.solve()
        torch.cuda.synchronize()
        by_path[key] = {f"{k} {s[0]}x{s[1]}x{s[2]}": x
                        for (k, s), x in sorted(T.launches_by_fine.items())}
        del solver
        torch.cuda.empty_cache()
    digest = hashlib.sha256(" ".join(digests).encode()).hexdigest()
    return {}, {"ms": ms, "launches_by_fine": by_path}, digest


def residual_row():
    import numpy as np
    from pde_multigrid_tpu_torch import MultigridSolver, Poisson3D
    from pde_multigrid_tpu_torch.grid import build_geometries, wrap_interior
    from pde_multigrid_tpu_torch.ops.cuda import transfer as T

    prob = Poisson3D()
    rng = np.random.default_rng(2060)
    zero_f = getattr(T, "residual_zero_f", None)
    ms, outs = {}, []
    shapes = [(n,) * 3 for n in (512, 256, 128, 64, 32, 16, 8, 4, 2)]
    for shape in shapes + [(64, 32, 128), (24, 12, 20)]:
        g = build_geometries(tuple(n + 1 for n in shape), ((0.0, 1.0),) * 3,
                             1, wrap=True)[0]
        v = torch.tensor((rng.standard_normal(shape) * wrap_interior(shape))
                         .astype(np.float32), device="cuda")
        f = torch.tensor(rng.standard_normal(shape).astype(np.float32),
                         device="cuda")
        fless = ((lambda: T.residual(v, torch.zeros_like(v), prob, g))
                 if zero_f is None else (lambda: zero_f(v, prob, g)))
        tag = "x".join(map(str, shape))
        reps = {512: 5, 256: 10}.get(shape[0], 50)
        for name, fn in (("f", lambda: T.residual(v, f, prob, g)),
                         ("f_less", fless)):
            outs.append(fn())
            ms[f"{name} {tag}"] = c.device_ms(torch, fn, reps)
        del v, f
        torch.cuda.empty_cache()
    solver = MultigridSolver(prob, c.FAS_N, c._fas_cfg(), device="cuda")
    T.reset_launches()
    solver.solve()
    torch.cuda.synchronize()
    by_level = {f"{k} {s[0]}x{s[1]}x{s[2]}": x
                for (k, s), x in sorted(T.launches_by_fine.items())
                if k.startswith("residual") and k != "residual_restrict"}
    counts = {k: T.launches[k] for k in T.launches if k.startswith(
        "residual") and k != "residual_restrict"}
    return counts, {"ms": ms, "fas257_by_level": by_level}, sha(*outs)


def blocked_row():
    import os
    import numpy as np
    from pde_multigrid_tpu_torch import (CycleConfig, MultigridSolver,
                                         Poisson3D, SolverConfig)
    from pde_multigrid_tpu_torch.grid import build_geometries
    from pde_multigrid_tpu_torch.ops.cuda import blocked3d as BL

    _, s32, v32 = c.phase_main_path(torch, 257, "f32")
    c.phase_kernels_blocked3d(torch)
    counts, s = c.phase_f32_257_blocked(torch, s32, v32)
    os.environ["PDE_MG_TIMESKEW"] = "0"
    try:
        v = MultigridSolver(Poisson3D(), 257, SolverConfig(
            cycle=CycleConfig("fmg", 2, 100, 100, coarsest="exact"),
            precision="f32"), device="cuda").solve().v
    finally:
        os.environ.pop("PDE_MG_TIMESKEW")
    rng = np.random.default_rng(2044)
    launch, prob = {}, Poisson3D()
    for n in (257, 513):
        g = build_geometries((n,) * 3, prob.domain, 1, wrap=True)[0]
        hv = [torch.tensor(rng.standard_normal(
            (n - 1, (n - 1) // 2, n - 1)).astype(np.float32), device="cuda")
            for _ in range(4)]
        ko = (torch.empty_like(hv[0]), torch.empty_like(hv[1]))
        launch[f"{n - 1}^3 T=1"] = c.device_ms(
            torch, lambda: BL.blocked_chunk(*hv, 1, prob, g, ko), 10)
        del hv, ko
    s["launch_ms"] = launch
    s["wavefront"] = s32
    s["sha256_wavefront"], s["sha256_blocked"] = sha(v32), sha(v)
    return counts, s, f"{sha(v32)} {sha(v)}"


c.phase_card(torch)
c.phase_build()
for row in sys.argv[2:]:
    if row.startswith(("mixed:", "f32:")):
        prec, n = row.split(":")
        counts, s, v = c.phase_main_path(torch, int(n), prec)
        digest = sha(v)
    elif row == "transfers":
        counts, s, digest = transfers_row()
    elif row == "residual":
        counts, s, digest = residual_row()
    elif row == "varcoef":
        legs = c.phase_kernels_stencil(torch)
        counts, s, v = c.phase_varcoef(torch)
        s["leg_ms"] = {k: r["ms"] for k, r in legs.items()}
        s["leg_ms_by_level"] = {str(k): x
                                for k, x in c.VARCOEF_LEG_MS.items()}
        digest = sha(v)
    elif row == "stencil":
        counts, s, digest = stencil_row()
    elif row == "fas257":
        from pde_multigrid_tpu_torch import MultigridSolver, Poisson3D
        counts, s = c.phase_fas3d_257(torch)
        digest = sha(MultigridSolver(Poisson3D(), c.FAS_N, c._fas_cfg(),
                                     device="cuda").solve().v)
    elif row == "sharded257":
        _, s32, v32 = c.phase_main_path(torch, c.SHARD_N, "f32")
        c.UNSHARDED["f32"] = (s32, v32)
        counts, s, digest = c.phase_sharded(torch)
        c.UNSHARDED.clear()
        import torch.distributed as dist
        if dist.is_initialized():  # the one-rank group of phase_sharded
            dist.destroy_process_group()
    elif row == "resident3d":
        counts, s, digest = resident3d_row()
    elif row == "subtree":
        counts, s, digest = subtree_row()
    elif row == "reduced":
        counts, s, digest = reduced_row()
    elif row == "blocked":
        counts, s, digest = blocked_row()
    elif row == "hjb":
        c.phase_kernels_hjb(torch)
        counts, s, v = c.phase_hjb(torch)
        s["leg_ms_by_level"] = hjb_legs()
        s["slab_leg_ms"] = slab_legs()
        runs, mid = hjb_graph_runs()
        s["graph_ms_runs"] = {str(i): x for i, x in enumerate(runs)}
        s["graph_ms_median"] = sum(mid) / 2
        digest = sha(v)
    elif row == "merge2d":
        counts, s, digest = merge2d_row()
    elif row == "sharded2d":
        _, sly, vly = c.phase_lyapunov(torch)
        counts, s, digest = c.phase_sharded2d(torch, sly, vly)
        import torch.distributed as dist
        if dist.is_initialized():  # the one-rank group of phase_sharded2d
            dist.destroy_process_group()
    elif row == "ode1d":
        c.phase_kernels1d(torch)
        counts, s, v = c.phase_ode1d(torch)
        s["preset"] = c.phase_ode1d_preset(torch)
        s["leg_ms_by_level"] = relax1d_legs()
        digest = sha(v)
    else:
        raise SystemExit(f"unknown row {row}")
    print("AB " + json.dumps({"side": sys.argv[1], "row": row,
                              "sha256": digest, "summary": s,
                              "counts": counts}, default=str), flush=True)
"""


LOG = os.path.join("chiprun_out", "ab_rows.jsonl")


def keep(line: str) -> None:
    os.makedirs(os.path.dirname(LOG), exist_ok=True)
    with open(LOG, "a") as fh:
        fh.write(line + "\n")


def run_side(path: str, label: str, rows: list[str]) -> dict:
    proc = subprocess.run([sys.executable, "-c", SIDE, label, *rows],
                          cwd=path, capture_output=True, text=True)
    sys.stderr.write(proc.stderr[-4000:])
    got = {}
    for ln in proc.stdout.splitlines():
        if ln.startswith("AB "):
            rec = json.loads(ln[3:])
            got[rec["row"]] = rec
            print(ln)
            keep(ln[3:])
        else:
            print(f"  [{label}] {ln}"[:600])
    if proc.returncode != 0 or len(got) != len(rows):
        raise SystemExit(f"side {label} ({path}) failed: rc "
                         f"{proc.returncode}")
    return got


def numbers(d, prefix=""):
    """The numbers in a nested summary, by dotted key."""
    out = {}
    for k, x in d.items():
        key = f"{prefix}{k}"
        if isinstance(x, dict):
            out.update(numbers(x, key + "."))
        elif isinstance(x, (int, float)) and not isinstance(x, bool):
            out[key] = x
    return out


def main() -> int:
    if len(sys.argv) < 4:
        print(__doc__)
        return 2
    parent, change = (os.path.abspath(p) for p in sys.argv[1:3])
    rows = sys.argv[3:]
    order = (("P1", parent), ("C1", change), ("C2", change), ("P2", parent))
    runs = {label: run_side(path, label, rows) for label, path in order}
    ok = True
    for row in rows:
        ref = runs["P1"][row]["sha256"]
        same = {lb: r[row]["sha256"] == ref for lb, r in runs.items()}
        ok &= all(same.values())
        nums = {lb: numbers(r[row]["summary"]) for lb, r in runs.items()}
        keys = [k for k in nums["P1"] if all(k in n for n in nums.values())]
        line = json.dumps({
            "row": row, "bitwise_vs_P1": same, "sha256_P1": ref,
            "mean": {k: {s: sum(n[k] for lb, n in nums.items()
                                if lb[0] == s) / 2 for s in "PC"}
                     for k in keys}})
        print(line)
        keep(line)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
