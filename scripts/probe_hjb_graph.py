#!/usr/bin/env python3
"""The HJB 513^2 FAS step as one CUDA graph with the slab level (row 3)
in several forms, in turns in one process on one card.

    python3 scripts/probe_hjb_graph.py [ROUNDS] [OUT_JSON]

The step of `chip_smoke.phase_hjb`'s solver (FMG(2, 30, 30), FAS,
coarsest relax, f32): "leg", the plan (`slab2d.slab_layout`: a 30-sweep
leg one cooperative launch); "leg, ordinary launch", the same launch
without the cooperative attribute, from a copy of csrc/slab2d.cu built
here with that one line changed (its grid of 128 CTAs, one an SM, is
resident at once on an otherwise idle card); and "launches", the same
kernel at T = 4 sweeps a launch (8 ordinary launches a leg,
`slab2d._slab_layout(..., leg=False)`), and those launches asking for
as much shared memory as the leg's (a copy built here); the leg and the
launches with each leg run twice (the in-place marginal cost of a leg),
and the leg writing its output after a spare buffer is allocated (the
buffers of the T-sweeps form); each step bitwise the same.
Each round (ROUNDS, default 10, turns alternating) captures each form's
step in a fresh graph and replays it (`chip_smoke.device_ms`, 1 step a graph); then, once a form,
the profiler over one replay: the kernels' summed device time against
the replay's span (the idle share), the slab kernel's part, the gaps
and the operations beside it.  Last, four legs a graph alone, each
after an elementwise kernel and back to back.  Prints one
PROBE JSON line a form and writes them to OUT_JSON (default
log/probe_hjb_graph.json).  Imports nothing of JAX; needs a CUDA card.
"""

from __future__ import annotations

import ctypes
import json
import os
import shutil
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def variant_lib(line, new):
    """csrc/slab2d.cu built on its own with the source line `line`
    replaced by `new`: its `pdemg_slab2d` (same arguments)."""
    from pde_multigrid_tpu_torch.ops.cuda import build

    tmp = tempfile.mkdtemp()
    for name in ("slab2d.cu", "hjb2d.cuh"):
        shutil.copy(build.CSRC / name, tmp)
    src = os.path.join(tmp, "slab2d.cu")
    text = open(src).read()
    if text.count(line) != 1:
        raise SystemExit(f"csrc/slab2d.cu: {line!r} moved")
    open(src, "w").write(text.replace(line, new))
    out = os.path.join(tmp, "libslab2d_variant.so")
    proc = subprocess.run(
        [build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o", out, src],
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(proc.stderr)
    fn = ctypes.CDLL(out).pdemg_slab2d
    fn.argtypes = build.SIGNATURES["pdemg_slab2d"]
    return fn


def main() -> int:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as c
    from pde_multigrid_tpu_torch import (CycleConfig, HJBMinTime,
                                         MultigridSolver, SolverConfig)
    from pde_multigrid_tpu_torch.ops.cuda import build
    from pde_multigrid_tpu_torch.ops.cuda import slab2d as SL

    rounds = int(sys.argv[1]) if len(sys.argv) > 1 else 10
    out_path = sys.argv[2] if len(sys.argv) > 2 else os.path.join(
        "log", "probe_hjb_graph.json")
    card = c.phase_card(torch)
    c.phase_build()
    solver = MultigridSolver(HJBMinTime(), c.HJB_N, SolverConfig(
        cycle=CycleConfig("fmg", *c.HJB_NUS, scheme="fas",
                          coarsest="relax")), device="cuda")
    g0 = solver.geoms[0]
    plan = SL.slab_layout
    chain = SL._slab_layout(*g0.padded_shape, *SL.CHAIN_TILE, SL.SLAB_T,
                            False)
    lib = build.load().lib
    cooperative = lib.pdemg_slab2d
    launch_line = "cfg.numAttrs = g.leg ? 1 : 0;"
    smem_line = "cfg.dynamicSmemBytes = g.smem_bytes;"
    libs = {"leg, ordinary launch": variant_lib(launch_line,
                                                "cfg.numAttrs = 0;"),
            "launches, shared memory padded to the leg's": variant_lib(
                smem_line, "cfg.dynamicSmemBytes = g.smem_bytes + "
                "(g.leg ? 0 : %d);" % (plan(g0).smem_bytes
                                       - chain.smem_bytes))}
    by_chain = lambda g: chain if g == g0 else plan(g)  # noqa: E731
    relax = SL.slab_relax

    def twice(v, f, n, problem, geom):
        relax(v, f, n, problem, geom)
        return relax(v, f, n, problem, geom)

    def after_spare(v, f, n, problem, geom):
        spare = torch.empty_like(v)  # the T-sweeps form's first buffer
        out = relax(v, f, n, problem, geom)
        del spare
        return out

    forms = {"leg": plan, "leg, ordinary launch": plan,
             "launches": by_chain,
             "launches, shared memory padded to the leg's": by_chain,
             "leg, each leg twice": plan, "launches, each leg twice":
             by_chain, "leg, output after a spare buffer": plan}
    relaxes = {"leg, each leg twice": twice, "launches, each leg twice":
               twice, "leg, output after a spare buffer": after_spare}

    def use(name):
        SL.slab_layout = forms[name]
        lib.pdemg_slab2d = libs.get(name, cooperative)
        SL.slab_relax = relaxes.get(name, relax)

    def reset():
        SL.slab_layout = plan
        lib.pdemg_slab2d = cooperative
        SL.slab_relax = relax

    results = {name: {"graph_ms": []} for name in forms}
    solutions = {}
    for name in forms:
        use(name)
        solutions[name] = solver.solve().v.clone()
        reset()
    if not all(torch.equal(solutions["leg"], v) for v in solutions.values()):
        raise SystemExit("the forms' solutions differ")
    for i in range(rounds):
        order = list(forms) if i % 2 == 0 else list(forms)[::-1]
        for name in order:
            use(name)
            levels = solver.fresh_levels()
            results[name]["graph_ms"].append(c.device_ms(
                torch, lambda: solver.program.solve_step(levels), 1))
            reset()
    for name in forms:
        use(name)
        levels = solver.fresh_levels()
        step = lambda: solver.program.solve_step(levels)  # noqa: E731
        graph = torch.cuda.CUDAGraph()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            step()
        torch.cuda.current_stream().wait_stream(side)
        with torch.cuda.graph(graph):
            step()
        graph.replay()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            graph.replay()
            e1.record()
            e1.synchronize()
        busy = slab = 0.0
        kern = sorted((e for e in prof.events()
                       if e.device_type == DeviceType.CUDA),
                      key=lambda e: e.time_range.start)
        for e in kern:
            busy += e.device_time_total / 1e3
            if "slab2d_kernel" in e.name:
                slab += e.device_time_total / 1e3
        # the device's idle time before and after each slab kernel, and
        # over the whole replay
        gaps = {"before_slab_us": 0.0, "after_slab_us": 0.0, "all_us": 0.0}
        # the device operations either side of each slab kernel
        beside = [[kern[j].name[:60] for j in (i - 2, i - 1, i + 1)
                   if 0 <= j < len(kern)]
                  for i, e in enumerate(kern) if "slab2d_kernel" in e.name]
        for a, b in zip(kern, kern[1:]):
            gap = max(0.0, b.time_range.start - a.time_range.end)
            gaps["all_us"] += gap
            if "slab2d_kernel" in b.name:
                gaps["before_slab_us"] += gap
            if "slab2d_kernel" in a.name:
                gaps["after_slab_us"] += gap
        span = e0.elapsed_time(e1)
        reset()
        ts = sorted(results[name]["graph_ms"])
        rec = {"form": name, "card": card, **results[name],
               "graph_ms_median": (ts[(len(ts) - 1) // 2] + ts[len(ts) // 2])
               / 2, "profiled_replay_ms": span, "kernels_busy_ms": busy,
               "slab_busy_ms": slab, "idle_share": 1 - busy / span,
               "slab_launches": sum("slab2d_kernel" in e.name for e in kern),
               "beside_slab": beside[:8], **gaps}
        print("PROBE " + json.dumps(rec), flush=True)
        results[name] = rec
    # the slab legs alone, 4 a graph, each after a small elementwise
    # kernel (as in the step) and back to back
    import numpy as np

    v, f, _ = c._hjb_inputs(torch, np.random.default_rng(2055),
                            HJBMinTime(), g0)
    w = torch.empty_like(v)
    prob = HJBMinTime()
    for name in ("leg", "launches"):
        use(name)
        for tag, between in (("after an add", True), ("back to back", False)):
            def legs():
                for _ in range(4):
                    if between:
                        torch.add(v, 1.0, out=w)
                    SL.slab_relax(v, f, c.HJB_NUS[1], prob, g0)
            ms = [c.device_ms(torch, legs, 1) for _ in range(6)]
            rec = {"form": name, "legs": tag, "ms_4_legs": ms,
                   "median": sorted(ms)[2] / 2 + sorted(ms)[3] / 2}
            print("PROBE " + json.dumps(rec), flush=True)
            results[f"{name} legs {tag}"] = rec
        reset()
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as fh:
        json.dump(list(results.values()), fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
