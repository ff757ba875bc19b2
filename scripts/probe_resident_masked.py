#!/usr/bin/env python3
"""A short first check, on the card, of the 3D relax kernels that share
`halves3d.cuh`'s leg and of the masked block's chunk kernel.

    python3 scripts/probe_resident_masked.py     # from the repo root

Builds the kernels, prints the build's ptxas lines (registers, spills)
of resident3d_kernel, subtree_kernel and masked_chunk_kernel, checks the
fused subtree bitwise against its plain version at the 32^3 and 64^3
roots, nu = (2, 3), both variants, and times its 64^3 level alone (the
64^3-rooted call at nu = 3000 less the 32^3-rooted one, per half-sweep),
then runs `chip_smoke.phase_kernels_resident3d` (every mode on 64^3-2^3
bitwise, 100-sweep legs beside row 9's chain) and
the resident legs with runs of 1, 2 and 4 planes a thread on every
level, then `chip_smoke.phase_kernels_shard` (the masked block bitwise on
every shard's block, a chunk timed by block beside the one-colour
form).  Imports nothing of JAX; needs a
CUDA card.
"""

from __future__ import annotations

import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as c  # noqa: E402


def ptxas_lines(names) -> list[str]:
    """The build log's ptxas report of each kernel whose mangled name
    contains one of `names`: its entry line and the lines after it."""
    from pde_multigrid_tpu_torch.ops.cuda import build

    out, keep = [], 0
    for ln in build.build_log().splitlines():
        if "Compiling entry function" in ln:
            keep = 4 if any(n in ln for n in names) else 0
        if keep:
            out.append(ln.strip())
            keep -= 1
    return out


def subtree_check() -> None:
    from pde_multigrid_tpu_torch.grid import build_geometries, wrap_interior
    from pde_multigrid_tpu_torch.models import Poisson3D
    from pde_multigrid_tpu_torch.ops.cuda import subtree as S

    prob = Poisson3D()
    geoms = build_geometries((65,) * 3, prob.domain, wrap=True)
    rng = np.random.default_rng(7)
    ms = {}
    for l in (0, 1):
        shape = geoms[l].padded_shape
        v = torch.tensor((rng.standard_normal(shape) * wrap_interior(shape))
                         .astype(np.float32), device="cuda")
        f = torch.tensor(rng.standard_normal(shape).astype(np.float32),
                         device="cuda")
        for wr in (True, False):
            k = S.subtree_vcycle(v.clone(), f, prob, geoms[l:], 2, 3, wr)
            p = S.subtree_vcycle_plain(v, f, prob, geoms[l:], 2, 3, wr)
            c.require(torch.equal(k, p), f"subtree {shape} wr={wr}: not "
                      "bitwise its plain version")
        vk = v.clone()
        ms[shape[0]] = c.device_ms(torch, lambda: S.subtree_vcycle(
            vk, f, prob, geoms[l:], 3000, 3000, True), 1)
    lvl = ms[64] - ms[32]
    c.log(f"subtree: bitwise its plain version at the 64^3 and 32^3 roots; "
          f"nu = 3000 calls {ms} ms, the 64^3 level {lvl!r} ms, "
          f"{lvl * 1e3 / 12000!r} us a half-sweep")


def run_ab() -> None:
    """resident3d's 100-sweep dense leg on every level of 65^3 with runs of
    1, 2 and 4 planes a thread (threads as `layout` counts them for each),
    and with the layout's run on half its threads, each bitwise the
    layout's own leg, timed in turns."""
    import ctypes

    from pde_multigrid_tpu_torch.grid import build_geometries, wrap_interior
    from pde_multigrid_tpu_torch.models import Poisson3D
    from pde_multigrid_tpu_torch.ops.cuda import build
    from pde_multigrid_tpu_torch.ops.cuda import relax as R
    from pde_multigrid_tpu_torch.ops.cuda import resident3d as RS3

    prob = Poisson3D()
    rng = np.random.default_rng(11)
    lib = build.load().lib
    for g in build_geometries((65,) * 3, prob.domain, wrap=True):
        X, Y, Z = g.padded_shape
        shape = g.padded_shape
        v = torch.tensor((rng.standard_normal(shape) * wrap_interior(shape))
                         .astype(np.float32), device="cuda")
        f = torch.tensor(rng.standard_normal(shape).astype(np.float32),
                         device="cuda")
        base = RS3._params(g, 100, False)
        want = v.clone()
        RS3._launch("merged_resident" if RS3.merged_gate(g) else
                    "resident3d", want, None, f, None, 100, prob, g, False)
        planes = X // base.lev.nctas
        half = max(32, base.threads // 2)
        cands = [(1, None), (2, None), (4, None), (base.run, half)]
        ms = {}
        for run, threads in cands + cands[::-1]:
            if run == 0:
                continue
            p = RS3.Resident3DParams()
            ctypes.pointer(p)[0] = base
            p.run = run
            items = planes // min(run, planes) * (Y * Z // 4)
            p.threads = threads or min(RS3.THREADS,
                                       max(32, -(-items // 32) * 32))

            def leg(vv):
                build.check(lib.pdemg_resident3d(
                    vv.data_ptr(), None, f.data_ptr(), None,
                    ctypes.byref(p), R._stream()), "resident3d run A/B")

            got = v.clone()
            leg(got)
            c.require(torch.equal(got, want), f"{shape} run {run}: not "
                      "bitwise the layout's leg")
            vk = v.clone()
            ms.setdefault(f"run {run}, {p.threads} threads", []).append(
                c.device_ms(torch, lambda: leg(vk), 3))
        c.log(f"resident3d run A/B {shape} (layout run "
              f"{RS3.layout(g)['run']}): 100-sweep leg ms "
              f"{ {r: sum(t) / len(t) for r, t in ms.items()} }")


def chunk_slope() -> None:
    """The masked block's chunk at t = 1 ... 4 on the one-rank (144, 128,
    128) and four-rank (48, 128, 128) blocks of 257^3's 128^3 level: ms a
    chunk, graph-replayed (the slope is a sweep's cost, the intercept the
    launch and the block's load and store)."""
    from pde_multigrid_tpu_torch.grid import build_geometries
    from pde_multigrid_tpu_torch.models import Poisson3D
    from pde_multigrid_tpu_torch.ops.cuda import masked_block as MB
    from pde_multigrid_tpu_torch.parallel import halo

    prob = Poisson3D()
    g = build_geometries((129,) * 3, prob.domain, 1, wrap=True)[0]
    rng = np.random.default_rng(5)
    for shape in ((144, 128, 128), (48, 128, 128)):
        v, f = (torch.tensor(rng.standard_normal(shape).astype(np.float32),
                             device="cuda") for _ in range(2))
        pre, mr, mb = halo.coords_and_masks(prob, g, shape, -8,
                                            torch.float32, "cuda")
        ms = {t: c.device_ms(torch, lambda: MB.masked_block(
            v, f, pre, mr, mb, t, prob, g), 5) for t in (1, 2, 3, 4)}
        c.log(f"masked chunk {shape}: ms by t {ms}")


def main() -> int:
    c.phase_card(torch)
    c.phase_build()
    for ln in ptxas_lines(("resident3d_kernel", "subtree_kernel",
                           "masked_chunk_kernel")):
        c.log(ln)
    subtree_check()
    c.phase_kernels_resident3d(torch)
    run_ab()
    c.phase_kernels_shard(torch)
    chunk_slope()
    c.log(f"resident3d_ab {c.RESIDENT3D_AB}")
    c.log(f"masked_ab {c.MASKED_AB}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
