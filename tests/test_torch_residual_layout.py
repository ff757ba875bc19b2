"""The launch layouts of the 3D residual (`ops/cuda/transfer.py`, row 27)
and a plain PyTorch emulation of its walk.

`residual_layout` picks a launch from the level's shape alone: the walk
of x planes (`csrc/transfer.cu` `residual_walk_kernel`) or a point a
thread (`residual_point_kernel`).  Here, on every level of the 129^3,
257^3 and 513^3 rows, of FAS 257^3 and of the 3D presets (512^3 ...
2^3), on non-cubic power-of-two levels and on levels whose extents are not
powers of two: the CTAs and threads each layout launches, with the
kernel's index arithmetic, write every point exactly once.  Then `_walk`
runs the walk in PyTorch (each CTA's staged v planes with wrapped rows,
the x - 1, x, x + 1 quads in registers, the z neighbours from the lanes
beside a quad or from the staged row at a row's or warp's edge, f read a
plane ahead), bitwise `residual_plain` in float32 with f and f-less; the
f-less plain form is bitwise residual(v, 0); and a FAS solve through a
tier with the f-less hook is bitwise the same solve without it.

The kernels build and run only on a GPU; `chip_smoke.py` holds them
against the plain versions there, bit for bit.
"""

import numpy as np
import pytest
import torch

from pde_multigrid_tpu_torch import CycleConfig, MultigridSolver, SolverConfig
from pde_multigrid_tpu_torch import grid as TG
from pde_multigrid_tpu_torch.cycles import CycleProgram
from pde_multigrid_tpu_torch.models import Poisson as TPoisson
from pde_multigrid_tpu_torch.models.poisson import inv_h2
from pde_multigrid_tpu_torch.ops.cuda import transfer as T
from pde_multigrid_tpu_torch.ops.cuda.dispatch import CudaKernels

DOM = ((0.0, 1.0),) * 3

# every level of the 513^3 row (the 129^3 and 257^3 rows, FAS 257^3 and
# the presets are its tail: 256^3 ... 2^3), non-cubic power-of-two
# levels, levels whose extents are not powers of two (the point form)
CUBIC = [(n,) * 3 for n in (512, 256, 128, 64, 32, 16, 8, 4, 2)]
NON_CUBIC = [(64, 32, 128), (8, 4, 16), (32, 64, 4), (128, 16, 256)]
ODD = [(12, 12, 12), (24, 8, 16), (6, 4, 4), (33, 17, 9)]


@pytest.fixture(autouse=True)
def _no_launches():
    """CPU tensors never launch a kernel: every counter stays at zero."""
    T.reset_launches()
    yield
    assert not any(T.launches.values()) and not T.launches_by_fine


def _geom(shape):
    g = TG.build_geometries(tuple(n + 1 for n in shape), DOM, 1,
                            wrap=True)[0]
    assert tuple(g.padded_shape) == tuple(shape)
    return g


def _walk_threads(lay):
    """(active, rr, q) of the walk's threads: tid = (rr << log2(Z / 4)) +
    quad, padding only past the last row, within the last warp."""
    nch = lay.Z // 4
    lg = nch.bit_length() - 1
    tid = np.arange(lay.bx, dtype=np.int32)
    rr, q = tid >> lg, tid & (nch - 1)
    active = rr < lay.TJ
    assert lay.bx - active.sum() < 32 and lay.bx % 32 == 0
    return active, rr, q


def _planes_and_rows(lay):
    """The planes x and the in-plane points y Z + z the layout's CTAs and
    threads write, by the kernel's index arithmetic: x from the CTA's
    band and step (the walk; the point form: its CTA row of planes), (y,
    z) from the tile (or CTA) and the thread's row and quad (or lanes).
    Every x writes the same (y, z) points."""
    Y, Z = lay.Y, lay.Z
    if lay.form == T.WALK:
        active, rr, q = _walk_threads(lay)
        x = (np.arange(lay.gy)[:, None] * lay.NX
             + np.arange(lay.NX)).ravel()
        y = np.arange(lay.gx)[:, None] * lay.TJ + rr[active]
        yz = (y * Z + 4 * q[active])[..., None] + np.arange(4)
        return x, yz.ravel()
    z = (np.arange(lay.gx)[:, None] * lay.bx + np.arange(lay.bx)).ravel()
    y = (np.arange(lay.gy)[:, None] * lay.by + np.arange(lay.by)).ravel()
    z, y = z[z < Z], y[y < Y]
    return np.arange(lay.gz), (y[:, None] * Z + z[None, :]).ravel()


def _coverage(lay):
    """Per plane and per in-plane point, how often the layout writes it
    (a point's count is their product); on levels of up to 2^21 points
    the points' own count is checked to be that product."""
    X, Y, Z = lay.X, lay.Y, lay.Z
    x, yz = _planes_and_rows(lay)
    cx = np.bincount(x, minlength=X)
    cyz = np.bincount(yz, minlength=Y * Z)
    if X * Y * Z <= 2 ** 21:
        flat = (x[:, None] * (Y * Z) + yz[None, :]).ravel()
        assert np.array_equal(np.bincount(flat, minlength=X * Y * Z),
                              np.outer(cx, cyz).ravel())
    return cx, cyz


@pytest.mark.parametrize("shape", CUBIC + NON_CUBIC + ODD)
@pytest.mark.parametrize("with_f", [True, False])
def test_residual_layout_covers_every_point_once(shape, with_f):
    lay = T.residual_layout(shape, with_f)
    assert (lay.X, lay.Y, lay.Z, lay.with_f) == (*shape, int(with_f))
    pow2 = all(n & (n - 1) == 0 for n in shape)
    n = shape[0] * shape[1] * shape[2]
    if pow2 and shape[2] >= 4 and n > T.RESIDUAL_POINT_MAX:
        assert lay.form == T.WALK
        assert lay.RV == lay.TJ + 2 and lay.by == lay.gz == 1
        assert (lay.gx * lay.TJ, lay.gy * lay.NX) == shape[1::-1]
        assert lay.bx <= T.MAX_WALK_THREADS
        assert lay.smem_bytes == 4 * T.WALK_STAGES * lay.RV * shape[2]
        assert lay.smem_bytes <= T.MAX_SMEM_BYTES
    else:
        assert lay.form == T.POINT
        assert lay.bx * lay.by <= T.POINT_THREADS and lay.gz == shape[0]
    assert all(np.all(c == 1) for c in _coverage(lay))


def test_residual_layouts_of_the_bench_levels():
    """The walk on 512^3 ... 64^3: 4 rows a tile (512 threads at 512^3,
    128 at 128^3), the fewest bands that make RESIDUAL_CTAS CTAs; the
    point form on 32^3 and below; 2 rows a tile where z is 2048."""
    want = {512: (512, 4), 256: (256, 8), 128: (128, 16), 64: (64, 32)}
    for n, (threads, bands) in want.items():
        for with_f in (True, False):
            lay = T.residual_layout((n,) * 3, with_f)
            assert (lay.form, lay.TJ, lay.bx, lay.gy) == (T.WALK, 4,
                                                          threads, bands)
            assert lay.gx * lay.gy == T.RESIDUAL_CTAS
    for n in (32, 16, 8, 4, 2):
        assert T.residual_layout((n,) * 3, True).form == T.POINT
    lay = T.residual_layout((16, 16, 2048), True)
    assert (lay.form, lay.TJ, lay.bx) == (T.WALK, 2, 1024)


def test_residual_walk_layout_refuses_what_the_walk_cannot_take():
    assert T.residual_walk_layout((12, 12, 12), True, 2, 2) is None
    assert T.residual_walk_layout((16, 16, 2), True, 2, 2) is None  # z < 4
    assert T.residual_walk_layout((16, 16, 16), True, 3, 2) is None
    assert T.residual_walk_layout((16, 16, 16), True, 2, 3) is None
    assert T.residual_walk_layout((4, 16, 4096), True, 2, 1) is None
    lay = T.residual_walk_layout((4, 16, 4096), True, 1, 1)  # 192 KB
    assert lay.bx == 1024 and lay.smem_bytes <= T.MAX_SMEM_BYTES
    assert T.residual_walk_layout((4, 64, 2048), True, 4, 1) is None  # KB
    with pytest.raises(ValueError):
        T.residual_point_layout((70000, 4, 4), True)


# ------------------------------------------------- the kernel's schedule


def _res_pt(c, xm, xp, ym, yp, zm, zp, f, m, w):
    """csrc/transfer.cu res_pt: residual_at's order."""
    c2 = 2.0 * c
    t0 = (xm - c2) + xp
    lv = t0 * w[0]
    t1 = (ym - c2) + yp
    lv = lv + t1 * w[1]
    t2 = (zm - c2) + zp
    lv = lv + t2 * w[2]
    return m * (f - lv)


def _walk(v, f, lay, w):
    """csrc/transfer.cu residual_walk_kernel in PyTorch, CTA by CTA and
    plane by plane, with its threads' quads: f None is the f-less mode."""
    X, Y, Z = v.shape
    TJ, RV = lay.TJ, lay.RV
    active, rr, q = (torch.from_numpy(a) for a in _walk_threads(lay))
    rr, q = rr.long(), q.long()
    rr = torch.where(active, rr, TJ - 1)  # padding threads: row TJ - 1
    z = 4 * q
    lane = torch.arange(lay.bx) % 32
    # the lane a shuffle reads: (lane -/+ 1) mod 32 in the same warp
    left = torch.arange(lay.bx) - lane + (lane + 31) % 32
    right = torch.arange(lay.bx) - lane + (lane + 1) % 32
    quad = z[:, None] + torch.arange(4)  # (threads, 4)
    out = torch.full((X, Y, Z), float("nan"))
    for bx in range(lay.gx):
        for by in range(lay.gy):
            y0, x0 = bx * TJ, by * lay.NX
            rows = (y0 - 1 + torch.arange(RV)) % Y  # stage_rows' rows

            def staged(x):  # a slot: v plane x, the tile's rows
                return v[x % X][rows]

            def thread_quads(plane, row):  # each thread's quad of a row
                return plane[row[:, None], quad]

            vm = thread_quads(staged(x0 - 1), rr + 1)
            vc = thread_quads(staged(x0), rr + 1)
            y = y0 + rr
            for s in range(lay.NX):
                x = x0 + s
                pc, pn = staged(x), staged(x + 1)
                vp = thread_quads(pn, rr + 1)
                ym = thread_quads(pc, rr)
                yp = thread_quads(pc, rr + 2)
                zl = vc[left, 3].clone()
                zr = vc[right, 0].clone()
                edge_l = (q == 0) | (lane == 0)
                edge_r = (q == Z // 4 - 1) | (lane == 31)
                zl[edge_l] = pc[rr + 1, (z - 1) % Z][edge_l]
                zr[edge_r] = pc[rr + 1, (z + 4) % Z][edge_r]
                zm = torch.cat([zl[:, None], vc[:, :3]], 1)
                zp = torch.cat([vc[:, 1:], zr[:, None]], 1)
                fq = (torch.zeros_like(vc) if f is None
                      else f[x][y[:, None], quad])
                m = ((x >= 1) & (y >= 1)[:, None] & (quad >= 1)).to(
                    torch.float32)
                a = _res_pt(vc, vm, vp, ym, yp, zm, zp, fq, m, w)
                out[x, y[active, None], quad[active]] = a[active]
                vm, vc = vc, vp
    return out


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    v = torch.tensor((rng.standard_normal(shape)
                      * TG.wrap_interior(shape)).astype(np.float32))
    f = torch.tensor(rng.standard_normal(shape).astype(np.float32))
    return v, f


WALK_LEVELS = [(16, 16, 16), (8, 4, 16), (4, 4, 4), (8, 8, 64), (4, 2, 256),
               (64, 16, 64)]


@pytest.mark.parametrize("shape", WALK_LEVELS)
@pytest.mark.parametrize("with_f", [True, False])
def test_walk_emulation_is_plain_bitwise(shape, with_f):
    """The walk at the package's layout (64 x 16 x 64: 4 rows a tile, a
    plane a band) and, on the small levels, at other tiles and bands
    equals residual_plain bit for bit; f-less equals residual_plain(v,
    0)."""
    g = _geom(shape)
    v, f = _inputs(shape, seed=sum(shape) + with_f)
    prob = TPoisson(3)
    want = T.residual_plain(v, f if with_f else torch.zeros_like(v), prob,
                            g)
    w = inv_h2(g)
    small = v.numel() <= 4096
    lays = [lay for lay in (T.residual_walk_layout(shape, with_f, TJ, b)
                            for TJ in (1, 2, 4) for b in (1, 2, 4))
            if small and lay is not None]
    pkg = T.residual_layout(shape, with_f)
    if pkg.form == T.WALK:
        lays.append(pkg)
    assert lays
    for lay in lays:
        got = _walk(v, f if with_f else None, lay, w)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), (
            lay.as_dict())


@pytest.mark.parametrize("shape", [(16, 16, 16), (12, 8, 6), (2, 2, 2)])
def test_f_less_plain_is_residual_of_zero_f_bitwise(shape):
    """The f-less plain form, residual_plain(v, None), and the f-less
    wrapper on CPU tensors are residual_plain(v, 0) bit for bit, signed
    zeros included."""
    g = _geom(shape)
    v, _ = _inputs(shape, seed=7)
    prob = TPoisson(3)
    want = T.residual_plain(v, torch.zeros_like(v), prob, g)
    for got in (T.residual_plain(v, None, prob, g),
                T.residual_zero_f(v, prob, g)):
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_fas_solve_with_the_zero_f_hook_is_bitwise_the_solve_without():
    """FMG(2, 3, 3) FAS relaxed to 2^3 at 17^3 through CudaKernels on CPU
    tensors: with its residual_zero_f hook (each coarse right side
    residual(v, 0) without a zero f) and through a tier whose hook says
    None (the zeros_like form the CPU tier and the sharded tier keep),
    bitwise the same solution and residual history."""
    cyc = CycleConfig("fmg", 2, 3, 3, scheme="fas", coarsest="relax")
    calls = []

    class Counted(CudaKernels):
        def residual_zero_f(self, l, v, aux):
            calls.append(l)
            return super().residual_zero_f(l, v, aux)

    class Without(CudaKernels):
        def residual_zero_f(self, l, v, aux):
            return None

    out = []
    for tier in (Counted, Without):
        s = MultigridSolver(TPoisson(3), 17, SolverConfig(
            cycle=cyc, max_cycles=2, tol=0.0), device="cpu")
        s.program = CycleProgram(s.problem, s.geoms, cyc, tier(
            s.problem, s.geoms, torch.float32))
        out.append(s.solve_to_tolerance())
    # one FMG step visits level l + 1 nu0 (l + 1) times, then a V-cycle
    nlev = len(s.geoms)
    assert len(calls) == sum(2 * (l + 1) + 1 for l in range(nlev - 1))
    a, b = out
    assert torch.equal(a.v.view(torch.int32), b.v.view(torch.int32))
    assert a.residual_history == b.residual_history
