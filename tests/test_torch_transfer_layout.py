"""The layouts of the 3D transfer kernels (`ops/cuda/transfer.py`, rows 25
and 26 and, on the sub-lane pairs, rows 23 and 24) and plain PyTorch
emulations of their schedules.

`restrict_layout` and `prolong_layout` pick a launch from the level's
shape alone.  Here, on every fine level of the 129^3, 257^3 and 513^3
rows, of FAS down to 2^3 and of the 3D presets, and on non-cubic and
non-power-of-two pairs: the CTAs and threads each layout launches, with
the kernel's index arithmetic, write every coarse point (row 25) and
every fine point (row 26) exactly once.  Then `_walk` runs
csrc/transfer.cu's plane walk in PyTorch (each CTA's staged planes with
wrapped rows, the residual once a fine point, the x-smoothed plane at
each odd x, y and z smoothing at the even points) and `_cells` the cell
form of the prolongation (a cell's 8 base values read before its 8
points are written): both bitwise the plain versions, in float32, in
both modes, the prolongation also in place; the emulated walk also
within 2 ulp of the JAX package's jnp restriction (XLA's CPU backend
contracts products into sums, one rounding fewer).

The kernels build and run only on a GPU; `chip_smoke.py` holds them
against the plain versions there, bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pde_multigrid_tpu.ops import stencil as JS
from pde_multigrid_tpu_torch import grid as TG
from pde_multigrid_tpu_torch.models import Poisson as TPoisson
from pde_multigrid_tpu_torch.models.poisson import inv_h2
from pde_multigrid_tpu_torch.ops.cuda import transfer as T

DOM = ((0.0, 1.0),) * 3

# the fine levels the transfer kernels serve: 129^3 (128^3), 257^3 (256^3,
# 128^3), 513^3 (512^3 ... 128^3), FAS 257^3 and the presets down to
# 4^3 -> 2^3; non-cubic pairs; levels the walk does not take (extents
# that are not powers of two)
CUBIC = [(n,) * 3 for n in (512, 256, 128, 64, 32, 16, 8, 4)]
NON_CUBIC = [(8, 4, 16), (64, 32, 128), (16, 16, 4), (4, 8, 8), (32, 4, 4),
             (128, 64, 32)]
ODD = [(12, 12, 12), (24, 8, 16), (6, 4, 4)]


@pytest.fixture(autouse=True)
def _no_launches():
    """CPU tensors never launch a kernel: every counter stays at zero."""
    T.reset_launches()
    yield
    assert not any(T.launches.values()) and not T.launches_by_fine


def _geoms(fine_shape):
    gf = TG.build_geometries(tuple(n + 1 for n in fine_shape), DOM, 2,
                             wrap=True)
    assert tuple(gf[1].padded_shape) == tuple(n // 2 for n in fine_shape)
    return gf


def _walk_coverage(lay):
    """Per coarse point, how often the walk's coarse phases write it: CTA
    (bx, by) owns coarse rows J0 = bx TJ ... and planes I0 = by NI ...,
    and thread t of a phase writes (J0 + t >> log2 Zc, t & (Zc - 1))."""
    Xc, Yc, Zc = lay.Xc, lay.Yc, lay.Zc
    i32 = np.int32
    t = np.arange(lay.TJ * Zc, dtype=i32)
    j, K = t >> (Zc.bit_length() - 1), t & (Zc - 1)
    bx = np.arange(lay.grid_x, dtype=i32)[:, None, None, None]
    by = np.arange(lay.grid_y, dtype=i32)[None, :, None, None]
    I = by * lay.NI + np.arange(lay.NI, dtype=i32)[None, None, :, None]
    J = bx * lay.TJ + j[None, None, None, :]
    flat = (I * Yc + J) * Zc + K[None, None, None, :]
    return np.bincount(flat.ravel(), minlength=Xc * Yc * Zc)


def _walk_threads(lay):
    """The walk's threads: each (fine row rr < RR, z quad) of the tile
    once, by tid = (rr << log2(Z / 4)) + quad; padding only past the last
    row, within the last warp."""
    nch = 2 * lay.Zc // 4
    lg = nch.bit_length() - 1
    tid = np.arange(lay.threads)
    rr, q = tid >> lg, tid & (nch - 1)
    active = rr < lay.RR
    owned = np.bincount((rr * nch + q)[active], minlength=lay.RR * nch)
    assert np.all(owned == 1)
    assert lay.threads - active.sum() < 32


@pytest.mark.parametrize("fine", CUBIC + NON_CUBIC + ODD)
@pytest.mark.parametrize("with_residual", [True, False])
def test_restrict_layout_covers_every_coarse_point_once(fine,
                                                        with_residual):
    lay = T.restrict_layout(fine, with_residual)
    Xc, Yc, Zc = (n // 2 for n in fine)
    assert (lay.Xc, lay.Yc, lay.Zc) == (Xc, Yc, Zc)
    assert lay.with_residual == int(with_residual)
    assert lay.threads % 32 == 0
    if all(n & (n - 1) == 0 for n in fine):
        assert lay.form == T.WALK
        assert lay.threads <= T.MAX_WALK_THREADS
        assert lay.smem_bytes <= T.MAX_SMEM_BYTES
        assert lay.RR == 2 * lay.TJ + 1
        assert lay.RV == lay.RR + 2 * with_residual
        assert (lay.grid_x * lay.TJ, lay.grid_y * lay.NI) == (Yc, Xc)
        assert np.all(_walk_coverage(lay) == 1)
        _walk_threads(lay)
    else:
        assert lay.form == T.POINT
        n = Xc * Yc * Zc
        i = np.arange(lay.grid_x * lay.threads)
        assert np.all(np.bincount(i[i < n], minlength=n) == 1)


def test_restrict_layouts_of_the_bench_levels():
    """The walk on the 513^3 row's levels: 2, 4 and 8 coarse rows a tile at
    512^3, 256^3 and 128^3 (640, 576 and 544 threads; 108 KB at 512^3),
    the fewest bands that make WALK_CTAS CTAs; below, a band a coarse
    plane."""
    want = {512: (2, 640, 1), 256: (4, 576, 4), 128: (8, 544, 16),
            64: (4, 160, 32), 32: (4, 96, 16), 4: (2, 32, 2)}
    for n, (TJ, threads, bands) in want.items():
        for wr in (True, False):
            lay = T.restrict_layout((n,) * 3, wr)
            assert (lay.TJ, lay.threads, lay.grid_y) == (TJ, threads, bands)
            if n >= 128:
                assert lay.grid_x * lay.grid_y == T.WALK_CTAS
    assert T.restrict_layout((512,) * 3, True).smem_bytes == 110592


def test_walk_layout_refuses_what_the_walk_cannot_take():
    assert T.walk_layout((12, 12, 12), True, 2, 2) is None  # not 2^k
    assert T.walk_layout((16, 16, 16), True, 3, 2) is None  # 3 !| 8
    assert T.walk_layout((16, 16, 16), True, 2, 3) is None
    assert T.walk_layout((64, 64, 2048), True, 1, 1) is None  # 1536 thr
    assert T.walk_layout((64, 64, 1024), True, 2, 1) is None  # 1280 thr
    assert T.walk_layout((64, 64, 1024), True, 1, 1).smem_bytes <= (
        T.MAX_SMEM_BYTES)
    with pytest.raises(ValueError):
        T.restrict_layout((9, 8, 8), True)


@pytest.mark.parametrize("fine", CUBIC + NON_CUBIC + ODD)
def test_prolong_layout_covers_every_fine_point_once(fine):
    """Thread (tx, ty) of CTA (gx, gy, gz) owns cell (gz, gy by + ty,
    gx bx + tx) when inside the level, and writes its 2 x 2 x 2 fine
    points: every (j, k) cell of a plane once, and gz = i, so every fine
    point once."""
    lay = T.prolong_layout(fine)
    Xc, Yc, Zc = (n // 2 for n in fine)
    assert (lay.Xc, lay.Yc, lay.Zc, lay.gz) == (Xc, Yc, Zc, Xc)
    assert lay.bx * lay.by <= T.CELL_THREADS
    k = (np.arange(lay.gx)[:, None] * lay.bx + np.arange(lay.bx)).ravel()
    j = (np.arange(lay.gy)[:, None] * lay.by + np.arange(lay.by)).ravel()
    k, j = np.meshgrid(k, j, indexing="ij")
    keep = (k < Zc) & (j < Yc)
    k, j = k[keep], j[keep]
    cells = np.bincount(j * Zc + k, minlength=Yc * Zc)
    assert np.all(cells == 1)
    Y, Z = fine[1], fine[2]
    pts = np.concatenate([(2 * j + py) * Z + 2 * k + pz
                          for py in (0, 1) for pz in (0, 1)])
    assert np.all(np.bincount(pts, minlength=Y * Z) == 1)


# ------------------------------------------------- the kernels' schedules


def _smooth3(a, b, c):
    return (0.25 * a + 0.5 * b) + 0.25 * c


def _walk(v, f, lay, w):
    """csrc/transfer.cu restrict_walk_kernel in PyTorch, CTA by CTA and
    plane by plane, in the kernel's order of operations."""
    X, Y, Z = v.shape
    Xc, Yc, Zc = lay.Xc, lay.Yc, lay.Zc
    res = bool(lay.with_residual)
    RR, TJ = lay.RR, lay.TJ
    out = torch.full((Xc, Yc, Zc), float("nan"))
    zmask = torch.arange(Z) >= 1
    for bx in range(lay.grid_x):
        for by in range(lay.grid_y):
            J0, I0 = bx * TJ, by * lay.NI
            x0 = 2 * I0 - 1
            rows_v = (2 * J0 - (2 if res else 1) + torch.arange(lay.RV)) % Y
            rows_r = (2 * J0 - 1 + torch.arange(RR)) % Y

            def staged(a, x, rows):  # plane x of a, the tile's rows
                return a[x % X][rows]

            c0 = 1 if res else 0  # the thread's row in a staged v plane
            vm = staged(v, x0 - 1, rows_v)[c0:c0 + RR]
            vc = staged(v, x0, rows_v)[c0:c0 + RR]
            ra = rb = None
            for s in range(2 * lay.NI + 1):
                x = x0 + s
                pc = staged(v, x, rows_v)
                vp = staged(v, x + 1, rows_v)[c0:c0 + RR]
                if res:
                    c2 = 2.0 * vc
                    t0 = (vm - c2) + vp
                    lv = t0 * w[0]
                    t1 = (pc[:RR] - c2) + pc[2:RR + 2]
                    lv = lv + t1 * w[1]
                    t2 = (torch.roll(vc, 1, 1) - c2) + torch.roll(vc, -1, 1)
                    lv = lv + t2 * w[2]
                    m = (torch.tensor(x % X >= 1) & (rows_r >= 1)[:, None]
                         & zmask[None, :]).to(torch.float32)
                    a = m * (staged(f, x, rows_r) - lv)
                else:
                    a = vc
                if s >= 2 and s % 2 == 0:
                    _coarse(out, _smooth3(ra, rb, a), rb[1::2, 0::2],
                            I0 + (s - 2) // 2, J0, TJ)
                ra, rb = rb, a
                vm, vc = vc, vp
    return out


def _coarse(out, sx, inj, I, J0, TJ):
    """The walk's coarse phase of plane I: y, then z smoothing at the even
    points of the x-smoothed plane sx (rows 2 J0 - 1 ...), injection
    where I, J or K is 0."""
    Zc = out.shape[2]
    K = torch.arange(Zc)
    sy = [_smooth3(sx[0:2 * TJ:2][:, z], sx[1:2 * TJ + 1:2][:, z],
                   sx[2:2 * TJ + 2:2][:, z])
          for z in ((2 * K - 1 + d) % sx.shape[1] for d in range(3))]
    sm = _smooth3(*sy)
    J = J0 + torch.arange(TJ)
    interior = (torch.tensor(I >= 1) & (J >= 1)[:, None]
                & (K >= 1)[None, :])
    sv = torch.where(interior, sm, inj)
    out[I, J0:J0 + TJ] = inj + interior.to(torch.float32) * (sv - inj)


def _cells(c, vb, mode, out):
    """csrc/transfer.cu prolong_cell_kernel in PyTorch, every cell at
    once: its 8 wrapped corners, its 8 base values read before any of its
    points is written, x, then y, then z interpolation, the blend."""
    Xc, Yc, Zc = c.shape
    corner = {(dx, dy, dz): torch.roll(c, (-dx, -dy, -dz), (0, 1, 2))
              for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)}
    b6 = vb.view(Xc, 2, Yc, 2, Zc, 2)
    base = {(px, py): b6[:, px, :, py].clone() for px in (0, 1)
            for py in (0, 1)}
    o6 = out.view(Xc, 2, Yc, 2, Zc, 2)
    ar = [torch.arange(n) for n in (Xc, Yc, Zc)]

    def lerp(a, b, odd):
        return 0.5 * (a + b) if odd else a

    for px in (0, 1):
        ax = {(dy, dz): lerp(corner[0, dy, dz], corner[1, dy, dz], px)
              for dy in (0, 1) for dz in (0, 1)}
        for py in (0, 1):
            ay = [lerp(ax[0, dz], ax[1, dz], py) for dz in (0, 1)]
            for pz in (0, 1):
                up = lerp(ay[0], ay[1], pz)
                m = ((2 * ar[0] + px >= 1)[:, None, None]
                     & (2 * ar[1] + py >= 1)[None, :, None]
                     & (2 * ar[2] + pz >= 1)[None, None, :]).to(
                         torch.float32)
                b = base[px, py][..., pz]
                o6[:, px, :, py, :, pz] = (b + m * (up - b)
                                           if mode == "replace"
                                           else b + m * up)
    return out


def _inputs(fine, seed):
    rng = np.random.default_rng(seed)
    coarse = tuple(n // 2 for n in fine)
    v = torch.tensor((rng.standard_normal(fine)
                      * TG.wrap_interior(fine)).astype(np.float32))
    f = torch.tensor(rng.standard_normal(fine).astype(np.float32))
    c = torch.tensor((rng.standard_normal(coarse)
                      * TG.wrap_interior(coarse)).astype(np.float32))
    return v, f, c


SCHEDULE_PAIRS = [(16, 16, 16), (8, 4, 16), (4, 4, 4)]


@pytest.mark.parametrize("fine", SCHEDULE_PAIRS)
@pytest.mark.parametrize("with_residual", [True, False])
def test_walk_emulation_is_plain_bitwise(fine, with_residual):
    """The walk at the package's layout and at other tiles and bands
    equals residual_restrict_plain bit for bit; restrict alone on f, whose
    boundary planes are not zero (the FMG right-hand-side cascade)."""
    gf, gc = _geoms(fine)
    v, f, _ = _inputs(fine, seed=sum(fine))
    src = v if with_residual else f
    prob = TPoisson(3)
    want = T.residual_restrict_plain(src, f, prob, gf, gc, with_residual)
    w = inv_h2(gf)
    lays = [T.restrict_layout(fine, with_residual)]
    lays += [lay for lay in (T.walk_layout(fine, with_residual, TJ, b)
                             for TJ in (1, 2) for b in (1, 2))
             if lay is not None]
    for lay in lays:
        got = _walk(src, f, lay, w)
        assert torch.equal(got, want), lay.as_dict()
    # the package's wrapper on CPU tensors is the plain version
    got = T.residual_restrict(src, f, prob, gf, gc,
                              with_residual=with_residual)
    assert torch.equal(got, want)


def test_walk_emulation_matches_jax_restriction():
    """The emulated walk (restrict alone) against the JAX package's jnp
    restrict_full_weighting, within 2 ulp of the largest value."""
    fine = (16, 16, 16)
    _, f, _ = _inputs(fine, seed=5)
    got = _walk(f, f, T.restrict_layout(fine, False), (1.0, 1.0, 1.0))
    m_c = TG.wrap_interior(got.shape).astype(np.float32)
    want = np.asarray(JS.restrict_full_weighting(jnp.asarray(f.numpy()),
                                                 jnp.asarray(m_c)))
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=2 * np.spacing(np.float32(scale)))


@pytest.mark.parametrize("fine", SCHEDULE_PAIRS + [(32, 32, 32)])
@pytest.mark.parametrize("mode", ["add", "replace"])
def test_cell_emulation_is_plain_bitwise(fine, mode):
    """The cell form equals prolong_blend_plain bit for bit, into a new
    tensor and in place into the base."""
    v, _, c = _inputs(fine, seed=len(mode) + fine[2])
    want = T.prolong_blend_plain(c, v, mode)
    got = _cells(c, v, mode, torch.empty_like(v))
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    base = v.clone()
    _cells(c, base, mode, base)
    assert torch.equal(base.view(torch.int32), want.view(torch.int32))


def test_cell_emulation_matches_jax_prolongation():
    """The emulated cells in add mode on a zero base against the JAX
    package's periodic prolong_linear on the interior, within 2 ulp."""
    fine = (16, 8, 16)
    _, _, c = _inputs(fine, seed=6)
    got = _cells(c, torch.zeros(fine), "add", torch.empty(fine))
    up = np.asarray(JS.prolong_linear(jnp.asarray(c.numpy()), fine,
                                      periodic=True))
    want = up * TG.wrap_interior(fine)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=2 * np.spacing(np.float32(scale)))
