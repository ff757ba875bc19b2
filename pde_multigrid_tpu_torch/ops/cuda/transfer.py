"""Fused inter-grid transfers and the residual on 3D wrap levels: the CUDA
kernels of `csrc/transfer.cu` and their plain PyTorch versions.

Replaces the TPU kernels `pde_multigrid_tpu/ops/pallas/transfer.py`
`make_residual_restrict` (both modes), `make_prolong_blend` (both modes)
and `make_residual` (with f, and f-less: `residual_zero_f`, the FAS
cycle's coarse right side, residual(v, 0) without a zero f).  The plain
versions are the jnp-tier forms the TPU kernels are tested against:
`stencil.restrict_full_weighting` of the residual, `stencil.prolong_linear`
(periodic) blended on the interior, and `Poisson.kernel_operator` for
L v.

The same two transfer kernels serve the sub-lane pairs (fine level of at
most 32^3 on the 3D presets) for which JAX has its own small resident
kernels, `pde_multigrid_tpu/ops/pallas/subtree.py` `make_small_restrict`
(the restrict-only mode here) and `make_small_prolong_blend` (both modes):
those compute the same functions, so one kernel each replaces both TPU
kernels.  `launches_by_fine` splits the launches by the fine level.

Each launch's form and geometry come from the level's shape alone:
`restrict_layout` (the plane walk where the extents are powers of two and
a tile of all of z fits one CTA, else one coarse point a thread),
`prolong_layout` (one coarse cell a thread) and `residual_layout` (the
residual's walk of x planes where the extents are powers of two and the
level is not small, else a point a thread).

Each wrapper launches its kernel for CUDA tensors, runs the plain version
for CPU tensors, and raises for anything else; there is no fallback from
a CUDA tensor to the plain version.  `launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from pde_multigrid_tpu_torch.grid import LevelGeometry
from pde_multigrid_tpu_torch.models.poisson import inv_h2
from pde_multigrid_tpu_torch.ops import stencil
from pde_multigrid_tpu_torch.ops.cuda import build
from pde_multigrid_tpu_torch.ops.cuda.relax import (
    _check_poisson,
    _on_cuda,
    _stream,
)

launches = {"residual": 0, "residual_zero_f": 0, "residual_restrict": 0,
            "prolong_blend": 0}
# the same launches of residual_restrict (key "residual_restrict" with the
# residual, "restrict" without) and prolong_blend by the fine level's
# shape, and of the residual (keys "residual", "residual_zero_f") by the
# level's, counted at the same place as `launches`
launches_by_fine: dict[tuple[str, tuple[int, ...]], int] = {}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0
    launches_by_fine.clear()


def _count(name: str, key: str, fine_shape) -> None:
    launches[name] += 1
    k = (key, tuple(fine_shape))
    launches_by_fine[k] = launches_by_fine.get(k, 0) + 1


def _wrap_m_int(shape, device) -> torch.Tensor:
    """Wrap-storage interior of a 3D level (index >= 1 on every axis),
    built on the device (no host copy, so it can run inside a CUDA
    graph capture)."""
    X, Y, Z = shape
    x = torch.arange(X, device=device)[:, None, None] >= 1
    y = torch.arange(Y, device=device)[None, :, None] >= 1
    z = torch.arange(Z, device=device)[None, None, :] >= 1
    return (x & y & z).to(torch.float32)


def _check_level(t: torch.Tensor, geom: LevelGeometry, what: str) -> None:
    if not geom.wrap or geom.ndim != 3:
        raise ValueError("the transfer kernels serve 3D wrap levels only")
    if tuple(t.shape) != tuple(geom.padded_shape):
        raise ValueError(
            f"{what} shape {tuple(t.shape)} != level {geom.padded_shape}"
        )


# ------------------------------------------------------------ layouts

# the walk (csrc/transfer.cu restrict_walk_kernel): its ring of staged
# planes, the most threads and shared memory a CTA takes, coarse rows a
# tile by the fine level's z extent (all of z a tile), and the CTAs the
# bands aim at: about one an SM of an H100 SXM's 132 (a 512^3 CTA holds
# 640 threads of 60 registers; on an H100 one wave of long walks beat
# more, shorter ones, which re-read a band's two extra planes:
# scripts/probe_transfer.py)
WALK, POINT = 1, 0
WALK_STAGES = 4
MAX_WALK_THREADS = 1024
MAX_SMEM_BYTES = 232448
WALK_ROWS = {512: 2, 256: 4, 128: 8}
WALK_ROWS_SMALL = 4
WALK_CTAS = 128
POINT_THREADS = 256  # the point form's CTA
# the cell form's threads a CTA (csrc/transfer.cu kThreads)
CELL_THREADS = 256
# the residual's walk (csrc/transfer.cu residual_walk_kernel): rows a tile
# (all of z a tile), the CTAs the bands aim at, and the largest level
# (points) left to the point form.  On an H100 4 rows and 512 CTAs (about
# four 512-thread CTAs an SM at 512^3, co-resident) came within 3 % of the
# best layout on 512^3 ... 64^3, with f and f-less, where one wave of 128
# CTAs took 1.25 times as long at 512^3; on 32^3 and below, where a launch
# is its latency, the point form beat every walk (scripts/probe_residual.py)
RESIDUAL_ROWS = 4
RESIDUAL_CTAS = 512
RESIDUAL_POINT_MAX = 32 ** 3


class RestrictLayout(ctypes.Structure):
    """The kernel's `RestrictLayout` (csrc/transfer.cu): the coarse level,
    the mode and form; for the walk the tile's coarse rows TJ, the band's
    coarse planes NI, the fine rows of a residual plane (RR) and of a
    staged v plane (RV); threads a CTA, the grid (row tiles and bands; the
    point form's CTAs and 1) and the dynamic shared memory."""

    _fields_ = [(name, ctypes.c_int)
                for name in ("Xc", "Yc", "Zc", "with_residual", "form", "TJ",
                             "NI", "RR", "RV", "threads", "grid_x", "grid_y",
                             "smem_bytes")]

    def as_dict(self) -> dict:
        return {name: getattr(self, name) for name, _ in self._fields_}


class ProlongLayout(ctypes.Structure):
    """The kernel's `ProlongLayout` (csrc/transfer.cu): the coarse level,
    threads a CTA along k and j, and CTAs along k, j and i (one coarse
    cell a thread)."""

    _fields_ = [(name, ctypes.c_int)
                for name in ("Xc", "Yc", "Zc", "bx", "by", "gx", "gy", "gz")]

    def as_dict(self) -> dict:
        return {name: getattr(self, name) for name, _ in self._fields_}


class ResidualLayout(ctypes.Structure):
    """The kernel's `ResidualLayout` (csrc/transfer.cu): the level, the
    mode (with f or f-less) and form; for the walk the tile's rows TJ, the
    band's planes NX and the rows of a staged v plane RV; threads a CTA
    (along z and y), the CTAs (the walk: row tiles, bands, 1; the point
    form: along z, y and x) and the dynamic shared memory."""

    _fields_ = [(name, ctypes.c_int)
                for name in ("X", "Y", "Z", "with_f", "form", "TJ", "NX",
                             "RV", "bx", "by", "gx", "gy", "gz",
                             "smem_bytes")]

    def as_dict(self) -> dict:
        return {name: getattr(self, name) for name, _ in self._fields_}


def _pow2(n: int) -> bool:
    return n > 0 and n & (n - 1) == 0


def _coarse(fine_shape) -> tuple[int, int, int]:
    X, Y, Z = fine_shape
    if X % 2 or Y % 2 or Z % 2 or min(X, Y, Z) < 2:
        raise ValueError(f"fine level {tuple(fine_shape)} has no coarse "
                         "level of half its extents")
    return X // 2, Y // 2, Z // 2


def walk_layout(fine_shape, with_residual: bool, TJ: int,
                bands: int) -> RestrictLayout | None:
    """The walk's layout on fine level `fine_shape` with tiles of TJ
    coarse rows and `bands` bands of planes, or None where the walk cannot
    take it: an extent not a power of two, z under 4, TJ or `bands` not
    dividing the coarse extent, or a CTA past 1024 threads or 227 KB."""
    Xc, Yc, Zc = _coarse(fine_shape)
    Z = 2 * Zc
    if not all(map(_pow2, fine_shape)) or Z < 4:
        return None
    if TJ < 1 or bands < 1 or Yc % TJ or Xc % bands:
        return None
    RR = 2 * TJ + 1
    RV = RR + 2 if with_residual else RR
    threads = -(-RR * (Z // 4) // 32) * 32
    slot = (RV + (RR if with_residual else 0)) * Z
    smem = 4 * (WALK_STAGES * slot + RR * Z + TJ * Zc)
    if threads > MAX_WALK_THREADS or smem > MAX_SMEM_BYTES:
        return None
    return RestrictLayout(Xc, Yc, Zc, int(with_residual), WALK, TJ,
                          Xc // bands, RR, RV, threads, Yc // TJ, bands, smem)


def point_layout(fine_shape, with_residual: bool) -> RestrictLayout:
    """The point form's layout: a coarse point a thread."""
    Xc, Yc, Zc = _coarse(fine_shape)
    n = Xc * Yc * Zc
    return RestrictLayout(Xc, Yc, Zc, int(with_residual), POINT, 0, 0, 0, 0,
                          POINT_THREADS, -(-n // POINT_THREADS), 1, 0)


@functools.lru_cache(maxsize=128)
def restrict_layout(fine_shape: tuple[int, int, int],
                    with_residual: bool) -> RestrictLayout:
    """The launch of residual_restrict (both modes) on fine level
    `fine_shape`: the walk with tiles of WALK_ROWS coarse rows (at most
    the level's) and the fewest bands (a power of two) with which the
    tiles make WALK_CTAS CTAs; a band a coarse plane where that makes at
    most 2 WALK_CTAS (the small levels, where a launch is mostly its
    latency); the point form where the walk cannot take the level.
    Cached: the wrapper asks at every launch."""
    fine_shape = tuple(fine_shape)
    Xc, Yc, Zc = _coarse(fine_shape)
    TJ = min(WALK_ROWS.get(fine_shape[2], WALK_ROWS_SMALL), Yc)
    tiles = Yc // TJ
    bands = 1
    if tiles * Xc <= 2 * WALK_CTAS:
        bands = Xc
    while bands < Xc and tiles * bands < WALK_CTAS:
        bands *= 2
    return (walk_layout(fine_shape, with_residual, TJ, bands)
            or point_layout(fine_shape, with_residual))


@functools.lru_cache(maxsize=128)
def prolong_layout(fine_shape: tuple[int, int, int]) -> ProlongLayout:
    """The launch of prolong_blend on fine level `fine_shape`: a coarse
    cell a thread, up to 128 along k a CTA and the rest of CELL_THREADS
    along j, a CTA row of coarse planes along i."""
    Xc, Yc, Zc = _coarse(tuple(fine_shape))
    bx = min(Zc, 128)
    by = max(1, min(Yc, CELL_THREADS // bx))
    return ProlongLayout(Xc, Yc, Zc, bx, by, -(-Zc // bx), -(-Yc // by), Xc)


def residual_walk_layout(shape, with_f: bool, TJ: int,
                         bands: int) -> ResidualLayout | None:
    """The residual walk's layout on level `shape` with tiles of TJ rows
    and `bands` bands of planes, or None where the walk cannot take it: an
    extent not a power of two, z under 4, TJ or `bands` not dividing the
    extent, or a CTA past 1024 threads or 227 KB."""
    X, Y, Z = shape
    if not all(map(_pow2, shape)) or Z < 4:
        return None
    if TJ < 1 or bands < 1 or Y % TJ or X % bands:
        return None
    RV = TJ + 2
    threads = -(-TJ * (Z // 4) // 32) * 32
    smem = 4 * WALK_STAGES * RV * Z
    if threads > MAX_WALK_THREADS or smem > MAX_SMEM_BYTES:
        return None
    return ResidualLayout(X, Y, Z, int(with_f), WALK, TJ, X // bands, RV,
                          threads, 1, Y // TJ, bands, 1, smem)


def residual_point_layout(shape, with_f: bool) -> ResidualLayout:
    """The point form's layout: a point a thread, up to 128 threads along
    z a CTA and the rest of POINT_THREADS along y, a CTA row of planes
    along x."""
    X, Y, Z = shape
    bx = min(Z, 128)
    by = max(1, min(Y, POINT_THREADS // bx))
    if -(-Y // by) > 65535 or X > 65535:
        raise ValueError(f"level {tuple(shape)} is past the point form's "
                         "grid")
    return ResidualLayout(X, Y, Z, int(with_f), POINT, 0, 0, 0, bx, by,
                          -(-Z // bx), -(-Y // by), X, 0)


@functools.lru_cache(maxsize=128)
def residual_layout(shape: tuple[int, int, int],
                    with_f: bool) -> ResidualLayout:
    """The launch of the residual (with f or f-less) on level `shape`: the
    walk on levels of more than RESIDUAL_POINT_MAX points, tiles of
    RESIDUAL_ROWS rows (at most the level's, and fewer where a tile of 4
    rows of z would pass 1024 threads) and the fewest bands (a power of
    two) with which the tiles make RESIDUAL_CTAS CTAs; the point form on
    the small levels and where the walk cannot take the level.  Cached:
    the wrapper asks at every launch."""
    shape = tuple(shape)
    X, Y, Z = shape
    if X * Y * Z > RESIDUAL_POINT_MAX:
        TJ = max(1, min(RESIDUAL_ROWS, Y, 4 * MAX_WALK_THREADS // Z))
        bands = 1
        while bands < X and (Y // TJ) * bands < RESIDUAL_CTAS:
            bands *= 2
        lay = residual_walk_layout(shape, with_f, TJ, bands)
        if lay is not None:
            return lay
    return residual_point_layout(shape, with_f)


def _check_pair(geom_f: LevelGeometry, geom_c: LevelGeometry) -> None:
    if tuple(geom_f.padded_shape) != tuple(
        2 * n for n in geom_c.padded_shape
    ):
        raise ValueError(
            f"fine {geom_f.padded_shape} is not twice coarse "
            f"{geom_c.padded_shape}"
        )


# ------------------------------------------------------ plain versions


def residual_plain(v, f, problem, geom: LevelGeometry):
    """m_int * (f - L v) with L v in Poisson.kernel_operator's form; f None
    is the f-less mode, m_int * (0 - L v), residual(v, 0) bit for bit."""
    Lv = problem.kernel_operator(
        v, geom, lambda a, ax, off: torch.roll(a, -off, dims=ax)
    )
    return _wrap_m_int(v.shape, v.device) * ((0.0 if f is None else f) - Lv)


def residual_restrict_plain(v, f, problem, geom_f, geom_c, with_residual):
    """R(m_int * (f - L v)), or R(v) when not with_residual; R is
    stencil.restrict_full_weighting (boundary planes injected)."""
    a = residual_plain(v, f, problem, geom_f) if with_residual else v
    m_c = _wrap_m_int(geom_c.padded_shape, v.device)
    return stencil.restrict_full_weighting(a, m_c)


def prolong_blend_plain(c, vb, mode: str):
    """add: vb + m_int * P(c); replace: vb + m_int * (P(c) - vb)."""
    up = stencil.prolong_linear(c, tuple(vb.shape), periodic=True)
    m = _wrap_m_int(vb.shape, vb.device)
    return vb + m * up if mode == "add" else vb + m * (up - vb)


# ------------------------------------------------------------ wrappers


def _launch_residual(v, f, problem, geom, key):
    out = torch.empty_like(v)
    _check_poisson(problem)
    lay = residual_layout(tuple(v.shape), f is not None)
    if lay.form == WALK and any(t.data_ptr() % 16 for t in (v, f, out)
                                if t is not None):
        raise ValueError("the residual walk takes 16-byte aligned tensors")
    w0, w1, w2 = inv_h2(geom)
    rc = build.load().lib.pdemg_residual(
        v.data_ptr(), None if f is None else f.data_ptr(), out.data_ptr(),
        ctypes.byref(lay), w0, w1, w2, _stream(),
    )
    _count(key, key, v.shape)
    build.check(rc, key)
    return out


def residual(v, f, problem, geom: LevelGeometry):
    """r = m_int * (f - L v), dense (X, Y, Z)."""
    _check_level(v, geom, "v")
    _check_level(f, geom, "f")
    if not _on_cuda(v, f):
        return residual_plain(v, f, problem, geom)
    return _launch_residual(v, f, problem, geom, "residual")


def residual_zero_f(v, problem, geom: LevelGeometry):
    """r = m_int * (0 - L v), dense (X, Y, Z): residual(v, 0), reading no
    f (the FAS cycle's coarse right side)."""
    _check_level(v, geom, "v")
    if not _on_cuda(v):
        return residual_plain(v, None, problem, geom)
    return _launch_residual(v, None, problem, geom, "residual_zero_f")


def residual_restrict(
    v, f, problem, geom_f: LevelGeometry, geom_c: LevelGeometry,
    with_residual: bool = True,
):
    """Coarse (X/2, Y/2, Z/2) = R(m_int * (f - L v)), or R(v) alone when
    `with_residual` is False (`f` is then ignored and may be None)."""
    _check_pair(geom_f, geom_c)
    _check_level(v, geom_f, "v")
    if f is None or not with_residual:
        f = v
    _check_level(f, geom_f, "f")
    if not _on_cuda(v, f):
        return residual_restrict_plain(v, f, problem, geom_f, geom_c,
                                       with_residual)
    out = torch.empty(geom_c.padded_shape, dtype=v.dtype, device=v.device)
    if with_residual:
        _check_poisson(problem)
    lay = restrict_layout(tuple(v.shape), bool(with_residual))
    w0, w1, w2 = inv_h2(geom_f)
    rc = build.load().lib.pdemg_residual_restrict(
        v.data_ptr(), f.data_ptr(), out.data_ptr(), ctypes.byref(lay),
        w0, w1, w2, _stream(),
    )
    _count("residual_restrict",
           "residual_restrict" if with_residual else "restrict", v.shape)
    build.check(rc, "residual_restrict")
    return out


def prolong_blend(
    c, vb, mode: str, geom_c: LevelGeometry, geom_f: LevelGeometry,
    out=None,
):
    """Trilinear prolongation of coarse `c` blended into fine `vb` on the
    interior (`mode` 'add' or 'replace').  `out` may be `vb` itself: each
    point reads its own base value before writing it."""
    if mode not in ("add", "replace"):
        raise ValueError(f"unknown prolong mode {mode!r}")
    _check_pair(geom_f, geom_c)
    _check_level(c, geom_c, "coarse")
    _check_level(vb, geom_f, "base")
    if out is None:
        out = torch.empty_like(vb)
    _check_level(out, geom_f, "out")
    if not _on_cuda(c, vb, out):
        return out.copy_(prolong_blend_plain(c, vb, mode))
    rc = build.load().lib.pdemg_prolong_blend(
        c.data_ptr(), vb.data_ptr(), out.data_ptr(),
        ctypes.byref(prolong_layout(tuple(vb.shape))),
        int(mode == "replace"), _stream(),
    )
    _count("prolong_blend", "prolong_blend", vb.shape)
    build.check(rc, "prolong_blend")
    return out
