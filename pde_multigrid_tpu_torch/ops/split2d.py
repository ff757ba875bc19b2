"""Persistent color-split execution for big padded 2D levels (PyTorch port
of `pde_multigrid_tpu.ops.split2d`).

A level's state stays in the red/black half layout across a whole cycle
visit: the relax legs run on halves (`ops/cuda/relax2d.py`), and so do the
two ops between them, residual+restrict and prolong+blend, given here.
These are plain torch ops, on the card too: the JAX package runs them as
XLA ops, not as Pallas kernels.

Layout (== `ops/cuda/relax2d.py`): q = x % 2; red points of row x sit at
y = 2j + q, black at y = 2j + 1 - q, for j < Y2 = ceil(Y/2).  With an odd
extent Y (every 2^k + 1 level: the port pads nothing) one slot per row is
inert: y = Y lies past the array.  It holds 0, no mask covers it and no
merge reads it.  Values at even fine y sit at half index j = y/2 of the
q-dependent half (even = where(q, black, red)), and odd y likewise, so
the y sides of restriction and prolongation are neighbor selects within a
row.  The x sides are strided slices (the JAX package contracts with
pick matrices on the TPU's matrix unit).

Reference ops: 2D CalculateResidual `MultiGrid2D.cpp:367-408`, Restrict
`:63-126`, Interpolate `:128-196`, ApplyCorrection `:343-366`.
"""

from __future__ import annotations

import functools

import torch

from pde_multigrid_tpu_torch.grid import LevelGeometry
from pde_multigrid_tpu_torch.ops import stencil


def half_width(geom: LevelGeometry) -> int:
    """Y2 = ceil(Y/2) slots per row of each half."""
    return (geom.padded_shape[1] + 1) // 2


def check_level(geom: LevelGeometry) -> None:
    if geom.ndim != 2 or geom.wrap:
        raise ValueError(
            f"the 2D half layout serves padded 2D levels, got {geom}"
        )


def q1_rows(X: int, device) -> torch.Tensor:
    """bool (X, 1): q(x) = x % 2 == 1."""
    return (torch.arange(X, device=device) % 2 == 1)[:, None]


@functools.lru_cache(maxsize=32)
def _layout(geom: LevelGeometry, dtype, device):
    return rows_layout(geom, 0, geom.padded_shape[0], dtype, device)


def rows_layout(geom: LevelGeometry, g0: int, rows: int, dtype, device):
    """The half layout of `rows` rows whose first is global row `g0`
    (of the level or past its ends): coordinates, y indices, interior
    masks and q1, each from the global row, as `_layout` gives them for
    the whole level."""
    Y2 = half_width(geom)
    g = g0 + torch.arange(rows, device=device)[:, None]
    jj = torch.arange(Y2, device=device)[None, :]
    qi = g % 2
    y_r = 2 * jj + qi
    y_b = 2 * jj + 1 - qi
    (lo0, hi0), (lo1, hi1) = geom.domain

    def coord(idx, ax, lo, hi):
        x = torch.tensor(geom.origin[ax], dtype=dtype) + idx.to(
            dtype
        ) * torch.tensor(geom.spacing[ax], dtype=dtype)
        return torch.clamp(x, min(lo, hi), max(lo, hi))

    xf = coord(g, 0, lo0, hi0)
    nx, ny = geom.shape
    okx = (g >= 1) & (g <= nx - 2)
    m_r = ((y_r >= 1) & (y_r <= ny - 2) & okx).to(dtype)
    m_b = ((y_b >= 1) & (y_b <= ny - 2) & okx).to(dtype)
    return {
        "coords": ((xf, coord(y_r, 1, lo1, hi1)),
                   (xf, coord(y_b, 1, lo1, hi1))),
        "y": (y_r, y_b),
        "masks": (m_r, m_b),
        "q1": qi == 1,
    }


def color_coords(geom: LevelGeometry, dtype, device="cpu"):
    """((x, y_red), (x, y_black)) physical coordinates of each color's
    points in half layout, domain-clamped like LevelGeometry.coords1d and
    the relax kernels' in-kernel coordinates; x is (X, 1), y (X, Y2).
    Also the integer y index of each slot: ((...), (...), (y_r, y_b))."""
    lay = _layout(geom, dtype, torch.device(device))
    return (*lay["coords"], lay["y"])


def interior_masks_halves(geom: LevelGeometry, dtype, device="cpu"):
    """(m_red, m_black) interior masks in half layout, 1.0/0.0 in `dtype`:
    the pure geometric interior (inert slots and boundary are 0)."""
    return _layout(geom, dtype, torch.device(device))["masks"]


def _nbr_factory(other: torch.Tensor, q1b: torch.Tensor):
    """Opposite-color neighbor access on whole halves: x neighbors share
    j, y neighbors take a select by q.  Rolls wrap only onto masked
    boundary rows and inert slots."""

    def nbr(ax: int, off: int):
        if ax == 0:
            return torch.roll(other, -off, dims=0)
        if off == +1:
            return torch.where(q1b, torch.roll(other, -1, dims=1), other)
        return torch.where(q1b, other, torch.roll(other, 1, dims=1))

    return nbr


def residual_halves(problem, geom: LevelGeometry, r, b, fr, fb):
    """(rr, rb) = split(m_int * (f - L v)) computed directly on halves
    through problem.split_operator2d; fr/fb None means f == 0."""
    check_level(geom)
    lay = _layout(geom, r.dtype, r.device)
    q1 = lay["q1"]
    cr, cb = lay["coords"]
    m_r, m_b = lay["masks"]
    Lr = problem.split_operator2d(r, _nbr_factory(b, q1), cr, geom)
    Lb = problem.split_operator2d(b, _nbr_factory(r, ~q1), cb, geom)
    rr = m_r * ((-Lr) if fr is None else (fr - Lr))
    rb = m_b * ((-Lb) if fb is None else (fb - Lb))
    return rr, rb


def restrict_residual_from_halves(
    geom_f: LevelGeometry,
    geom_c: LevelGeometry,
    rr: torch.Tensor,
    rb: torch.Tensor,
    m_int_c: torch.Tensor,
    m_log_c: torch.Tensor | None,
) -> torch.Tensor:
    """Full-weighting restriction of an interior-masked (residual-like)
    field given in halves, to the dense coarse array.  The field vanishes
    on the fine boundary, so the coarse-boundary injection is zero and
    the result is `m_int * smoothed`.  y first, within rows on the halves;
    then x, rows 2c-1, 2c, 2c+1 with [1/4, 1/2, 1/4] (absent rows past
    the logical extent count as zero)."""
    check_level(geom_f)
    X = rr.shape[0]
    q1 = q1_rows(X, rr.device)
    even = torch.where(q1, rb, rr)  # fine y = 2j
    odd = torch.where(q1, rr, rb)  # fine y = 2j + 1
    # sm_y[x, jc] = 1/4 f[2jc-1] + 1/2 f[2jc] + 1/4 f[2jc+1]
    sm_y = 0.5 * even + 0.25 * (odd + torch.roll(odd, 1, dims=1))
    a = sm_y[: geom_f.shape[0]]
    zero = a.new_zeros((1, a.shape[1]))
    mid = a[0::2]
    lo = torch.cat([zero, a[1::2]])  # row c <- a[2c - 1]
    hi = torch.cat([a[1::2], zero])  # row c <- a[2c + 1]
    sm = 0.25 * lo + 0.5 * mid + 0.25 * hi
    out = stencil._fit(sm, geom_c.padded_shape) * m_int_c
    if m_log_c is not None:
        out = out * m_log_c
    return out


def prolong_blend_halves(
    geom_c: LevelGeometry,
    geom_f: LevelGeometry,
    c: torch.Tensor,
    r: torch.Tensor,
    b: torch.Tensor,
    mode: str,
):
    """Bilinear prolongation of the dense coarse array blended into the
    fine halves on the interior, in place on (r, b), which it returns:

      mode='add':     h' = h + m * up(c)        (coarse-grid correction)
      mode='replace': h' = h + m * (up(c) - h)  (FMG solution transfer)

    x first (out[2i] = c[i], out[2i+1] = (c[i] + c[i+1]) / 2), then the
    y side per half: even fine y take the coarse value, odd ones the mean
    of two neighbors in the row."""
    if mode not in ("add", "replace"):
        raise ValueError(f"mode must be 'add' or 'replace', got {mode!r}")
    check_level(geom_f)
    X = geom_f.padded_shape[0]
    Y2 = half_width(geom_f)
    cy = stencil._upsample_axis(c[: geom_c.shape[0]], 0)
    cy = stencil._fit(cy, (X, Y2))
    up_even = cy  # fine y = 2j <- coarse j
    up_odd = 0.5 * (cy + torch.roll(cy, -1, dims=1))  # y = 2j + 1
    lay = _layout(geom_f, r.dtype, r.device)
    q1 = lay["q1"]
    m_r, m_b = lay["masks"]
    up_r = torch.where(q1, up_odd, up_even)
    up_b = torch.where(q1, up_even, up_odd)
    if mode == "add":
        r.add_(m_r * up_r)
        b.add_(m_b * up_b)
    else:
        r.add_(m_r * (up_r - r))
        b.add_(m_b * (up_b - b))
    return r, b
