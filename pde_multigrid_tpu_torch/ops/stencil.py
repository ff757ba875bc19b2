"""The core multigrid ops, dimension-generic, as plain tensor code
(PyTorch port of `pde_multigrid_tpu.ops.stencil`).

  * Red-black Gauss-Seidel is two masked whole-array updates per sweep.
  * Restriction is the separable tensor product of the 1D full-weighting
    stencil [1/4, 1/2, 1/4] at even fine points; coarse boundary points
    are injection.
  * Prolongation is the separable per-axis linear upsample.

Masks are float (1.0/0.0) fields from `grid.base_aux`; a masked update is
`v + m*(upd - v)`.  Every op keeps the JAX tier's operation order, so
float64 results agree to rounding and float32 results bit for bit where
the backends round alike.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

Tensor = torch.Tensor


def relax_rbgs(
    update_fn: Callable[[Tensor, Tensor], Tensor],
    v: Tensor,
    f: Tensor,
    m_red: Tensor,
    m_black: Tensor,
    nsweeps: int,
) -> Tensor:
    """`nsweeps` red-black Gauss-Seidel sweeps: red (even-parity
    interior) points first, then black.  Updates `v` in place (the masked
    blend touches each point once per color) and returns it."""
    for _ in range(nsweeps):
        v.add_(m_red * (update_fn(v, f) - v))
        v.add_(m_black * (update_fn(v, f) - v))
    return v


def relax_jacobi(
    update_fn: Callable[[Tensor, Tensor], Tensor],
    v: Tensor,
    f: Tensor,
    m_int: Tensor,
    omega: float,
    nsweeps: int,
) -> Tensor:
    """`nsweeps` damped (weighted) Jacobi sweeps: every interior point
    moves toward its local solve at once, scaled by omega.  Each sweep's
    update is computed whole before it is added, so `v` is updated in
    place and returned."""
    for _ in range(nsweeps):
        v.add_((omega * m_int) * (update_fn(v, f) - v))
    return v


def thomas_coefficients(a_rows, b_rows, c_rows):
    """(cp, alpha, beta), float64 numpy vectors: the coefficient half of
    the Thomas recurrence for per-row constant couplings, in JAX's order

        cp_i    = c_i / (b_i - a_i cp_{i-1})
        alpha_i = -a_i / (b_i - a_i cp_{i-1})
        beta_i  =  1   / (b_i - a_i cp_{i-1})

    so that dp_i = alpha_i dp_{i-1} + beta_i d_i and x_i = dp_i -
    cp_i x_{i+1}.  The line kernel (`ops/cuda/zebra_line.py`) takes them
    cast to the working dtype."""
    a64, b64, c64 = (np.asarray(r, np.float64) for r in (a_rows, b_rows,
                                                         c_rows))
    n = len(a64)
    cp, alpha, beta = np.zeros(n), np.zeros(n), np.zeros(n)
    cp_prev = 0.0
    for i in range(n):
        denom = b64[i] - a64[i] * cp_prev
        cp[i] = c64[i] / denom
        alpha[i] = -a64[i] / denom
        beta[i] = 1.0 / denom
        cp_prev = cp[i]
    return cp, alpha, beta


def thomas_tridiagonal(a_rows, b_rows, c_rows, d: Tensor, axis: int):
    """Batched Thomas solve of tridiagonal systems along `axis`: every line
    of `d` along it at once, a row a step.

    a/b/c are per-row coefficient vectors (length d.shape[axis]); rows
    with (a, b, c) = (0, 1, 0) are identity equations, which is how
    Dirichlet boundaries and padding fold in.  Host (numpy) vectors, as
    `line_system` gives them, take JAX's host branch: the coefficient
    recurrence in float64 on the host (`thomas_coefficients`), cast to d's
    dtype, and a device recurrence of one multiply-add a point and step,
    dp_i = alpha_i dp_{i-1} + beta_i d_i, x_i = dp_i - cp_i x_{i+1}.  JAX
    scans in blocks of 8 rows with identity padding rows (the same
    values); here the rows run one at a time.  Tensor coefficients take
    the device branch, the textbook recurrence with its two divides."""
    d = torch.movedim(d, axis, 0)
    n = d.shape[0]
    out = torch.empty_like(d)
    host = all(isinstance(r, np.ndarray) for r in (a_rows, b_rows, c_rows))
    if host:
        cp, alpha, beta = (
            torch.from_numpy(c).to(dtype=d.dtype, device=d.device)
            for c in thomas_coefficients(a_rows, b_rows, c_rows))
        dp = torch.zeros_like(d[0])
        for i in range(n):
            dp = alpha[i] * dp + beta[i] * d[i]
            out[i] = dp
        x = torch.zeros_like(d[0])
        for i in range(n - 1, -1, -1):
            x = out[i] - cp[i] * x
            out[i] = x
        return torch.movedim(out, 0, axis)
    a, b, c = (torch.as_tensor(r, dtype=d.dtype, device=d.device)
               for r in (a_rows, b_rows, c_rows))
    cps = torch.empty_like(d)
    cp = dp = torch.zeros_like(d[0])
    for i in range(n):
        denom = b[i] - a[i] * cp
        cp = c[i] / denom
        dp = (d[i] - a[i] * dp) / denom
        cps[i] = cp
        out[i] = dp
    x = torch.zeros_like(d[0])
    for i in range(n - 1, -1, -1):
        x = out[i] - cps[i] * x
        out[i] = x
    return torch.movedim(out, 0, axis)


def relax_zebra_line(
    line_system_fn,
    v: Tensor,
    f: Tensor,
    m_int: Tensor,
    line_axis: int,
    zebra_axis: int,
    zebra_masks: tuple[Tensor, Tensor],
    nsweeps: int,
) -> Tensor:
    """`nsweeps` zebra line relaxation sweeps: whole lines along
    `line_axis` solved exactly (`thomas_tridiagonal`), the even lines by
    their parity along `zebra_axis` first, then the odd ones.
    `line_system_fn(v, f) -> (a_rows, b_rows, c_rows, d)` builds the
    tridiagonal system with every off-line neighbour term moved to the
    right side, from the v of the half-sweep's start (so lines of one
    colour that neighbour each other, along the third axis of a 3D level,
    see each other's old values).  Returns a new tensor."""

    for _ in range(nsweeps):
        for m_zebra in zebra_masks:
            v = zebra_half_sweep(line_system_fn, v, f, m_int, line_axis,
                                 m_zebra)
    return v


def zebra_half_sweep(line_system_fn, v: Tensor, f: Tensor, m_int: Tensor,
                     line_axis: int, m_zebra: Tensor) -> Tensor:
    """One colour's half of a zebra sweep (`relax_zebra_line`): every line
    solved from the same v, the colour's interior points blended in;
    a new tensor."""
    a_r, b_r, c_r, d = line_system_fn(v, f)
    sol = thomas_tridiagonal(a_r, b_r, c_r, d, line_axis)
    return v + (m_zebra * m_int) * (sol - v)


def residual(
    apply_op: Callable[[Tensor], Tensor], v: Tensor, f: Tensor, m_int: Tensor
) -> Tensor:
    """r = f - L v on the interior, 0 on the boundary."""
    return m_int * (f - apply_op(v))


def _shift(a: Tensor, axis: int, offset: int) -> Tensor:
    """result[i] = a[i + offset]; wraparound only reaches boundary
    points, which all consumers overwrite or mask."""
    return torch.roll(a, -offset, dims=axis)


def _fit(a: Tensor, shape: tuple[int, ...]) -> Tensor:
    """Slice/zero-pad `a` to `shape` (only padding regions change)."""
    if tuple(a.shape) == tuple(shape):
        return a
    a = a[tuple(slice(0, min(s, t)) for s, t in zip(a.shape, shape))]
    if tuple(a.shape) == tuple(shape):
        return a
    out = a.new_zeros(shape)
    out[tuple(slice(0, s) for s in a.shape)] = a
    return out


def _subsample2(a: Tensor) -> Tensor:
    """Even-index stride-2 subsample on every axis, keeping the last
    index of odd extents (index 2m of a 2m+1 axis)."""
    return a[tuple(slice(None, None, 2) for _ in range(a.ndim))]


def restrict_full_weighting(
    fine: Tensor, m_int_coarse: Tensor, m_log_coarse: Tensor | None = None
) -> Tensor:
    """Full-weighting restriction (fine -> coarse), any dimension:
    separable [1/4, 1/2, 1/4] smoothing, then stride-2 subsampling;
    coarse boundary points are injection of the coincident fine point."""
    a = fine
    for ax in range(fine.ndim):
        a = 0.25 * _shift(a, ax, -1) + 0.5 * a + 0.25 * _shift(a, ax, +1)
    cshape = tuple(m_int_coarse.shape)
    smoothed = _fit(_subsample2(a), cshape)
    injected = _fit(_subsample2(fine), cshape)
    out = injected + m_int_coarse * (smoothed - injected)
    if m_log_coarse is not None:
        out = out * m_log_coarse
    return out


def _upsample_axis(a: Tensor, axis: int) -> Tensor:
    """Linear upsample m -> 2m-1 along `axis`:
    out[2i] = a[i], out[2i+1] = (a[i] + a[i+1]) / 2."""
    a = torch.movedim(a, axis, 0)
    mid = 0.5 * (a[:-1] + a[1:])
    body = torch.stack([a[:-1], mid], dim=1).reshape((-1,) + a.shape[1:])
    out = torch.cat([body, a[-1:]], dim=0)
    return torch.movedim(out, 0, axis)


def _upsample_axis_periodic(a: Tensor, axis: int) -> Tensor:
    """Linear upsample m -> 2m along `axis` under wrap storage:
    out[2i] = a[i], out[2i+1] = (a[i] + a[(i+1) mod m]) / 2.  The wrapped
    midpoint pairs the last stored plane with plane 0 — the zero
    boundary — which is the interpolated value at the last fine interior
    point."""
    a = torch.movedim(a, axis, 0)
    mid = 0.5 * (a + torch.roll(a, -1, dims=0))
    out = torch.stack([a, mid], dim=1).reshape((-1,) + a.shape[1:])
    return torch.movedim(out, 0, axis)


def prolong_linear(
    coarse: Tensor,
    fine_shape: tuple[int, ...] | None = None,
    periodic: bool = False,
) -> Tensor:
    """(Bi/tri)linear prolongation coarse -> fine, any dimension; returns
    the full fine-size array (callers apply it on the interior only).
    `periodic` selects the wrap-storage upsample (m -> 2m)."""
    a = coarse
    up = _upsample_axis_periodic if periodic else _upsample_axis
    for ax in range(coarse.ndim):
        a = up(a, ax)
    if fine_shape is not None:
        a = _fit(a, fine_shape)
    return a


def inject(fine: Tensor, coarse_shape: tuple[int, ...]) -> Tensor:
    """Straight injection fine -> coarse: coarse[j] = fine[2j], fitted to
    the coarse shape (FAS restricts the current iterate with it).  Where
    no fitting is needed the result is a strided view of `fine`."""
    return _fit(_subsample2(fine), tuple(coarse_shape))


def apply_correction(v: Tensor, error: Tensor, m_int: Tensor) -> Tensor:
    """v + e on the interior only."""
    return v + m_int * error


def set_interior(v: Tensor, value: float, m_int: Tensor) -> Tensor:
    """Fill the interior with `value`, keep the boundary."""
    return v + m_int * (value - v)
