"""d-dimensional Poisson problem: laplacian(u) = f, Dirichlet boundary
(PyTorch port of `pde_multigrid_tpu.models.poisson`).

The thesis case (3D): f = -3 pi^2 sin(pi x) sin(pi y) sin(pi z) on
(0,1)^3, u = 0 on the boundary, exact u = sin(pi x) sin(pi y) sin(pi z).
The (2d+1)-point Laplacian; the relax step is the local solve

    v = ( sum_ax (v_minus + v_plus) / h_ax^2  -  f ) / ( 2 sum_ax 1/h_ax^2 )
"""

from __future__ import annotations

import math

import numpy as np
import torch

from pde_multigrid_tpu_torch.grid import LevelGeometry
from pde_multigrid_tpu_torch.models.base import ProblemBase


def inv_h2(geom: LevelGeometry) -> list[float]:
    """Per-axis 1/h^2 as Python floats (double precision)."""
    return [1.0 / (h * h) for h in geom.spacing]


def split_constants(geom: LevelGeometry) -> tuple[list[float], float]:
    """(1/h^2 per axis, 1/(2 sum 1/h^2)) in double; the kernels receive
    them rounded to float32, as the JAX code's Python floats round when
    they meet float32 arrays."""
    w = inv_h2(geom)
    return w, 1.0 / (2.0 * sum(w))


def folded_constants(geom: LevelGeometry) -> tuple[bool, list[float], float]:
    """(isotropic spacing, 1/h^2 * inv_den per axis, inv_den) in double:
    the constants of Poisson.split_update_folded."""
    w, inv_den = split_constants(geom)
    return len(set(geom.spacing)) == 1, [x * inv_den for x in w], inv_den


class Poisson(ProblemBase):
    """laplacian(u) = f with the separable product-of-sines solution

        u(x) = prod_ax sin(k_ax pi x_ax),  f(x) = -(sum_ax (k_ax pi)^2) u(x),

    zero on the boundary of any [0, 1]-aligned box."""

    # split_update2d / kernel_update take f=None (the RHS term dropped)
    split_update2d_f_optional = True
    kernel_update_f_optional = True

    def __init__(
        self,
        ndim: int,
        domain: tuple[tuple[float, float], ...] | None = None,
        wavenumbers: tuple[int, ...] | None = None,
    ):
        self.ndim = int(ndim)
        self.name = f"poisson{self.ndim}d"
        self.domain = (
            tuple(tuple(d) for d in domain)
            if domain is not None
            else ((0.0, 1.0),) * self.ndim
        )
        self.k = tuple(wavenumbers) if wavenumbers else (1,) * self.ndim

    def exact_solution(self, coords) -> torch.Tensor:
        u = None
        for k, x in zip(self.k, coords):
            s = torch.sin(k * math.pi * x)
            u = s if u is None else u * s
        return u

    def rhs(self, coords) -> torch.Tensor:
        lam = sum((k * math.pi) ** 2 for k in self.k)
        return -lam * self.exact_solution(coords)

    def relax_update(self, v, f, geom: LevelGeometry, aux) -> torch.Tensor:
        w = [torch.tensor(x, dtype=v.dtype) for x in inv_h2(geom)]
        num = -f
        den = 0.0
        for ax, wa in enumerate(w):
            num = num + (self.shift(v, ax, -1) + self.shift(v, ax, +1)) * wa
            den = den + 2.0 * wa
        # num / den as the JAX package computes it: under jit, XLA turns
        # the division by this constant into a product with its reciprocal
        # (rounded in v's dtype), and the port keeps that rounding
        return num * (1.0 / den).to(v.device)

    def apply_operator(self, v, geom: LevelGeometry, aux) -> torch.Tensor:
        w = [torch.tensor(x, dtype=v.dtype) for x in inv_h2(geom)]
        out = 0.0
        for ax, wa in enumerate(w):
            out = out + (
                self.shift(v, ax, -1) - 2.0 * v + self.shift(v, ax, +1)
            ) * wa
        return out

    def stencil_operator(self, geom: LevelGeometry, aux, dtype=torch.float32):
        """The (2d+1)-point Laplacian as a StencilOperator with constant
        coefficients of shape (1, ..., 1, K), on the device of `aux`."""
        from pde_multigrid_tpu_torch.ops.galerkin import StencilOperator

        w = inv_h2(geom)
        offsets = [(0,) * self.ndim]
        coeffs = [-2.0 * sum(w)]
        for ax, wa in enumerate(w):
            for s in (-1, +1):
                off = [0] * self.ndim
                off[ax] = s
                offsets.append(tuple(off))
                coeffs.append(wa)
        c = torch.tensor(coeffs, dtype=dtype, device=aux["m_int"].device)
        return StencilOperator(
            offsets=tuple(offsets),
            coeffs=c.reshape((1,) * self.ndim + (len(offsets),)),
        )

    # -- line relaxation ----------------------------------------------------

    def line_rows(self, line_axis: int, geom: LevelGeometry):
        """(a_rows, b_rows, c_rows, interior): the tridiagonal couplings of
        a line along `line_axis` as float32 numpy vectors over its padded
        extent, and which rows are interior equations (the others are
        identity rows: a = c = 0, b = 1)."""
        n_log = geom.shape[line_axis]
        w = inv_h2(geom)
        a_l = w[line_axis]
        b_diag = -2.0 * sum(w)
        rows = np.arange(geom.padded_shape[line_axis])
        inter = (rows >= 1) & (rows <= n_log - 2)
        a_rows = np.where(inter, a_l, 0.0).astype(np.float32)
        b_rows = np.where(inter, b_diag, 1.0).astype(np.float32)
        c_rows = np.where(inter, a_l, 0.0).astype(np.float32)
        return a_rows, b_rows, c_rows, inter

    def line_system(self, line_axis: int, geom: LevelGeometry):
        """Tridiagonal system builder for exact line solves along
        `line_axis` (the JAX `Poisson.line_system`): build(v, f) -> (a_rows,
        b_rows, c_rows, d), the couplings as float32 numpy vectors, every
        off-line neighbour term moved into d, in axis order; boundary and
        padding rows are identity equations (d = v there)."""
        a_rows, b_rows, c_rows, inter = self.line_rows(line_axis, geom)
        w = inv_h2(geom)
        bshape = [1] * geom.ndim
        bshape[line_axis] = len(inter)
        m_row = inter.astype(np.float32).reshape(bshape)

        def build(v, f):
            d = f
            for ax, wa in enumerate(w):
                if ax == line_axis:
                    continue
                d = d - (self.shift(v, ax, -1) + self.shift(v, ax, +1)) * wa
            m = torch.from_numpy(m_row).to(dtype=v.dtype, device=v.device)
            d = v + m * (d - v)  # identity rows
            return a_rows, b_rows, c_rows, d

        return build

    def separable_fastdiag(self, geom: LevelGeometry) -> bool:
        """The (2d+1)-point Laplacian is a Kronecker sum of per-axis 1D
        Dirichlet Laplacians: eligible for the fast-diagonalization exact
        coarse solve (ops/fastdiag.py)."""
        return True

    # -- kernel-side forms (ops/cuda) ---------------------------------------

    def kernel_operator(self, v, geom: LevelGeometry, roll):
        """L v with the shifts delegated to `roll(a, axis, off)`: same math
        and accumulation order as apply_operator, with the weights as
        float32-rounded Python floats (the fused kernels' form)."""
        out = 0.0
        for ax, w in enumerate(inv_h2(geom)):
            out = out + (roll(v, ax, -1) - 2.0 * v + roll(v, ax, +1)) * w
        return out

    def kernel_precompute(self, coords, geom: LevelGeometry, dtype):
        """Constant coefficients: no per-point fields."""
        return {}

    def kernel_update(self, v, f, pre, geom: LevelGeometry):
        """The local solve in the Pallas kernels' form (the JAX
        `Poisson.kernel_update`): num = -f, num + (v_minus + v_plus)*w per
        axis, then * inv_den, with the constants folded once in double
        (`split_constants`) and rounded to v's dtype where they meet it.
        The spatial axes are the last geom.ndim axes of v; `f is None`
        drops the RHS term."""
        w, inv_den = split_constants(geom)
        off = v.ndim - geom.ndim
        num = None if f is None else -f
        for ax, wa in enumerate(w):
            pair = (
                self.shift(v, off + ax, -1) + self.shift(v, off + ax, +1)
            ) * wa
            num = pair if num is None else num + pair
        return num * inv_den

    def merged_update(self, v, f, shift, geom: LevelGeometry):
        """The local solve of the whole-leg 3D resident kernel (the JAX
        `Poisson.merged_update`, whose merged-layout kernel passes its
        layout-aware `shift(a, axis, off)`): kernel_update's arithmetic and
        operand order, with the shifts delegated to `shift`."""
        w, inv_den = split_constants(geom)
        num = -f
        for ax, wa in enumerate(w):
            num = num + (shift(v, ax, -1) + shift(v, ax, +1)) * wa
        return num * inv_den

    def split_update(self, pairs, f, geom: LevelGeometry):
        """Local solve on color-split storage: `pairs[ax]` is the
        (v_minus + v_plus) neighbor pair sum along axis `ax`, gathered
        from the opposite color."""
        w, inv_den = split_constants(geom)
        num = -f
        for ax, wa in enumerate(w):
            num = num + pairs[ax] * wa
        return num * inv_den

    def split_update2d(self, nbr, f, pre, geom: LevelGeometry):
        """2D colour-split local solve (the JAX `Poisson.split_update2d`):
        `nbr(axis, off)` gathers the opposite colour's neighbour; num =
        -f, then num + (nbr(ax, -1) + nbr(ax, +1)) * w per axis, then *
        inv_den, the constants folded once in double.  `f is None` drops
        the RHS term.  Poisson has no `split2d_x_offsets`: the split tier
        reads both x neighbours."""
        w, inv_den = split_constants(geom)
        num = None if f is None else -f
        for ax, wa in enumerate(w):
            pair = (nbr(ax, -1) + nbr(ax, +1)) * wa
            num = pair if num is None else num + pair
        return num * inv_den

    def split_operator2d(self, C, nbr, coords, geom: LevelGeometry):
        """L v at one colour's points in half layout (ops/split2d.py's
        persistent-split residual): apply_operator's math and term order,
        the weights rounded to C's dtype first, as JAX's
        `Poisson.split_operator2d` rounds them; `coords` is unused."""
        w = [torch.tensor(x, dtype=C.dtype) for x in inv_h2(geom)]
        out = 0.0
        for ax, wa in enumerate(w):
            out = out + (nbr(ax, -1) - 2.0 * C + nbr(ax, +1)) * wa
        return out

    def split_update_folded(self, pairs, f, geom: LevelGeometry):
        """split_update with the constants folded (the bf16 error-equation
        smoother's form, ops/cuda/relax.py): isotropic spacing gives
        (px + py + pz)*(inv_h2*inv_den) - f*inv_den; anisotropic keeps
        per-axis weights with the reciprocal folded into each.  Same fixed
        point as split_update, other rounding.  Constants are folded in
        double and round to float32 where they meet the tensors."""
        iso, a, inv_den = folded_constants(geom)
        if iso:
            s = pairs[0]
            for p in pairs[1:]:
                s = s + p
            return s * a[0] - f * inv_den
        out = -f * inv_den
        for p, wa in zip(pairs, a):
            out = out + p * wa
        return out


def Poisson3D(domain=((0.0, 1.0),) * 3) -> Poisson:
    """The thesis 3D Poisson parity case."""
    return Poisson(ndim=3, domain=domain)
