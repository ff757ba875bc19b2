"""2D Lyapunov PDE (PyTorch port of `pde_multigrid_tpu.models.lyapunov2d`).

    (dV/dx)(a11 x + a12 y) + (dV/dy)(a21 x + a22 y) = -alpha V

from Vdot = grad(V) . f(x) = -alpha V for the linear system xdot = A x.
With the reference's A = [[-1, -2], [0, -3]] (Hurwitz) and alpha = 2 the
exact solution is the quadratic form V = 2x^2 - 4xy + 2y^2; RHS f = 0 on
the finest grid, Dirichlet boundary = exact V.

Forward differences on both axes — a 3-point one-sided stencil (center,
E = +x neighbor, S = +y neighbor).  With K1 = a11 x + a12 y and
K2 = a21 x + a22 y:

    operator:  L v = K1 (E - C)/h_x + K2 (S - C)/h_y + alpha C
    relax:     C = (h_y K1 E + h_x K2 S - f h_x h_y)
                   / (K1 h_y + K2 h_x - alpha h_x h_y)

The kernel-side forms (`kernel_precompute`, `kernel_update`,
`split_update2d`) keep the JAX float32 rounding: `a` is cast to the
working dtype before use and Python-float constants such as
alpha * h_x * h_y round once from double where they meet the tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from pde_multigrid_tpu_torch.grid import LevelGeometry
from pde_multigrid_tpu_torch.models.base import ProblemBase


class Lyapunov2D(ProblemBase):
    ndim = 2
    name = "lyapunov2d"
    # f = 0 on the finest grid and on every FMG-cascaded level: relax legs
    # on the cascaded RHS may drop the f stream
    rhs_is_zero = True
    # the one-sided stencil reads only the +x neighbor
    split2d_x_offsets = (+1,)
    # one-sided => the red-black system is bipartite-reducible: the fields
    # of kernel_precompute that the reduced-system kernel reads
    # (ops/cuda/reduced2d.py; opt-in, ops/cuda/dispatch.SPLIT2D_REDUCED)
    reduced2d_fields = ("a_e", "a_s", "a_f")
    # split_update2d / kernel_update take f=None (RHS term dropped)
    split_update2d_f_optional = True
    kernel_update_f_optional = True

    def __init__(
        self,
        a_matrix=((-1.0, -2.0), (0.0, -3.0)),
        alpha: float = 2.0,
        p_matrix=((2.0, -2.0), (-2.0, 2.0)),
        domain: tuple[tuple[float, float], ...] = ((0.0, 1.0), (0.0, 1.0)),
    ):
        """`a_matrix` is the system matrix A (Hurwitz), `p_matrix` the
        solution matrix P with V = [x y] P [x y]^T."""
        self.a = np.asarray(a_matrix, dtype=np.float64)
        self.alpha = float(alpha)
        self.p = np.asarray(p_matrix, dtype=np.float64)
        self.domain = tuple(tuple(d) for d in domain)

    def exact_solution(self, coords) -> torch.Tensor:
        x, y = coords
        p = self.p
        return (float(p[0, 0]) * x * x
                + float(p[0, 1] + p[1, 0]) * x * y
                + float(p[1, 1]) * y * y)

    def rhs(self, coords) -> torch.Tensor:
        x, _ = coords
        return torch.zeros_like(x)

    def _k(self, x, y, a):
        """(K1, K2) from coordinates and the matrix entries `a`."""
        return (float(a[0, 0]) * x + float(a[0, 1]) * y,
                float(a[1, 0]) * x + float(a[1, 1]) * y)

    def make_aux(self, geom: LevelGeometry, dtype, device):
        x, y = geom.coords(dtype, device)
        k1, k2 = self._k(x, y, self.a)
        return {"k1": k1.to(dtype), "k2": k2.to(dtype)}

    def _h(self, geom: LevelGeometry, like: torch.Tensor):
        return (torch.tensor(geom.spacing[0], dtype=like.dtype),
                torch.tensor(geom.spacing[1], dtype=like.dtype))

    def relax_update(self, v, f, geom: LevelGeometry, aux) -> torch.Tensor:
        hx, hy = self._h(geom, v)
        k1, k2 = aux["k1"], aux["k2"]
        east = self.shift(v, 0, +1)  # +x neighbor
        south = self.shift(v, 1, +1)  # +y neighbor
        den = k1 * hy + k2 * hx - self.alpha * hx * hy
        return (hy * k1 * east + hx * k2 * south - f * hx * hy) / den

    def apply_operator(self, v, geom: LevelGeometry, aux) -> torch.Tensor:
        hx, hy = self._h(geom, v)
        k1, k2 = aux["k1"], aux["k2"]
        east = self.shift(v, 0, +1)
        south = self.shift(v, 1, +1)
        return k1 * (east - v) / hx + k2 * (south - v) / hy + self.alpha * v

    def stencil_operator(self, geom: LevelGeometry, aux, dtype=torch.float32):
        """The one-sided 3-point stencil with spatially varying
        coefficients (center, E = +x, S = +y) as a StencilOperator."""
        from pde_multigrid_tpu_torch.ops.galerkin import StencilOperator

        hx, hy = geom.spacing
        k1, k2 = aux["k1"], aux["k2"]
        center = -k1 / hx - k2 / hy + self.alpha
        coeffs = torch.stack([center, k1 / hx, k2 / hy], dim=-1).to(dtype)
        return StencilOperator(offsets=((0, 0), (1, 0), (0, 1)),
                               coeffs=coeffs)

    # -- kernel-side forms (ops/cuda) ---------------------------------------

    def kernel_precompute(self, coords, geom: LevelGeometry, dtype):
        """Per-point (east, south, rhs) coefficients of the local solve,
        as reciprocal products (the TPU kernels' hoisted division).  The
        CUDA kernels compute the same values in the same order from the
        point's own coordinates."""
        x, y = coords
        hx, hy = geom.spacing
        a = self.a.astype(np.dtype(str(dtype).removeprefix("torch.")))
        k1, k2 = self._k(x, y, a)
        k1, k2 = k1.to(dtype), k2.to(dtype)
        inv_den = (
            1.0 / (k1 * hy + k2 * hx - self.alpha * hx * hy)
        ).to(dtype)
        return {
            "a_e": (hy * k1) * inv_den,
            "a_s": (hx * k2) * inv_den,
            "a_f": (-hx * hy) * inv_den,
        }

    def kernel_update(self, v, f, pre, geom: LevelGeometry):
        east = self.shift(v, 0, +1)
        south = self.shift(v, 1, +1)
        upd = east * pre["a_e"] + south * pre["a_s"]
        return upd if f is None else upd + f * pre["a_f"]

    def split_update2d(self, nbr, f, pre, geom: LevelGeometry):
        """Local solve on 2D color-split storage: `nbr(axis, off)` gathers
        the opposite color's neighbor, `pre` holds this color's
        coefficient fields.  Same math and term order as kernel_update;
        `f is None` drops the RHS term."""
        upd = nbr(0, +1) * pre["a_e"] + nbr(1, +1) * pre["a_s"]
        return upd if f is None else upd + f * pre["a_f"]

    def split_operator2d(self, C, nbr, coords, geom: LevelGeometry):
        """L v at one color's points in half layout (ops/split2d.py): same
        math and term order as apply_operator, with `nbr` gathering the
        opposite color's E/S neighbors and `coords` this color's (x, y)."""
        x, y = coords
        hx, hy = self._h(geom, C)
        k1, k2 = self._k(x, y, self.a)
        k1, k2 = k1.to(C.dtype), k2.to(C.dtype)
        east = nbr(0, +1)
        south = nbr(1, +1)
        return k1 * (east - C) / hx + k2 * (south - C) / hy + self.alpha * C
