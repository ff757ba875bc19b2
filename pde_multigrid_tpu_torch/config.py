"""Configuration dataclasses, copied field for field from
`pde_multigrid_tpu.config` so that one set of values drives both packages.

The port covers the JAX package's cycles: the correction scheme and the
full approximation scheme (FAS, for nonlinear problems) with V-, W- (mu
> 1) cycles and FMG, rediscretized and Galerkin (RAP) coarse operators,
the red-black Gauss-Seidel, damped Jacobi, zebra line ("line-K") and
exact (direct 1D scan) smoothers, float32 and float64 storage and the
bf16 defect-correction smoother (`precision="mixed"`).  Where a tier
cannot serve an option (a mesh with another smoother than rbgs, say), the
tier raises at construction, naming the ROADMAP item that brings it;
nothing is silently ignored.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

CycleKind = Literal["v", "w", "fmg"]


@dataclasses.dataclass(frozen=True)
class CycleConfig:
    """Multigrid schedule parameters.

    nu0: V-cycles per FMG level; nu1/nu2: pre-/post-smoothing sweeps;
    mu: recursion count at each level (1 = V-cycle, 2 = W-cycle).
    `smoother` is "rbgs", "jacobi" (damped by `omega`), "line-K" (zebra
    line relaxation along axis K, for problems with a `line_system`) or
    "exact" (problems with an `exact_solve`).  `coarsest` is
    "relax" (nu1+nu2 sweeps on the coarsest level) or "exact" (the
    fast-diagonalization direct solve, ops/fastdiag.py).
    """

    kind: CycleKind = "fmg"
    nu0: int = 2
    nu1: int = 2
    nu2: int = 2
    mu: int = 1
    smoother: str = "rbgs"
    omega: float = 1.0
    coarse_operator: str = "rediscretize"
    scheme: str = "cs"
    coarsest: str = "relax"

    def __post_init__(self):
        if self.kind not in ("v", "w", "fmg"):
            raise ValueError(f"unknown cycle kind {self.kind!r}")
        if min(self.nu0, self.nu1, self.nu2, self.mu) < 0:
            raise ValueError("cycle counts must be non-negative")
        ok = self.smoother in ("rbgs", "jacobi", "exact") or (
            self.smoother.startswith("line-")
            and self.smoother[5:].isdigit()
        )
        if not ok:
            raise ValueError(f"unknown smoother {self.smoother!r}")
        if self.coarse_operator not in ("rediscretize", "galerkin"):
            raise ValueError(
                f"unknown coarse_operator {self.coarse_operator!r}"
            )
        if self.scheme not in ("cs", "fas"):
            raise ValueError(f"unknown scheme {self.scheme!r}")
        if self.coarsest not in ("relax", "exact"):
            raise ValueError(f"unknown coarsest {self.coarsest!r}")
        if self.coarsest == "exact" and self.scheme == "fas":
            raise ValueError(
                "coarsest='exact' is a linear direct solve; FAS needs "
                "the nonlinear relax recursion"
            )
        if self.coarsest == "exact" and self.coarse_operator == "galerkin":
            raise ValueError(
                "coarsest='exact' diagonalizes the rediscretized "
                "separable operator, not a Galerkin coarse operator"
            )
        if self.scheme == "fas" and self.coarse_operator == "galerkin":
            raise ValueError(
                "FAS re-evaluates the nonlinear operator per level; "
                "galerkin coarse operators are a linear-only concept"
            )


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    cycle: CycleConfig = CycleConfig()
    dtype: str = "float32"
    # kept for field parity with the JAX config; the port selects its
    # kernels from the solver's `device`, so only "auto" is accepted
    backend: Literal["auto"] = "auto"
    precision: Literal["f32", "mixed"] = "f32"
    num_levels: int | None = None  # None = down to 3 points/axis
    storage: Literal["auto", "padded", "wrap"] = "auto"
    # physical padding multiples; 1 (no padding) on every device — the
    # TPU lane/sublane defaults of the JAX package do not apply
    pad_axis0_to: int = 1
    pad_last_to: int = 1
    pad_sublane_to: int = 1
    tol: float = 1e-8
    max_cycles: int = 100
    divergence_factor: float = 1e3
    sweeps_per_exchange: int = 4

    def __post_init__(self):
        if self.dtype not in ("float32", "float64"):
            raise ValueError(f"unsupported dtype {self.dtype!r}")
        if self.precision not in ("f32", "mixed"):
            raise ValueError(f"unknown precision {self.precision!r}")
        if self.backend != "auto":
            raise ValueError(
                f"backend={self.backend!r}: the port picks its kernels "
                "from the solver's device= argument; leave backend 'auto'"
            )
