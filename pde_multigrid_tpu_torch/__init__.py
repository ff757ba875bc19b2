"""pde_multigrid_tpu_torch — the PyTorch/CUDA port of pde_multigrid_tpu.

Full MultiGrid V- and W-cycles with red-black Gauss-Seidel (or damped
Jacobi, or zebra line) relaxation, full-weighting restriction and
(bi/tri)linear prolongation for the 1D
ODE, the Poisson family, the 2D Lyapunov equation, the minimum-time
HJB equation (nonlinear multigrid, FAS) and variable-coefficient
diffusion (Galerkin coarse operators), on a torch device:
hand-written CUDA kernels for Hopper (sm_90a) on "cuda" (the default),
plain PyTorch tensor ops on "cpu".  The JAX package beside it is
the reference this port is tested against; this package never imports
JAX.
"""

from pde_multigrid_tpu_torch.config import CycleConfig, SolverConfig
from pde_multigrid_tpu_torch.grid import Hierarchy, Level, LevelGeometry
from pde_multigrid_tpu_torch.models import (
    HJBMinTime,
    Lyapunov2D,
    Ode1D,
    Poisson,
    Poisson3D,
    VariableCoefficientPoisson,
)
from pde_multigrid_tpu_torch.ops.galerkin import (
    StencilOperator,
    galerkin_hierarchy,
)
from pde_multigrid_tpu_torch.solver import MultigridSolver, SolveResult

__version__ = "0.1.0"

__all__ = [
    "Level",
    "LevelGeometry",
    "Hierarchy",
    "CycleConfig",
    "SolverConfig",
    "MultigridSolver",
    "SolveResult",
    "Poisson",
    "Poisson3D",
    "Lyapunov2D",
    "Ode1D",
    "HJBMinTime",
    "VariableCoefficientPoisson",
    "StencilOperator",
    "galerkin_hierarchy",
]
