"""High-level solver API (PyTorch port of `pde_multigrid_tpu.solver`).

    problem = Poisson3D()
    solver = MultigridSolver(problem, shape=129,
                             config=SolverConfig(cycle=CycleConfig("fmg", 2, 2, 2)),
                             device="cuda")
    result = solver.solve()
    result.error_linf, result.residual_l2, result.v

The solver runs on the card ("cuda", the default) unless the caller asks
for "cpu"; without CUDA a "cuda" solver raises, it never carries on on the
CPU.  The kernel tier follows the smoother and the dtype, as the JAX
package's `_pick_kernels` does (`_pick_kernels` below): red-black
Gauss-Seidel in float32 on "cuda" runs the hand-written CUDA kernels
(`ops.cuda.dispatch.CudaKernels`); zebra line relaxation ("line-K") in
float32 on "cuda" runs the line kernel (`ops.cuda.zebra_line.LineKernels`:
JAX's jnp tier, whose batched Thomas scan is the one op given a kernel);
the "jacobi" and "exact" smoothers and float64 run the plain tensor tier
(`cycles.TorchKernels`) on the solver's device, as JAX runs `JnpKernels`
for them (its Pallas tier implements float32 RBGS only), so no kernel is
asked for and skipped; on "cpu" the plain tier runs everything.  There is no fallback between the tiers: the
choice is made once, at construction.  `SolverConfig.precision="mixed"`
selects the bf16 defect-correction relax on "cuda" where a defect plan
covers the level; the plain tier ignores it and relaxes in the working
dtype, as the JAX package's jnp tier does.

`CycleConfig(coarse_operator="galerkin")` builds the Galerkin (RAP)
operator of every level once, at construction, on the solver's device
(`ops.galerkin.galerkin_hierarchy`); `fresh_levels` puts each level's
coefficients into its aux as `stencil_coeffs`, and the Galerkin tier
(`ops.galerkin.GalerkinKernels`) relaxes with the stencil kernels of
`ops.cuda.stencilop` where the same rule picks the CUDA kernels.

`mesh` (a `parallel.mesh.Mesh`, one rank's view of a `torch.distributed`
group) splits every level that is large enough along axis 0 over the
ranks, as the JAX solver's `mesh=` does: `pad_axis0_to` is multiplied by
the number of ranks, the solver runs on the mesh's device, the kernel
tier is `parallel.sharded.ShardedKernels` (halo-exchange relaxation on
the split levels; 3D wrap-storage Poisson and padded 2D Lyapunov with
red-black Gauss-Seidel, anything else raises), `fresh_levels` returns
this rank's part of each level, and `SolveResult.v` is the whole finest
level on every rank.
"""

from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

from pde_multigrid_tpu_torch.config import SolverConfig
from pde_multigrid_tpu_torch.cycles import CycleProgram, TorchKernels
from pde_multigrid_tpu_torch.grid import (
    Hierarchy,
    coarsen_shape,
    num_levels_for,
)
from pde_multigrid_tpu_torch.ops.fastdiag import DENSE_COARSE_MAX
from pde_multigrid_tpu_torch.ops.galerkin import (
    GalerkinKernels,
    galerkin_hierarchy,
)


@dataclasses.dataclass
class SolveResult:
    v: torch.Tensor  # finest-level solution
    residual_l2: float
    residual_linf: float
    error_l2: float | None  # vs the analytic solution
    error_linf: float | None
    error_mae: float | None  # interior mean absolute error
    cycles_run: int
    residual_history: list[float]
    wall_time_s: float
    # eager PyTorch compiles nothing per solve: this is the one-time
    # build/load of the CUDA kernels library and the kernel plan (0.0 on
    # the CPU)
    compile_time_s: float
    diverged: bool = False


def _has_zero_boundary(problem, shape, dtype) -> bool:
    """True iff the problem's Dirichlet data vanishes on every face of the
    finest grid; evaluated on host face slices (numpy coordinates)."""
    if isinstance(shape, int):
        shape = (shape,) * problem.ndim
    npdt = np.dtype(dtype)
    axes = []
    for a in range(problem.ndim):
        lo, hi = problem.domain[a]
        h = (hi - lo) / (shape[a] - 1)
        axes.append(
            npdt.type(lo) + np.arange(shape[a], dtype=npdt) * npdt.type(h)
        )
    for ax in range(problem.ndim):
        for side in (0, shape[ax] - 1):
            face_axes = list(axes)
            face_axes[ax] = axes[ax][side : side + 1]
            coords = np.meshgrid(*face_axes, indexing="ij")
            bv = problem.boundary_values(
                tuple(torch.from_numpy(c) for c in coords)
            )
            if np.max(np.abs(bv.numpy())) > 1e-7:
                return False
    return True


def _exact_num_levels(problem, shape, wrap: bool) -> int:
    """Hierarchy depth for coarsest='exact': truncate at the shallowest
    level the direct solve handles (separable fast diagonalization up to
    65 points per axis, or an interior of at most DENSE_COARSE_MAX)."""
    shp = (shape,) * problem.ndim if isinstance(shape, int) else tuple(shape)
    total = num_levels_for(shp)
    cur = shp
    for l in range(total):
        if l:
            cur = coarsen_shape(cur)
        n_int = math.prod(max(n - 2, 1) for n in cur)
        sep_ok = (
            wrap and hasattr(problem, "separable_fastdiag") and max(cur) <= 65
        )
        if sep_ok or n_int <= DENSE_COARSE_MAX:
            # keep >= 2 levels so every cycle exercises the multigrid path
            return max(2, l + 1) if total > 1 else 1
    return total


def _pick_kernels(problem, geoms, cycle, dtype, device, precision="f32",
                  galerkin_offsets=None, mesh=None, sweeps_per_exchange=4):
    """The kernel tier, chosen once: with a `mesh` the sharded tier; else
    the CUDA kernels for red-black Gauss-Seidel in float32 on "cuda"
    (`CudaKernels`, or the Galerkin tier with its per-level stencil-kernel
    plans when `galerkin_offsets` is given), the line kernel's tier for
    zebra lines ("line-K") in float32 on "cuda" (`LineKernels`), else the
    plain tensor tier on the solver's device.  On the card the kernels
    library is built (or loaded) here."""
    on_card = (device.type == "cuda" and dtype == torch.float32
               and cycle.smoother == "rbgs")
    n = len(geoms)
    relaxed = range(n - 1) if cycle.coarsest == "exact" else range(n)
    if on_card:
        from pde_multigrid_tpu_torch.ops.cuda import build

        build.load()
    if mesh is not None:
        from pde_multigrid_tpu_torch.parallel.sharded import ShardedKernels

        return ShardedKernels(problem, geoms, mesh, dtype, cycle.smoother,
                              cycle.omega, sweeps_per_exchange, relaxed,
                              cycle.scheme)
    if galerkin_offsets is not None:
        plans = None
        if on_card:
            from pde_multigrid_tpu_torch.ops.cuda import stencilop

            plans = [stencilop.plan_stencil_relax(o, g)
                     for o, g in zip(galerkin_offsets, geoms)]
        return GalerkinKernels(problem, geoms, galerkin_offsets,
                               cycle.smoother, cycle.omega, plans)
    if on_card:
        from pde_multigrid_tpu_torch.ops.cuda.dispatch import CudaKernels

        return CudaKernels(problem, geoms, dtype, relaxed,
                           mixed=precision == "mixed", cycle=cycle)
    if (device.type == "cuda" and dtype == torch.float32
            and cycle.smoother.startswith("line-")):
        from pde_multigrid_tpu_torch.ops.cuda import build
        from pde_multigrid_tpu_torch.ops.cuda.zebra_line import LineKernels

        build.load()
        return LineKernels(problem, geoms, cycle.smoother, relaxed, device)
    # the plain tier ignores precision, as the JAX jnp tier does (the JAX
    # solver passes it to the Pallas tier only)
    return TorchKernels(problem, geoms, cycle.smoother, cycle.omega)


class MultigridSolver:
    """Multigrid solver on an explicit torch device, or split over the
    ranks of a `mesh`."""

    def __init__(
        self,
        problem,
        shape: int | tuple[int, ...],
        config: SolverConfig | None = None,
        device="cuda",
        mesh=None,
    ):
        self.config = config or SolverConfig()
        self.mesh = mesh
        if mesh is not None:
            if self.config.cycle.coarse_operator == "galerkin":
                # as the JAX solver (solver.py:215-221): the sharded tier has
                # no stencil-coefficient relax path
                raise ValueError(
                    "coarse_operator='galerkin' is not supported on a "
                    "device mesh yet; drop mesh= or use rediscretize"
                )
            if torch.device(device).type != mesh.device.type:
                raise ValueError(f"device {device!r} but the mesh's ranks "
                                 f"run on {mesh.device}")
            device = mesh.device
            if self.config.pad_axis0_to % mesh.n:
                self.config = dataclasses.replace(
                    self.config,
                    pad_axis0_to=self.config.pad_axis0_to * mesh.n,
                )
        self.device = torch.device(device)
        if self.device.type not in ("cpu", "cuda"):
            raise ValueError(f"unsupported device {self.device}")
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device='cuda' requested but CUDA is unavailable")
        self.dtype = getattr(torch, self.config.dtype)
        wrap = False
        if self.config.storage in ("auto", "wrap"):
            wrap = _has_zero_boundary(problem, shape, self.config.dtype)
            if self.config.storage == "wrap" and not wrap:
                raise ValueError(
                    "storage='wrap' requires homogeneous Dirichlet data"
                )
        cyc = self.config.cycle
        num_levels = self.config.num_levels
        if num_levels is None and cyc.coarsest == "exact":
            num_levels = _exact_num_levels(problem, shape, wrap)
        self.hierarchy = Hierarchy.build(
            problem,
            shape,
            num_levels=num_levels,
            dtype=self.dtype,
            pad_axis0_to=self.config.pad_axis0_to,
            pad_last_to=self.config.pad_last_to,
            pad_sublane_to=self.config.pad_sublane_to,
            wrap=wrap,
            device=self.device,
        )
        self.problem = problem
        self.geoms = self.hierarchy.geoms
        self._galerkin_coeffs = None
        offsets = None
        if cyc.coarse_operator == "galerkin":
            if not hasattr(problem, "stencil_operator"):
                raise ValueError(
                    f"problem {problem.name} has no stencil_operator; "
                    "galerkin coarsening unavailable"
                )
            lv = self.hierarchy.levels
            ops = galerkin_hierarchy(
                problem.stencil_operator(self.geoms[0], lv[0].aux,
                                         self.dtype),
                self.geoms,
                [l.aux for l in lv],
            )
            self._galerkin_coeffs = [op.coeffs for op in ops]
            offsets = [op.offsets for op in ops]
        t0 = time.perf_counter()
        kernels = _pick_kernels(problem, self.geoms, cyc, self.dtype,
                                self.device, self.config.precision, offsets,
                                mesh, self.config.sweeps_per_exchange)
        self.compile_time_s = (time.perf_counter() - t0
                               if self.device.type == "cuda" else 0.0)
        self.program = CycleProgram(
            problem, self.geoms, cyc, kernels, device=self.device
        )

    def fresh_levels(self):
        """Freshly initialized levels (the cycles update levels in place);
        with Galerkin coarse operators each level's aux carries its
        operator's coefficients as `stencil_coeffs` (the tensors built at
        construction, which no cycle writes); with a mesh, this rank's part
        of each level."""
        levels = [
            self.problem.init_level(g, dtype=self.dtype, device=self.device)
            for g in self.geoms
        ]
        if self._galerkin_coeffs is not None:
            for lvl, c in zip(levels, self._galerkin_coeffs):
                lvl.aux = {**lvl.aux, "stencil_coeffs": c}
        if self.mesh is not None:
            from pde_multigrid_tpu_torch.parallel.mesh import shard_levels

            levels = shard_levels(self.mesh, levels, self.geoms)
        return levels

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- main entry points -------------------------------------------------

    def solve(self, levels=None) -> SolveResult:
        """Run the configured schedule once."""
        levels = list(levels) if levels is not None else self.fresh_levels()
        self._sync()
        t0 = time.perf_counter()
        levels = self.program.solve_step(levels)
        self._sync()
        wall = time.perf_counter() - t0
        return self._finalize(levels, 1, [], wall)

    def solve_to_tolerance(self, levels=None, metrics=None) -> SolveResult:
        """The configured step (FMG or V) followed by V-cycles until the
        finest-level L2 residual is below config.tol or max_cycles is
        reached.  Stops early (diverged=True) if the residual goes
        non-finite or exceeds divergence_factor x the best seen.
        `metrics` (an object with `.cycle(n, res, prev, kind=, ...)`)
        gets one record per cycle."""
        cfg = self.config
        levels = list(levels) if levels is not None else self.fresh_levels()
        history: list[float] = []
        diverged = False
        self._sync()
        t0 = time.perf_counter()
        levels = self.program.solve_step(levels)
        l2, _ = self.program.residual_norms(levels)
        history.append(float(l2))
        if metrics:
            metrics.cycle(0, history[-1], None, kind=cfg.cycle.kind)
        if not np.isfinite(history[-1]):
            # NaN compares False against any tolerance
            diverged = True
        best = history[-1]
        n = 1
        while history[-1] > cfg.tol and n < cfg.max_cycles:
            t_c = time.perf_counter()
            levels = self.program.solve_step(levels, kind="v")
            l2, _ = self.program.residual_norms(levels)
            history.append(float(l2))
            if metrics:
                metrics.cycle(
                    n, history[-1], history[-2], kind="v",
                    cycle_s=round(time.perf_counter() - t_c, 6),
                )
            if not np.isfinite(history[-1]) or (
                history[-1] > cfg.divergence_factor * best
            ):
                diverged = True
                break
            best = min(best, history[-1])
            n += 1
        self._sync()
        wall = time.perf_counter() - t0
        res = self._finalize(levels, n, history, wall)
        res.diverged = diverged
        return res

    # -- verification ------------------------------------------------------

    def _finalize(self, levels, cycles: int, history, wall: float):
        l2, linf = self.program.residual_norms(levels)
        fin = levels[0]
        geo = self.geoms[0]
        k = self.program.kernels
        rows = k.owned_rows(0)
        exact = self.problem.exact_solution(
            tuple(c[rows] for c in geo.coords(fin.v.dtype, fin.v.device))
        )
        m_int = fin.aux["m_int"]
        diff = (fin.v - exact) * m_int
        n_int = float(k.level_sum(0, m_int))
        return SolveResult(
            v=k.gather(0, fin.v),
            residual_l2=float(l2),
            residual_linf=float(linf),
            error_l2=float(torch.sqrt(k.level_sum(0, diff * diff) / n_int)),
            error_linf=float(k.level_max(0, torch.abs(diff))),
            error_mae=float(k.level_sum(0, torch.abs(diff)) / n_int),
            cycles_run=cycles,
            residual_history=list(history),
            wall_time_s=wall,
            compile_time_s=self.compile_time_s,
        )
