"""Cycle schedulers: V-cycle, W/mu-cycle and Full MultiGrid in the
correction scheme and the full approximation scheme (PyTorch port of
`pde_multigrid_tpu.cycles`).

Execution order matches the JAX package, which matches the reference:

  VCycle(l):   relax nu1; if not coarsest: r = f - L v; coarse.f = R r;
               coarse.v = 0 (whole array); VCycle(l+1) [x mu];
               e = P coarse.v; v += e (interior); relax nu2.
  FAS(l):      relax nu1; if not coarsest: r = f - N v; v0c = inject v;
               coarse.f = R r + N_c(v0c) (interior); coarse.v = v0c;
               FAS(l+1) [x mu]; v += P (coarse.v - v0c) (interior);
               relax nu2.
  FMG(l):      restrict f down to the coarsest; coarsest v interior = 0;
               then per level, coarsest->finest: nu0 VCycles, and prolong
               the solution (interior) up one level before the next.

mu > 1 gives W-cycles; kind="w" runs `v_cycle`, as in JAX.  PyTorch
runs eagerly: each op launches as the cycle reaches it.  The
level list is updated in place — a level's `v`/`f` tensors are replaced
or overwritten as the schedule goes — and the same list is returned.
"""

from __future__ import annotations

from typing import Any, Sequence

import torch

from pde_multigrid_tpu_torch.config import CycleConfig
from pde_multigrid_tpu_torch.grid import Level, LevelGeometry, base_aux
from pde_multigrid_tpu_torch.ops import stencil

Levels = list[Level]


class TorchKernels:
    """Plain tensor tier: the problem's pointwise math and the generic
    transfer ops of `ops.stencil`.  The counterpart of the JAX package's
    `JnpKernels`; on the CPU it is the whole solver, and it is what the
    CUDA tier (`ops.cuda.dispatch.CudaKernels`) is held against.

    `smoother` selects the relaxation as `JnpKernels.relax` does:
    "rbgs" (red-black Gauss-Seidel), "jacobi" (damped by `omega`),
    "line-K" (zebra line relaxation along axis K, by the problem's
    `line_system`: a level's `ZebraLines` made at its first relax) or "exact"
    (the problem's direct `exact_solve`)."""

    def __init__(self, problem, geoms: Sequence[LevelGeometry],
                 smoother: str = "rbgs", omega: float = 1.0):
        if smoother == "exact" and not hasattr(problem, "exact_solve"):
            raise ValueError(f"problem {problem.name} has no exact_solve")
        if smoother.startswith("line-") and not hasattr(problem,
                                                        "line_system"):
            raise ValueError(
                f"problem {problem.name} has no line_system; line "
                "relaxation unavailable"
            )
        self.problem = problem
        self.geoms = tuple(geoms)
        self.smoother = smoother
        self.omega = omega
        self._lines: dict[tuple, ZebraLines] = {}

    def relax(self, l: int, v, f, aux, nsweeps: int, f_zero: bool = False):
        # f_zero: statically-known-zero RHS hint; the plain tier ignores it
        g = self.geoms[l]
        if self.smoother == "exact":
            return self.problem.exact_solve(v, f, g, aux)
        if self.smoother.startswith("line-"):
            key = (l, v.dtype, v.device)
            if key not in self._lines:
                self._lines[key] = ZebraLines(
                    self.problem, g, int(self.smoother[5:]), v.dtype,
                    v.device)
            return self._lines[key].relax(v, f, nsweeps)
        upd = lambda v_, f_: self.problem.relax_update(v_, f_, g, aux)  # noqa: E731
        if self.smoother == "jacobi":
            return stencil.relax_jacobi(
                upd, v, f, aux["m_int"], self.omega, nsweeps
            )
        return stencil.relax_rbgs(
            upd, v, f, aux["m_red"], aux["m_black"], nsweeps
        )

    def residual(self, l: int, v, f, aux):
        g = self.geoms[l]
        return stencil.residual(
            lambda v_: self.problem.apply_operator(v_, g, aux),
            v,
            f,
            aux["m_int"],
        )

    def restrict(self, l_fine: int, arr, m_int_coarse, m_log_coarse):
        return stencil.restrict_full_weighting(
            arr, m_int_coarse, m_log_coarse
        )

    def prolong(self, l_fine: int, arr):
        g = self.geoms[l_fine]
        return stencil.prolong_linear(arr, g.padded_shape, periodic=g.wrap)

    # -- optional fused paths (overridden by the CUDA tier; None means
    # "no fused kernel, use the two-step form") -----------------------------

    def residual_restrict(self, l, v, f, aux, coarse_aux, f_zero=False):
        return None

    def restrict_direct(self, l, arr, coarse_aux):
        return None

    def residual_zero_f(self, l, v, aux):
        # residual(v, 0) without a zero f (FAS's coarse right side)
        return None

    def prolong_blend(self, l_fine, base_v, coarse_v, m_int, mode):
        return None

    # -- level-state hooks: a tier that keeps a level's v or f in another
    # layout (the CUDA tier's persistent 2D halves) is told where the cycle
    # reads or writes the dense tensors itself ------------------------------

    def reset_state(self):
        """A solve step starts on levels whose dense v and f are current:
        no other layout of any level is."""

    def dense_v(self, l: int, v):
        """`v` (level l's dense iterate) made current and returned (the
        end of a solve step)."""
        return v

    def v_written(self, l: int):
        """The cycle wrote level l's dense v."""

    def f_written(self, l: int):
        """The cycle wrote level l's f."""

    def zero_v(self, l: int, v):
        """Level l's v set to zero everywhere (in place)."""
        return v.zero_()

    # -- a tier that splits levels over ranks (parallel/sharded.py) holds
    # only its own planes of them: it reduces and gathers across ranks ----

    def coarse_solve(self, l: int, solve, v, f, aux):
        """The exact coarsest solve `solve(v, f, aux)` of level l."""
        return solve(v, f, aux)

    def level_sum(self, l: int, t):
        """The sum of level l's field `t` over the whole level."""
        return torch.sum(t)

    def level_max(self, l: int, t):
        """The max of level l's field `t` over the whole level."""
        return torch.max(t)

    def owned_rows(self, l: int):
        """The axis-0 rows of level l that this process holds."""
        return slice(None)

    def gather(self, l: int, arr):
        """Level l's field `arr`, whole."""
        return arr

    def inject(self, l: int, v, coarse_shape):
        """Level l's iterate injected into level l + 1's points (FAS):
        `stencil.inject`, a strided view of `v` where no fitting is
        needed."""
        return stencil.inject(v, coarse_shape)


class CycleProgram:
    """The configured cycles as functions over a level list."""

    def __init__(
        self,
        problem,
        geoms: Sequence[LevelGeometry],
        config: CycleConfig,
        kernels: Any | None = None,
        device="cpu",
    ):
        self.problem = problem
        self.geoms = tuple(geoms)
        self.config = config
        self.kernels = kernels or TorchKernels(
            problem, geoms, config.smoother, config.omega
        )
        self._rhs_zero = bool(getattr(problem, "rhs_is_zero", False))
        self._coarse_solvers: list[Any] = [None] * len(self.geoms)
        if config.coarsest == "exact":
            from pde_multigrid_tpu_torch.ops import fastdiag

            self._coarse_solvers[-1] = fastdiag.make_coarse_solve(
                problem, self.geoms[-1], device=device
            )

    # -- building blocks ---------------------------------------------------

    def _fused(self, name: str, *args):
        """Optional fused-kernel hook on the kernel tier; None selects the
        two-step form."""
        fn = getattr(self.kernels, name, None)
        return None if fn is None else fn(*args)

    def _relax(self, levels: Levels, l: int, nsweeps: int, f_zero=False):
        if nsweeps == 0:
            return levels
        lvl = levels[l]
        lvl.v = self.kernels.relax(
            l, lvl.v, lvl.f, lvl.aux, nsweeps, f_zero=f_zero
        )
        return levels

    def v_cycle(
        self, levels: Levels, l: int = 0, f_is_rhs: bool = True
    ) -> Levels:
        # f_is_rhs: levels[l].f is the (possibly FMG-cascaded) problem RHS,
        # not a restricted residual — with rhs_is_zero problems the relax
        # legs at this level may drop the f stream
        if self.config.scheme == "fas":
            return self.fas_v_cycle(levels, l)
        cfg = self.config
        if cfg.coarsest == "exact" and l == len(self.geoms) - 1:
            lvl = levels[l]
            v = self._fused("fused_vcycle", l, lvl.v, lvl.f)
            if v is None:
                lvl.v = self.kernels.coarse_solve(
                    l, self._coarse_solvers[l], lvl.v, lvl.f, lvl.aux)
            else:
                lvl.v = v
                self.kernels.v_written(l)
            return levels
        # whole-subtree fused kernels (ops/cuda/subtree.py): the levels
        # below a fused root are V-cycle temporaries in the correction
        # scheme, so their stored v and f go stale; every later consumer
        # re-initializes them (zero_v, restriction) before reading them
        full = self._fused("fused_vcycle", l, levels[l].v, levels[l].f)
        if full is not None:
            levels[l].v = full
            self.kernels.v_written(l)
            return levels
        fz = f_is_rhs and self._rhs_zero
        levels = self._relax(levels, l, cfg.nu1, f_zero=fz)
        if l != len(self.geoms) - 1:
            fine, coarse = levels[l], levels[l + 1]
            vc = self._fused("fused_correction", l, fine.v, fine.f)
            if vc is not None:
                fine.v = vc
                self.kernels.v_written(l)
                return self._relax(levels, l, cfg.nu2, f_zero=fz)
            cf = self._fused(
                "residual_restrict", l, fine.v, fine.f, fine.aux,
                coarse.aux, fz,
            )
            if cf is None:
                r = self.kernels.residual(l, fine.v, fine.f, fine.aux)
                cf = self.kernels.restrict(
                    l, r, coarse.aux["m_int"], coarse.aux["m_log"]
                )
            coarse.f = cf
            self.kernels.f_written(l + 1)
            # zero the whole coarse error vector, boundary included
            # (in place: the old coarse v is dead)
            coarse.v = self.kernels.zero_v(l + 1, coarse.v)
            for _ in range(cfg.mu):
                levels = self.v_cycle(levels, l + 1, f_is_rhs=False)
            v = self._fused(
                "prolong_blend", l, fine.v, coarse.v, fine.aux["m_int"],
                "add",
            )
            if v is None:
                err = self.kernels.prolong(l, coarse.v)
                v = stencil.apply_correction(fine.v, err, fine.aux["m_int"])
            fine.v = v
        return self._relax(levels, l, cfg.nu2, f_zero=fz)

    def fas_v_cycle(self, levels: Levels, l: int = 0) -> Levels:
        """Full Approximation Scheme V-cycle (nonlinear multigrid): the
        coarse level solves N_c(v_c) = N_c(v0c) + R (f - N(v)) from
        v0c = inject(v), and the fine level takes the coarse change,
        v += P (v_c - v0c).  Reduces to the correction scheme for linear
        operators.  The coarse v and f are written here, so the tier's
        level-state hooks hear of it, as in `v_cycle`."""
        cfg = self.config
        levels = self._relax(levels, l, cfg.nu1)
        if l != len(self.geoms) - 1:
            fine, coarse = levels[l], levels[l + 1]
            fine.v = self.kernels.dense_v(l, fine.v)
            r = self.kernels.residual(l, fine.v, fine.f, fine.aux)
            rc = self.kernels.restrict(
                l, r, coarse.aux["m_int"], coarse.aux["m_log"]
            )
            # v0c may be a strided view of fine.v, which keeps the
            # injected values through the coarse visit; its contiguous copy
            # (what the tier's kernels take) becomes the coarse iterate,
            # which relaxation updates in place.  A sharded tier injects
            # the whole fine level into a replicated coarse one
            v0c = self.kernels.inject(l, fine.v, coarse.v.shape)
            vc = v0c.clone(memory_format=torch.contiguous_format)
            # f_c = N_c(v0c) + R r on the interior: m_int * N_c(v) is
            # exactly -residual(v, 0)
            r0 = self._fused("residual_zero_f", l + 1, vc, coarse.aux)
            if r0 is None:
                r0 = self.kernels.residual(
                    l + 1, vc, torch.zeros_like(vc), coarse.aux
                )
            fc = rc - r0
            coarse.v = vc
            self.kernels.v_written(l + 1)
            coarse.f = fc
            self.kernels.f_written(l + 1)
            for _ in range(cfg.mu):
                levels = self.fas_v_cycle(levels, l + 1)
            # the coarse change, dense and current (so the hook's own
            # dense_v of the coarse level has nothing left to merge)
            coarse.v = self.kernels.dense_v(l + 1, coarse.v)
            dv = coarse.v - v0c
            v = self._fused(
                "prolong_blend", l, fine.v, dv, fine.aux["m_int"], "add"
            )
            if v is None:
                err = self.kernels.prolong(l, dv)
                v = stencil.apply_correction(fine.v, err, fine.aux["m_int"])
                self.kernels.v_written(l)
            fine.v = v
        return self._relax(levels, l, cfg.nu2)

    def fmg(self, levels: Levels) -> Levels:
        cfg = self.config
        nlev = len(self.geoms)
        # FMG defines its own initial guess: re-impose every non-wrap
        # level's Dirichlet data (prior cycles zero coarse boundaries,
        # where coarse v holds the error).  Wrap levels keep an invariant
        # zero boundary plane.
        for l, geom in enumerate(self.geoms):
            if geom.wrap:
                continue
            lvl = levels[l]
            lvl.v = lvl.v * lvl.aux["m_int"] + lvl.aux["bv_ring"]
            self.kernels.v_written(l)
        # cascade the RHS down
        if self._rhs_zero:
            for l in range(1, nlev):
                levels[l].f.zero_()  # in place: earlier f is dead
                self.kernels.f_written(l)
        else:
            for l in range(nlev - 1):
                coarse = levels[l + 1]
                cf = self._fused(
                    "restrict_direct", l, levels[l].f, coarse.aux
                )
                if cf is None:
                    cf = self.kernels.restrict(
                        l,
                        levels[l].f,
                        coarse.aux["m_int"],
                        coarse.aux["m_log"],
                    )
                coarse.f = cf
                self.kernels.f_written(l + 1)
        # coarsest: zero interior, keep Dirichlet boundary
        bot = levels[-1]
        bot.v = stencil.set_interior(bot.v, 0.0, bot.aux["m_int"])
        self.kernels.v_written(nlev - 1)
        # upward leg: nu0 V-cycles per level, then prolong the solution
        for l in range(nlev - 1, -1, -1):
            # an exact coarsest "V-cycle" is a direct solve — idempotent
            reps = 1 if cfg.coarsest == "exact" and l == nlev - 1 else cfg.nu0
            for _ in range(reps):
                levels = self.v_cycle(levels, l)
            if l > 0:
                fine = levels[l - 1]
                v = self._fused(
                    "prolong_blend", l - 1, fine.v, levels[l].v,
                    fine.aux["m_int"], "replace",
                )
                if v is None:
                    vfine = self.kernels.prolong(l - 1, levels[l].v)
                    v = fine.v + fine.aux["m_int"] * (vfine - fine.v)
                fine.v = v
        return levels

    def solve_step(self, levels: Levels, kind: str | None = None) -> Levels:
        """One iteration of `kind` ("fmg" or "v"; default: the configured
        schedule) on the finest level.  The entry point of the cycles:
        every level's dense v is current before and after it, whatever
        layout the kernel tier keeps in between."""
        self.kernels.reset_state()
        if (kind or self.config.kind) == "fmg":
            levels = self.fmg(levels)
        else:
            levels = self.v_cycle(levels, 0)
        for l, lvl in enumerate(levels):
            lvl.v = self.kernels.dense_v(l, lvl.v)
        return levels

    # -- diagnostics -------------------------------------------------------

    def residual_norms(self, levels: Levels, l: int = 0):
        """(L2-mean, Linf) norms of the level-`l` residual, as 0-dim
        tensors on the level's device (no host sync); the sums and the max
        are the kernel tier's, over the whole level."""
        lvl = levels[l]
        k = self.kernels
        r = k.residual(l, lvl.v, lvl.f, lvl.aux)
        n_log = k.level_sum(l, lvl.aux["m_log"])
        l2 = torch.sqrt(k.level_sum(l, r * r) / n_log)
        linf = k.level_max(l, torch.abs(r))
        return l2, linf


def _zebra_masks(geom: LevelGeometry, zebra_axis: int, dtype,
                 device="cpu"):
    """(even, odd) parity masks along one axis, broadcastable: the two
    colours of lines of a zebra sweep."""
    n = geom.padded_shape[zebra_axis]
    shape = [1] * geom.ndim
    shape[zebra_axis] = n
    par = (torch.arange(n, device=device) % 2).reshape(shape)
    return (par == 0).to(dtype), (par == 1).to(dtype)


class ZebraLines:
    """One level's plain zebra line relaxation along `axis`
    (`stencil.relax_zebra_line` with the problem's `line_system`): the
    line builder, the interior mask and the two zebra masks, made once,
    in `dtype` on `device`.  The plain tier relaxes with it, and the line
    kernel (`ops.cuda.zebra_line`) is held against it."""

    def __init__(self, problem, geom: LevelGeometry, axis: int,
                 dtype=torch.float32, device="cpu"):
        self.axis, self.zebra_axis = axis, (axis + 1) % geom.ndim
        self.build = problem.line_system(axis, geom)
        self.m_int = base_aux(geom, dtype, device)["m_int"]
        self.masks = _zebra_masks(geom, self.zebra_axis, dtype, device)

    def relax(self, v, f, nsweeps: int):
        """`nsweeps` zebra sweeps, even lines first; a new tensor."""
        return stencil.relax_zebra_line(self.build, v, f, self.m_int,
                                        self.axis, self.zebra_axis,
                                        self.masks, nsweeps)

    def half_sweep(self, v, f, colour: int):
        """The colour-`colour` half of one sweep; a new tensor."""
        return stencil.zebra_half_sweep(self.build, v, f, self.m_int,
                                        self.axis, self.masks[colour])
