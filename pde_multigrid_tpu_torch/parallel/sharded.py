"""The sharded kernel tier (PyTorch port of
`pde_multigrid_tpu.parallel.sharded.ShardedKernels`).

Each rank holds its own x-planes of every level `mesh.level_sharding`
splits and the whole of the others (`mesh.shard_levels`).  In JAX, GSPMD
partitions every op but relax by itself (sharded.py:1-22); here each op
of a sharded level fetches the rows it reads from the ring neighbours
explicitly (`Mesh.window`, rows taken modulo the level as `torch.roll`
wraps it) and runs on the rank's own rows:

  * relax: `halo.make_sharded_relax` (the time-skew, split2d or
    masked-block engine, T = min(sweeps_per_exchange, x_loc // 2) sweeps
    per exchange, sharded.py:68-73);
  * residual: the plain op on the block extended by one row per side,
    owned rows kept;
  * restriction: coarse rows [c0, c1) from the fine window [2 c0 - 1,
    2 c1); into a replicated coarse level the whole op on the gathered
    fine level;
  * FAS injection: the rank's own planes into a sharded coarse level
    (wrap shards nest); into a replicated one, the gathered fine level;
  * prolongation: fine rows [F0, F1) from the coarse window [F0 // 2,
    (F1 - 1) // 2 + 2) (from the whole coarse level where it is
    replicated), and on padded levels the zero rows the unsharded op's
    fit leaves from 2 X_c - 1 on;
  * the exact coarsest solve: gather v and f, solve with the whole
    level's aux, keep the owned rows;
  * global reductions (residual norms, the solver's error norms): the
    local sum or max, reduced over the ranks.

Padded levels' shards do not nest (4097^2 over 4 ranks: 1025 fine rows a
shard, 513 coarse), so a transfer's window may start or end inside a
neighbour's rows; the windows make no assumption about it.  The plain
ops are what JAX runs here too (jnp under GSPMD).  At 257^3 JAX puts the
256^3 -> 128^3 pair on its XLA pick-matrix einsums
(`SHARDED_XLA3D_MIN_YZ`), and every 2D pair on the 2D ones
(`xla_pair_ok_2d`), which reassociate float32 sums; the plain ops compute
the jnp function.  Each op computes every owned point with the unsharded
op's expression on the same values, so a solve is bitwise the same on any
number of ranks (on the logical rows: the padding differs).

On replicated 3D levels relax runs the port's single-device tier: the
CUDA kernels' plan (`CudaKernels`) for float32 on "cuda", the plain tier
otherwise.  JAX runs jnp there only because GSPMD owns those levels; the
kernels compute the same function.  Replicated 2D levels run the split2d
engine on a one-rank ring, so every 2D level relaxes in the one
arithmetic of row 17 on any number of ranks (the resident kernel and the
plain tier round otherwise).  On a one-rank ring the engine takes no
halo, and runs a whole leg in one launch where the level fits on chip
(257^2 and below), whatever T says: the owned rows are bitwise those of
the T-sweep chunks (`halo.make_sharded_relax`).  The fused hooks return
None, as in JAX's `JnpKernels` base, and there is no defect path:
`precision` is ignored, as JAX's sharded tier does.

The tier serves red-black Gauss-Seidel in the correction scheme on 3D
wrap-storage Poisson and on padded 2D Lyapunov (FAS also on the 3D wrap
levels, whose shards nest); any other problem, layout, scheme or smoother
raises at construction, naming its ROADMAP.md item.
"""

from __future__ import annotations

from typing import Sequence

import torch

from pde_multigrid_tpu_torch.cycles import TorchKernels
from pde_multigrid_tpu_torch.grid import LevelGeometry
from pde_multigrid_tpu_torch.models.lyapunov2d import Lyapunov2D
from pde_multigrid_tpu_torch.models.poisson import Poisson
from pde_multigrid_tpu_torch.ops import stencil
from pde_multigrid_tpu_torch.parallel import halo
from pde_multigrid_tpu_torch.parallel.mesh import (
    Mesh,
    level_sharding,
    shard_rows,
)


def check_sharded(problem, geoms: Sequence[LevelGeometry], smoother: str,
                  dtype, scheme: str = "cs") -> None:
    """Raise NotImplementedError, naming its ROADMAP.md item, for a mesh
    solve outside the ported slice: 3D wrap-storage Poisson or padded 2D
    Lyapunov, RBGS, float32, and FAS only on the wrap levels."""
    g = geoms[0]
    if hasattr(problem, "kernel_keep_mask"):
        raise NotImplementedError(
            f"a mesh solve of {problem.name}: the keep-mask variant of the "
            "masked-block engine and the sharded FAS ops are ROADMAP.md "
            "queue 2 item 40")
    if g.ndim == 2 and isinstance(problem, Poisson):
        raise NotImplementedError(
            f"a mesh solve of {problem.name}: 2D Poisson on a mesh needs a "
            "two-sided halo in the split2d engine and row 17's Poisson "
            "form; it is ROADMAP.md queue 1 item 17")
    ok = ((isinstance(problem, Poisson) and g.ndim == 3 and g.wrap)
          or (isinstance(problem, Lyapunov2D) and not g.wrap))
    if not ok:
        raise NotImplementedError(
            f"a mesh solve of {problem.name} ({g.ndim}D, "
            f"{'wrap' if g.wrap else 'padded'} storage): the sharded tier "
            "serves 3D wrap-storage Poisson and padded 2D Lyapunov; the "
            "rest is ROADMAP.md queue 1 item 17")
    if scheme == "fas" and not g.wrap:
        raise NotImplementedError(
            f"scheme='fas' on a mesh with padded levels ({problem.name}): "
            "injection across shards that do not nest is one of the "
            "sharded FAS ops of ROADMAP.md queue 2 item 40")
    if smoother != "rbgs":
        raise NotImplementedError(
            f"smoother={smoother!r} on a mesh: the sharded tier relaxes by "
            "red-black Gauss-Seidel; other smoothers are ROADMAP.md queue 1 "
            "item 17")
    if dtype != torch.float32:
        raise NotImplementedError(
            f"{dtype} on a mesh: the sharded tier runs float32; other "
            "dtypes are ROADMAP.md queue 1 item 17")


def _pad_rows(aux, x_loc: int):
    """`aux` with every field of the shard's x_loc rows extended by one
    row at each end (copies of its edge rows), for an op on the block
    extended by one row per side whose two end rows are dropped."""
    return {k: torch.cat([a[:1], a, a[-1:]]) if a.dim() and a.shape[0]
            == x_loc else a for k, a in aux.items()}


class ShardedKernels(TorchKernels):
    """The plain tensor tier with halo exchanges on sharded levels."""

    def __init__(self, problem, geoms: Sequence[LevelGeometry], mesh,
                 dtype=torch.float32, smoother: str = "rbgs",
                 omega: float = 1.0, sweeps_per_exchange: int = 4,
                 relaxed_levels=None, scheme: str = "cs"):
        check_sharded(problem, geoms, smoother, dtype, scheme)
        super().__init__(problem, geoms, smoother, omega)
        self.mesh = mesh
        nlev = len(self.geoms)
        self.sharded = [level_sharding(mesh, g) for g in self.geoms]
        self.rows = [shard_rows(mesh, g) for g in self.geoms]
        # per level: the padded aux of the residual's block, and the whole
        # level's aux for the coarse solve, each made at its first use
        self._aux_pad = {}
        self._aux_whole = {}
        relaxed = range(nlev) if relaxed_levels is None else relaxed_levels
        self._relax = [None] * nlev
        # per level: the engine, "whole" (a replicated level relaxed by
        # the single-device tier) or None (not relaxed).  A replicated 2D
        # level runs the split2d engine on a one-rank ring: every level
        # then relaxes in one arithmetic, whatever the number of ranks
        self.plan = [None] * nlev
        # (a one-rank Mesh makes no collective call, whatever its backend)
        one = Mesh(rank=0, n=1, device=mesh.device, backend="gloo")
        for l in relaxed:
            g = self.geoms[l]
            ring = mesh if self.sharded[l] else one
            if self.sharded[l] or halo.plan_engine(problem, g, 1) == "split2d":
                x_loc = g.padded_shape[0] // ring.n
                t_eff = min(sweeps_per_exchange, x_loc // 2)
                self._relax[l] = halo.make_sharded_relax(problem, g, ring,
                                                         t_eff)
                self.plan[l] = self._relax[l].engine
            else:
                self.plan[l] = "whole"
        # relax on the other replicated levels: the single-device tier
        whole = [l for l in relaxed if self.plan[l] == "whole"]
        if mesh.device.type == "cuda":
            from pde_multigrid_tpu_torch.ops.cuda.dispatch import CudaKernels

            self._whole = CudaKernels(problem, self.geoms, dtype, whole)
        else:
            self._whole = TorchKernels(problem, self.geoms, smoother, omega)

    # -- halo helpers ------------------------------------------------------

    def _window(self, arr, lo_of, hi_of):
        """Global rows [lo_of(r), hi_of(r)) of a sharded level's field on
        rank r = this rank (`Mesh.window`), the exchange sized for the
        widest reach of any rank."""
        x_loc, n = arr.shape[0], self.mesh.n
        depth = max(max(r * x_loc - lo_of(r), hi_of(r) - (r + 1) * x_loc, 0)
                    for r in range(n))
        r = self.mesh.rank
        return self.mesh.window(arr, lo_of(r), hi_of(r), depth)

    # -- ops -----------------------------------------------------------------

    def relax(self, l, v, f, aux, nsweeps, f_zero=False):
        if nsweeps == 0:
            return v
        fn = self._relax[l]
        if fn is not None:
            return fn(v, f, nsweeps)
        return self._whole.relax(l, v, f, aux, nsweeps, f_zero)

    def residual(self, l, v, f, aux):
        if not self.sharded[l]:
            return super().residual(l, v, f, aux)
        x_loc = v.shape[0]
        block = self._window(v, lambda r: r * x_loc - 1,
                             lambda r: (r + 1) * x_loc + 1)
        key = tuple(a.data_ptr() for a in aux.values())
        if self._aux_pad.get(l, (None,))[0] != key:
            self._aux_pad[l] = (key, _pad_rows(aux, x_loc))
        lv = self.problem.apply_operator(block, self.geoms[l],
                                         self._aux_pad[l][1])[1:-1]
        return stencil.residual(lambda _: lv, v, f, aux["m_int"])

    def restrict(self, l_fine, arr, m_int_coarse, m_log_coarse):
        if not self.sharded[l_fine]:
            return super().restrict(l_fine, arr, m_int_coarse, m_log_coarse)
        if not self.sharded[l_fine + 1]:
            return stencil.restrict_full_weighting(
                self.mesh.all_gather(arr), m_int_coarse, m_log_coarse)
        xc = m_int_coarse.shape[0]
        # restrict_full_weighting on the window: its rows 1, 3, ... are
        # the fine rows 2 c0, 2 c0 + 2, ... of the coarse rows [c0, c1)
        fine = self._window(arr, lambda r: 2 * r * xc - 1,
                            lambda r: 2 * (r + 1) * xc)
        a = fine
        for ax in range(a.ndim):
            a = (0.25 * stencil._shift(a, ax, -1) + 0.5 * a
                 + 0.25 * stencil._shift(a, ax, +1))
        cshape = tuple(m_int_coarse.shape)
        smoothed = stencil._fit(stencil._subsample2(a[1:]), cshape)
        injected = stencil._fit(stencil._subsample2(fine[1:]), cshape)
        out = injected + m_int_coarse * (smoothed - injected)
        if m_log_coarse is not None:
            out = out * m_log_coarse
        return out

    def inject(self, l, v, coarse_shape):
        # shards of wrap levels nest (x_loc even): a sharded coarse level
        # takes the injection of the rank's own planes; a replicated one
        # the whole fine level's, gathered first as `restrict` does
        if self.sharded[l] and not self.sharded[l + 1]:
            v = self.mesh.all_gather(v)
        return super().inject(l, v, coarse_shape)

    def prolong(self, l_fine, arr):
        if not self.sharded[l_fine]:
            return super().prolong(l_fine, arr)
        g = self.geoms[l_fine]
        x_loc = g.padded_shape[0] // self.mesh.n
        X_c = self.geoms[l_fine + 1].padded_shape[0]

        def lo_of(r):
            return r * x_loc // 2

        def hi_of(r):
            return ((r + 1) * x_loc - 1) // 2 + 2

        r = self.mesh.rank
        if self.sharded[l_fine + 1]:
            block = self._window(arr, lo_of, hi_of)
        else:
            idx = (lo_of(r) + torch.arange(hi_of(r) - lo_of(r),
                                           device=arr.device)) % X_c
            block = arr.index_select(0, idx)
        # prolong_linear on the block: axis 0 first (fine rows [2 lo,
        # 2 hi - 1)), the owned rows, then the other axes and the fit
        s = r * x_loc - 2 * lo_of(r)
        a = stencil._upsample_axis(block, 0)[s:s + x_loc]
        up = (stencil._upsample_axis_periodic if g.wrap
              else stencil._upsample_axis)
        for ax in range(1, a.ndim):
            a = up(a, ax)
        a = stencil._fit(a, (x_loc,) + tuple(g.padded_shape[1:]))
        first_zero = 2 * X_c - 1 - r * x_loc
        if not g.wrap and first_zero < x_loc:
            a[max(first_zero, 0):] = 0
        return a

    def coarse_solve(self, l, solve, v, f, aux):
        if not self.sharded[l]:
            return solve(v, f, aux)
        if l not in self._aux_whole:
            self._aux_whole[l] = self.problem.init_level(
                self.geoms[l], dtype=v.dtype, device=v.device).aux
        full = solve(self.mesh.all_gather(v), self.mesh.all_gather(f),
                     self._aux_whole[l])
        return full[self.rows[l]]

    # -- global reductions ---------------------------------------------------

    def level_sum(self, l, t):
        s = torch.sum(t)
        return self.mesh.all_reduce(s) if self.sharded[l] else s

    def level_max(self, l, t):
        m = torch.max(t)
        return self.mesh.all_reduce(m, "max") if self.sharded[l] else m

    def owned_rows(self, l):
        return self.rows[l]

    def gather(self, l, arr):
        return self.mesh.all_gather(arr) if self.sharded[l] else arr
