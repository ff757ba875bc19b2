"""Per-level kernel plan for the CUDA tier: the counterpart of the JAX
package's `ops/pallas/dispatch.py` `PallasKernels`.

`CudaKernels` overrides the plain tensor tier (`cycles.TorchKernels`)
with the hand-written kernels.

3D Poisson, wrap storage:

  * relax: every 3D wrap level with even extents that the cycle relaxes,
    in the order of JAX's `plan_relax` (relax.py:3889-3990):
      - the whole-leg resident kernel (`ops/cuda/resident3d.py`, one
        launch per leg) on the levels of JAX's merged gate (Z < 128,
        Y Z % 128 == 0: 64^3, 32^3, 16^3) that it holds, as
        `make_merged_resident_relax` (row 4);
      - the same kernel's one-CTA mode on the other levels one CTA holds
        (8^3, 4^3, 2^3), as `make_resident_relax` (row 1), whose resident
        tier JAX tries before the wavefront;
      - the time-skewed wavefront (`relax.TIMESKEW_T` sweeps per launch)
        on the levels JAX's `timeskew_plan` gives it
        (`relax.timeskew_plan`: a half-plane of at least 16384 points, so
        256^3 and 512^3), unless `PDE_MG_TIMESKEW` is not "1" (read at
        every call, as JAX reads it);
      - the blocked kernel (`ops/cuda/blocked3d.py`, row 19, T = 1 sweep
        per launch) on the levels whose half-plane busts JAX's row-9 slab
        budget (`blocked3d.use_blocked`: 256^3 and 512^3 once the
        wavefront is off), as JAX's `plan_relax` orders them;
      - the color-split half-sweeps (`ops/cuda/relax.py`, one launch per
        half-sweep) on the rest (128^3, where JAX keeps its slab kernel,
        and any even level the other tiers do not hold).
    In the correction scheme the fused subtree (below) claims the V-cycles
    rooted at 64^3 and below before any of their legs, so the resident
    kernel relaxes them only where no subtree is planned: the FAS scheme,
    the exact coarsest, or a tier built without the cycle.  With
    `mixed` (precision="mixed"), legs of at least `min_sweeps` sweeps take
    the bf16 defect correction (`ops/cuda/defect.py`) instead on every
    level, shorter legs the level's float32 relax, as the JAX
    `PallasKernels.relax` chooses (dispatch.py:196-206).  One deliberate
    difference: JAX has no defect plan at 256^3 and 512^3 (a VMEM budget,
    defect.py:289-368) and runs the float32 wavefront there; the port
    keeps the defect path, whose solve stays within 10 % of float64's
    error where the float32 sweeps do not (ROADMAP queue 2 item 37);
  * residual + restrict, restrict alone (the FMG f-cascade) and
    prolong + blend in both modes (`ops/cuda/transfer.py`) for every 3D
    wrap level pair with (X, Y, Z) == 2 (Xc, Yc, Zc);
  * the residual (residual norms, FAS's fine residual) on every 3D wrap
    level, and its f-less mode (`residual_zero_f`, FAS's coarse right
    side residual(v, 0), no zero f filled and read);
  * the fused coarse-subtree cycle (`ops/cuda/subtree.py`), when the
    tier is given the `CycleConfig`: planned once, at construction, by
    `subtree.plan_fused_cycles` (red-black Gauss-Seidel, the correction
    scheme, the relaxed coarsest level, float32, V- or W-cycles: the
    cycle's mu goes into the kernel), and run through the
    `fused_vcycle` / `fused_correction` hooks, which return None where the
    plan has no kernel.  On the 3D presets every V-cycle rooted at 64^3
    or below is one launch, and so is every W-cycle there.  With `mixed` the fused roots stay fused: the
    hook is consulted before any relax leg, and the kernel is float32.

3D Poisson, padded storage (a nonzero Dirichlet boundary), the JAX plan
of `plan_relax` (relax.py:3876-4105) with the TPU's VMEM gates replaced by
the kernels' capacity:

  * relax: the whole-leg kernel (`ops/cuda/padded3d.py`, row 1's padded
    form, one launch a leg) on every level its cluster holds (65^3 ...
    3^3), as JAX's `make_resident_relax` on 33^3 and below; the
    half-sweep kernel (`ops/cuda/slab3d.py`, row 3's padded form, a
    launch a colour) on the rest (129^3, 257^3, 513^3), as JAX's
    `make_slab_relax` on 129^3.  Two deliberate differences: 65^3, JAX's
    slab level, takes the leg, which holds it on chip; 257^3 and 513^3,
    where JAX's VMEM budget refuses every slab and its jnp tier relaxes,
    take the half-sweep kernel;
  * transfers, the residual norms, FAS's injection and coarse right side:
    the plain ops of `ops/stencil.py` on the card.  These are the JAX
    package's jnp ops on padded 3D levels (`transfer.planner_ok`,
    `make_residual` and its small-pair gates take wrap levels only), not a
    fallback; no fused subtree (`subtree.subtree_ok` takes wrap levels);
  * with `mixed`, no defect plan covers a padded level (`defect.py:121`),
    so the levels relax in float32, as JAX does.

2D Lyapunov, padded storage (the JAX plan of `plan_split2d_raw`,
`plan_relax` and `dispatch.py:56-84`, `:185-284`):

  * split levels (half width Y // 2 >= SPLIT2D_MIN_Y2): the persistent
    color-split tier.  The level's state lives in red/black halves
    across a whole visit (relax, residual + restrict, the coarse visit,
    prolong + blend, relax): JAX's sweeps_per_call = T form of row 16,
    `relax2d.relax_halves2d`, one launch of the colour slab's one-rank
    chunk (`csrc/color_slab2d_shard.cu`) per T = 4 sweeps, f-less on
    f-less legs, and `ops/split2d.py`'s residual + restrict and prolong +
    blend on the halves.  Conversions (the split2d / merge2d kernels) run
    only where a dense array is needed; see "Persistent halves" below;
  * with `SPLIT2D_REDUCED` (JAX's opt-in `PDE_MG_SPLIT2D_REDUCED=1`,
    read at import), the split levels are reduced levels instead: each
    leg splits v (and f, unless the leg is f-less), runs the
    reduced-system kernel (`ops/cuda/reduced2d.py`, row 18) in chunks of
    JAX's T, and merges back; no persistent halves (JAX's
    `plan_split2d_raw` returns None there), so the level's transfers are
    the plain ops below;
  * other relaxed levels: the whole-leg resident kernel
    (`ops/cuda/resident.py`: the dense form of the colour slab's leg, on
    a cluster of up to 16 CTAs);
  * pairs whose fine level is not a split level, and the residual norms:
    the plain ops of `ops/stencil.py` on the card.  These are the JAX
    package's non-Pallas ops (jnp/XLA: its `make_residual` is 3D-only, and
    its small 2D transfers stay jnp), not a fallback;
  * with `mixed`, no defect plan covers a 2D level (3D wrap only, as in
    JAX: `ops/pallas/defect.py:121`), so the levels relax in float32, as
    JAX does.

2D HJB (`HJBMinTime`, upwind scheme), padded storage (the JAX plan of
`plan_relax`, relax.py:3883-3925 and :4073-4105, with the color-split tier
vetoed as `HJBMinTime` does by default):

  * relax: the whole-leg resident kernel's HJB variant
    (`ops/cuda/resident.py`) on every relaxed level it holds (257^2 and
    below), the slab kernel (`ops/cuda/slab2d.py`, T sweeps per launch)
    on the others (513^2 on the bench's hjb2d row); both apply the pinned
    target ball's keep mask;
  * transfers, the FAS cycle's injection and residuals (its coarse right
    side and the residual norms): the plain ops of `ops/stencil.py` on the
    card.  These are the JAX package's jnp ops on this path (its
    `make_residual` is 3D-only, its 2D XLA pick-matrix transfers are off
    by default), not a fallback;
  * `HJBMinTime(scheme="tesi")` raises: its kernels are ROADMAP.md queue 2
    item 30.

2D Poisson, wrap storage (the default: zero boundary) and padded storage
(a nonzero boundary), the JAX plan of `plan_relax` and
`plan_split2d_raw`, level by level:

  * wrap levels: the slab kernel (`ops/cuda/slab2d.py`, Poisson form, T
    sweeps a launch; a leg a launch where its tiles are co-resident) on
    4096^2, 2048^2 and 1024^2 (JAX's `make_slab_relax`), and the dense leg
    kernel (`ops/cuda/resident.py`, Poisson form, one launch a leg) on
    256^2 ... 2^2 (JAX's `make_resident_relax`).  512^2, resident in
    JAX, goes to the slab kernel: no cluster of the leg kernel holds it
    (`resident.poisson_leg_layout`, the capacity gate HJB's 513^2 has);
  * padded split levels (Y // 2 >= SPLIT2D_MIN_Y2: 4097^2 ... 513^2): the
    persistent colour-split tier as for Lyapunov (row 16's one-rank
    chunk in its Poisson form, `relax2d.relax_halves2d`, and
    `ops/split2d.py`'s residual + restrict and prolong + blend on the
    halves through `Poisson.split_operator2d`); below, the dense leg
    kernel (257^2 ... 3^2), a level it does not hold going to the slab
    kernel;
  * transfers and the residual norms: the plain ops of `ops/stencil.py`
    on the card, as for Lyapunov (JAX's jnp ops here);
  * with `mixed` the levels relax in float32 (no defect plan covers a 2D
    level), as JAX does.

1D levels: Ode1D (padded storage) and Poisson(1) (wrap storage), the
JAX plan of `plan_relax` (relax.py:3925-3939) and its jnp transfers:

  * relax: the whole-leg 1D kernel (`ops/cuda/relax1d.py`) on every
    relaxed level; a level beyond its cluster's capacity raises;
  * transfers and the residual norms: the plain ops of `ops/stencil.py` on
    the card.  These are the JAX package's jnp ops for 1D (its Pallas
    transfer kernels and `make_residual` are 3D-only), not a fallback;
  * with `mixed`, no defect plan covers a 1D level (`defect.py:257-263`),
    so the levels relax in float32, as JAX does.

The TPU planner's VMEM gates (`plan_relax`, `planner_ok`, the split2d
window ladder) and lane/sublane conditions have no Hopper counterpart.  A
level, pair or problem the plan cannot serve raises instead of running
plain tensor ops on the card.

Persistent halves.  JAX gets them from trace-time identity caches and
dead-code elimination (`ops/pallas/dispatch.py:154-183`); eager PyTorch
has neither, so this tier holds them as explicit level state: per split
level, two pairs of halves of v (a chunk writes apart from what it
reads, so a relax leaves the result in either pair; the pair that holds
it is the current one, with which of dense and halves is current) and
the halves of f.  `cycles.CycleProgram` tells the tier where it reads or
writes a level's dense v or f itself (`v_written`, `f_written`,
`zero_v`), and `solve_step` starts (`reset_state`) and ends (`dense_v`)
every step on current dense tensors.  Per visit of a split level that
costs at most one split of v, one split of f (none on f-less legs) and
one merge, for prolonging the level's v to the next finer one
(`prolong_blend_halves` takes the coarse array dense); `conversions`
counts them.
"""

from __future__ import annotations

import os

import torch

from pde_multigrid_tpu_torch.cycles import TorchKernels
from pde_multigrid_tpu_torch.models.hjb import HJBMinTime
from pde_multigrid_tpu_torch.models.lyapunov2d import Lyapunov2D
from pde_multigrid_tpu_torch.models.ode1d import Ode1D
from pde_multigrid_tpu_torch.models.poisson import Poisson
from pde_multigrid_tpu_torch.ops import split2d
from pde_multigrid_tpu_torch.ops.cuda import blocked3d as blocked_mod
from pde_multigrid_tpu_torch.ops.cuda import defect as defect_mod
from pde_multigrid_tpu_torch.ops.cuda import padded3d as padded3d_mod
from pde_multigrid_tpu_torch.ops.cuda import reduced2d as reduced_mod
from pde_multigrid_tpu_torch.ops.cuda import relax as relax_mod
from pde_multigrid_tpu_torch.ops.cuda import relax1d as relax1d_mod
from pde_multigrid_tpu_torch.ops.cuda import relax2d as relax2d_mod
from pde_multigrid_tpu_torch.ops.cuda import resident as resident_mod
from pde_multigrid_tpu_torch.ops.cuda import resident3d as resident3d_mod
from pde_multigrid_tpu_torch.ops.cuda import slab2d as slab_mod
from pde_multigrid_tpu_torch.ops.cuda import slab3d as slab3d_mod
from pde_multigrid_tpu_torch.ops.cuda import subtree as subtree_mod
from pde_multigrid_tpu_torch.ops.cuda import transfer as transfer_mod

# smallest half width (Y // 2) of a persistent-split 2D level: the JAX
# package's SPLIT2D_MIN_Y2 (relax.py:3751), so the same levels split
SPLIT2D_MIN_Y2 = 256
# the reduced-system kernel for one-sided 2D stencils (row 18), off by
# default: JAX's opt-in, read as it reads it, at import (relax.py:3756)
SPLIT2D_REDUCED = os.environ.get("PDE_MG_SPLIT2D_REDUCED", "0") == "1"


def _level_ok(g) -> bool:
    return g.wrap and g.ndim == 3 and all(n % 2 == 0 for n in g.padded_shape)


def _pair_ok(gf, gc) -> bool:
    return (
        _level_ok(gf)
        and gc.wrap
        and gc.ndim == 3
        and tuple(gf.padded_shape) == tuple(2 * n for n in gc.padded_shape)
    )


def _padded_2d(g) -> bool:
    return g.ndim == 2 and not g.wrap


def _plain_ok(g) -> bool:
    """Levels whose transfers and residual run the plain ops: 1D and 2D
    levels (2D wrap levels: 2D Poisson's) and padded 3D levels."""
    return g.ndim in (1, 2) or padded3d_mod.padded_3d(g)


def _split2d_ok(g) -> bool:
    """plan_split2d_raw's gate without the TPU-only conditions (X % 8,
    even Y, the VMEM window ladder): a padded 2D level stored unpadded
    (odd Y is served by the inert slot) with Y // 2 >= SPLIT2D_MIN_Y2."""
    return (_padded_2d(g) and tuple(g.padded_shape) == tuple(g.shape)
            and g.padded_shape[1] // 2 >= SPLIT2D_MIN_Y2)


def _reduced_t(problem, g):
    """T of the reduced-system kernel on a level that passes `_split2d_ok`,
    or None where JAX's plan keeps the color-split tier: the opt-in is off,
    or the problem is not eligible (relax.py:4052-4056: it names its
    `reduced2d_fields` and its stencil reads +x only), or JAX's block
    ladder finds no block (then the level keeps the split tier here)."""
    if not (SPLIT2D_REDUCED and hasattr(problem, "reduced2d_fields")
            and tuple(getattr(problem, "split2d_x_offsets", ())) == (1,)):
        return None
    return reduced_mod.chunk_sweeps(g)


def _relax3d(problem, g):
    """(tier, relax(v, f, nsweeps) -> v) of a 3D wrap level with even
    extents, in the order of JAX's `plan_relax` (relax.py:3889-3990);
    the tier is the name of the kernel's launch counter."""
    if resident3d_mod.merged_gate(g) and resident3d_mod.fits(g):
        fn, tier = resident3d_mod.merged_resident_relax, "merged_resident"
    elif resident3d_mod.one_cta(g):
        fn, tier = resident3d_mod.resident3d_relax, "resident3d"
    elif relax_mod.timeskew_plan(g):
        return "timeskew", relax_mod.make_timeskew_relax(problem, g)
    elif blocked_mod.use_blocked(g):
        return "blocked3d", blocked_mod.make_blocked_relax(problem, g)
    else:
        return "half_sweep", relax_mod.make_split_relax(problem, g)

    def relax(v, f, nsweeps):
        return fn(v, f, nsweeps, problem, g)

    return tier, relax


def _not_planned(what: str, item: str = "queue 2") -> NotImplementedError:
    return NotImplementedError(
        f"{what}: the CUDA tier serves 3D Poisson (wrap and padded "
        "storage), 2D Poisson, padded 2D Lyapunov and HJB (upwind) and 1D "
        "Ode1D / Poisson levels in float32; other problems and layouts are "
        f"ROADMAP.md {item}"
    )


class CudaKernels(TorchKernels):
    """Plain tensor tier with per-level CUDA kernels for every hot op."""

    def __init__(self, problem, geoms, dtype, relaxed_levels=None,
                 mixed=False, cycle=None):
        super().__init__(problem, geoms)
        if dtype != torch.float32:
            raise _not_planned(f"dtype {dtype}")
        lyap = isinstance(problem, Lyapunov2D)
        hjb = isinstance(problem, HJBMinTime)
        if hjb:
            resident_mod.check_hjb(problem)
        if not (lyap or hjb or isinstance(problem, (Poisson, Ode1D))):
            raise _not_planned(f"problem {problem.name}")
        poisson2d = isinstance(problem, Poisson) and problem.ndim == 2
        poisson3d = isinstance(problem, Poisson) and problem.ndim == 3
        # the colour-split tier's problems (padded storage)
        split_ok = lyap or poisson2d
        n = len(self.geoms)
        relaxed = range(n) if relaxed_levels is None else relaxed_levels
        self._relax = [None] * n
        # per relaxed 3D level, the launch counter of the kernel that
        # relaxes it in float32 (the plan the tests pin)
        self.tiers = [None] * n
        self._defect = [None] * n
        self._split = [False] * n
        # T per chunk of the reduced levels (None: not reduced)
        self._reduced_t = [None] * n
        for l in relaxed:
            g = self.geoms[l]
            if g.ndim == 1:
                if relax1d_mod.layout(g, problem) is None:
                    raise _not_planned(
                        f"relax on 1D level {g.padded_shape} (beyond the "
                        f"relax1d kernel's {relax1d_mod.MAX_CTAS} CTAs of "
                        f"{relax1d_mod.MAX_WARPS} warps)", "queue 2 item 29")
                self._relax[l] = self._relax_1d
            elif split_ok and _split2d_ok(g):
                self._reduced_t[l] = _reduced_t(problem, g)
                self._split[l] = self._reduced_t[l] is None
                self._relax[l] = (self._relax_split if self._split[l]
                                  else self._relax_reduced)
            elif lyap and resident_mod.fits(g):
                self._relax[l] = self._relax_resident
            elif hjb and _padded_2d(g):
                self._relax[l] = (self._relax_resident
                                  if resident_mod.hjb_leg_layout(g)
                                  else self._relax_slab)
            elif poisson2d and g.ndim == 2:
                # the leg where a cluster holds the level, else the slab
                if resident_mod.poisson_leg_layout(g):
                    self._relax[l] = self._relax_resident
                elif slab_mod.slab_layout(g):
                    self._relax[l] = self._relax_slab
                else:
                    raise _not_planned(f"relax on level {g}")
            elif poisson3d and padded3d_mod.padded_3d(g):
                # the leg where its cluster holds the level, else a
                # sweep a launch
                if padded3d_mod.fits(g):
                    self.tiers[l] = "padded3d"
                    self._relax[l] = self._relax_padded3d
                else:
                    self.tiers[l] = "slab3d"
                    self._relax[l] = self._relax_slab3d
            elif not lyap and _level_ok(g):
                self.tiers[l], self._relax[l] = _relax3d(problem, g)
            else:
                raise _not_planned(f"relax on level {g}")
            if mixed:
                # None off 3D wrap levels: the level relaxes in float32,
                # as the JAX package's PallasKernels.relax does
                self._defect[l] = defect_mod.plan_defect_relax(
                    problem, g, dtype
                )
        # 1D, 2D and padded 3D levels: plain transfers and residual norms
        self._plain = [_plain_ok(g) for g in self.geoms]
        low = self._plain[0]
        for l in range(n - 1):
            gf, gc = self.geoms[l], self.geoms[l + 1]
            ok = (_plain_ok(gf) and _plain_ok(gc)) if low else _pair_ok(
                gf, gc)
            if not ok:
                raise _not_planned(
                    f"transfers between {gf.padded_shape} and "
                    f"{gc.padded_shape}"
                )
        for g in self.geoms:
            if not (_plain_ok(g) if low else (g.wrap and g.ndim == 3)):
                raise _not_planned(f"residual on level {g}")
        # persistent halves of split levels (explicit level state)
        self._vh = [None] * n  # (r, b) of v: the current pair
        self._vh_spare = [None] * n  # the other pair, a relax's output
        self._fh = [None] * n  # (fr, fb) of f
        self._v_cur = ["dense"] * n  # "dense" | "halves" | "both"
        self._f_ok = [False] * n
        self.conversions = {"split_v": 0, "split_f": 0, "merge": 0}
        # the fused coarse-subtree V-cycles (no plan without the cycle)
        self._sub_v, self._sub_c = subtree_mod.plan_fused_cycles(
            problem, self.geoms, cycle, dtype)

    # -- persistent halves -------------------------------------------------

    def _alloc(self, l, like):
        X = self.geoms[l].padded_shape[0]
        Y2 = split2d.half_width(self.geoms[l])
        return (like.new_empty((X, Y2)), like.new_empty((X, Y2)))

    def _v_halves(self, l, v):
        if self._vh[l] is None:
            self._vh[l] = self._alloc(l, v)
        if self._v_cur[l] == "dense":
            relax2d_mod.to_halves(v, out=self._vh[l])
            self.conversions["split_v"] += 1
            self._v_cur[l] = "both"
        return self._vh[l]

    def _f_halves(self, l, f):
        if self._fh[l] is None:
            self._fh[l] = self._alloc(l, f)
        if not self._f_ok[l]:
            relax2d_mod.to_halves(f, out=self._fh[l])
            self.conversions["split_f"] += 1
            self._f_ok[l] = True
        return self._fh[l]

    def reset_state(self):
        self._v_cur = ["dense"] * len(self.geoms)
        self._f_ok = [False] * len(self.geoms)

    def dense_v(self, l, v):
        if self._v_cur[l] == "halves":
            relax2d_mod.from_halves(*self._vh[l], out=v)
            self.conversions["merge"] += 1
            self._v_cur[l] = "both"
        return v

    def v_written(self, l):
        self._v_cur[l] = "dense"

    def f_written(self, l):
        self._f_ok[l] = False

    def zero_v(self, l, v):
        if not self._split[l]:
            return v.zero_()
        if self._vh[l] is None:
            self._vh[l] = self._alloc(l, v)
        for h in self._vh[l]:
            h.zero_()
        self._v_cur[l] = "halves"
        return v

    # -- relax -------------------------------------------------------------

    def _relax_split(self, l, v, f, nsweeps, f_zero):
        vh = self._v_halves(l, v)
        fr, fb = (None, None) if f_zero else self._f_halves(l, f)
        if self._vh_spare[l] is None:
            self._vh_spare[l] = self._alloc(l, v)
        out = relax2d_mod.relax_halves2d(*vh, fr, fb, nsweeps, self.problem,
                                         self.geoms[l],
                                         spare=self._vh_spare[l])
        if out is self._vh_spare[l]:
            self._vh[l], self._vh_spare[l] = out, vh
        self._v_cur[l] = "halves"
        return v

    def _relax_reduced(self, l, v, f, nsweeps, f_zero):
        # no persistent halves: each leg splits and merges, as JAX's
        # reduced `relax` does
        return reduced_mod.reduced_relax(v, f, nsweeps, self._reduced_t[l],
                                         self.problem, self.geoms[l], f_zero)

    def _relax_1d(self, l, v, f, nsweeps, f_zero):
        # f_zero never holds here (neither 1D problem has rhs_is_zero);
        # the kernel always reads f
        return relax1d_mod.relax1d(v, f, nsweeps, self.problem,
                                   self.geoms[l])

    def _relax_resident(self, l, v, f, nsweeps, f_zero):
        return resident_mod.resident_relax(
            v, None if f_zero else f, nsweeps, self.problem, self.geoms[l]
        )

    def _relax_padded3d(self, l, v, f, nsweeps, f_zero):
        return padded3d_mod.padded3d_relax(
            v, None if f_zero else f, nsweeps, self.problem, self.geoms[l])

    def _relax_slab3d(self, l, v, f, nsweeps, f_zero):
        return slab3d_mod.slab3d_relax(
            v, None if f_zero else f, nsweeps, self.problem, self.geoms[l])

    def _relax_slab(self, l, v, f, nsweeps, f_zero):
        # f_zero never holds here (neither HJB nor Poisson has
        # rhs_is_zero); the kernel always reads f
        return slab_mod.slab_relax(v, f, nsweeps, self.problem,
                                   self.geoms[l])

    def relax(self, l, v, f, aux, nsweeps, f_zero=False):
        fn = self._relax[l]
        if fn is None:
            raise _not_planned(f"relax on unplanned level {l}")
        dfn = self._defect[l]
        if dfn is not None and nsweeps >= dfn.min_sweeps:
            return dfn(v, f, nsweeps)
        if nsweeps == 0:
            return v
        if self._plain[l]:
            return fn(l, v, f, nsweeps, f_zero)
        return fn(v, f, nsweeps)

    # -- transfers ---------------------------------------------------------

    def residual(self, l, v, f, aux):
        if self._plain[l]:
            return super().residual(l, v, f, aux)
        return transfer_mod.residual(v, f, self.problem, self.geoms[l])

    def residual_zero_f(self, l, v, aux):
        if self._plain[l]:
            return None  # the plain residual of a zero f
        return transfer_mod.residual_zero_f(v, self.problem, self.geoms[l])

    def restrict(self, l_fine, arr, m_int_coarse, m_log_coarse):
        if self._plain[l_fine]:
            return super().restrict(l_fine, arr, m_int_coarse, m_log_coarse)
        # wrap levels: m_log == 1, so full weighting with injection on the
        # coarse boundary is exactly the restrict-only kernel
        return transfer_mod.residual_restrict(
            arr, None, self.problem, self.geoms[l_fine],
            self.geoms[l_fine + 1], with_residual=False,
        )

    def prolong(self, l_fine, arr):
        if self._plain[l_fine]:
            return super().prolong(l_fine, arr)
        raise _not_planned(
            "prolongation without a blend (the CUDA tier serves the fused "
            "prolong_blend hook)"
        )

    # -- fused subtree hooks (cycles.CycleProgram consults these) ----------

    def fused_vcycle(self, l, v, f):
        fn = self._sub_v[l]
        return None if fn is None else fn(v, f)

    def fused_correction(self, l, v, f):
        fn = self._sub_c[l]
        return None if fn is None else fn(v, f)

    # -- fused transfer hooks (cycles.CycleProgram consults these) ---------

    def residual_restrict(self, l, v, f, aux, coarse_aux, f_zero=False):
        if self._split[l]:
            r, b = self._v_halves(l, v)
            fr, fb = (None, None) if f_zero else self._f_halves(l, f)
            g = self.geoms[l]
            rr, rb = split2d.residual_halves(self.problem, g, r, b, fr, fb)
            return split2d.restrict_residual_from_halves(
                g, self.geoms[l + 1], rr, rb, coarse_aux["m_int"],
                coarse_aux["m_log"],
            )
        if self._plain[l]:
            return None  # the plain residual, then the plain restriction
        return transfer_mod.residual_restrict(
            v, f, self.problem, self.geoms[l], self.geoms[l + 1]
        )

    def restrict_direct(self, l, arr, coarse_aux):
        if self._plain[l]:
            return None
        return self.restrict(l, arr, None, None)

    def prolong_blend(self, l_fine, base_v, coarse_v, m_int, mode):
        # the coarse level's visit is over: its halves merge once here
        coarse_v = self.dense_v(l_fine + 1, coarse_v)
        if self._split[l_fine]:
            r, b = self._v_halves(l_fine, base_v)
            split2d.prolong_blend_halves(
                self.geoms[l_fine + 1], self.geoms[l_fine], coarse_v, r, b,
                mode,
            )
            self._v_cur[l_fine] = "halves"
            return base_v
        if self._plain[l_fine]:
            return None  # the plain prolongation and blend
        # in place into the fine iterate: each point reads its own base
        # value before writing it, and the old iterate is dead afterwards
        return transfer_mod.prolong_blend(
            coarse_v, base_v, mode, self.geoms[l_fine + 1],
            self.geoms[l_fine], out=base_v,
        )
