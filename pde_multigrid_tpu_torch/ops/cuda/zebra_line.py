"""Zebra line relaxation on the card: the CUDA kernel of
`csrc/zebra_line.cu`, its plain PyTorch version, and the kernel tier that
runs it.

Replaces no Pallas kernel.  The JAX package relaxes with `smoother="line-K"`
on its jnp tier (`solver.py:50-52`): `ops/stencil.py` `thomas_tridiagonal`
(a `lax.scan` along the line axis, one multiply-add a point and row, its
per-row constants computed on the host) and `relax_zebra_line`, with the
problem's `line_system`.  The kernel runs one half-sweep (every line of
one colour) in one launch, one thread a line; its plain version is
`relax_zebra_line` itself (`ops/stencil.py`, through `cycles.ZebraLines`,
as the plain tier runs it), which it equals bit for bit
(`torch.equal`: the plain blend may turn a -0 into +0 on points it masks).

The layout (`layout`) puts whole columns of lines along the level's
third axis into each CTA, so one block barrier between a line's forward
and backward pass makes the in-place half-sweep equal to the plain one,
whose lines all read the v of the half-sweep's start (see the source's
note).  `LinePlan` holds a level's launch parameters, its per-row
constants alpha | beta | cp as one float32 device tensor and the dp
scratch, all made once, at construction, so a CUDA graph capture builds
nothing from host arrays.

The wrapper launches the kernel for CUDA tensors, runs the plain version
for CPU tensors, and raises for anything else; there is no fallback from
a CUDA tensor to the plain version.  It updates v in place on both
devices.  `launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from pde_multigrid_tpu_torch.cycles import TorchKernels, ZebraLines
from pde_multigrid_tpu_torch.grid import LevelGeometry
from pde_multigrid_tpu_torch.models.poisson import Poisson, inv_h2
from pde_multigrid_tpu_torch.ops import stencil
from pde_multigrid_tpu_torch.ops.cuda import build
from pde_multigrid_tpu_torch.ops.cuda.relax import _on_cuda, _stream

launches = {"zebra_line": 0}

MAX_THREADS = 1024
# a CTA takes at least this many lines where the third axis' columns are
# shorter (2D: every line is a column of one)
MIN_LINES = 32


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


class ZebraLineParams(ctypes.Structure):
    """csrc/zebra_line.cu `ZebraLineParams`."""

    _fields_ = [(n, ctypes.c_int) for n in
                ("n_line", "s_line", "row_lo", "row_hi", "n_zeb", "s_zeb",
                 "zeb0", "n_zeb_lines", "n_thr", "s_thr", "thr0",
                 "n_thr_lines", "zeb_term_first", "lines_per_cta",
                 "threads", "ctas")]
    _fields_ += [(n, ctypes.c_float) for n in ("w_zeb", "w_thr")]

    def as_dict(self) -> dict:
        return {name: getattr(self, name) for name, _ in self._fields_}


def _not_taken(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what}: the line kernel takes zebra lines of 2D and 3D Poisson "
        "levels; others are ROADMAP.md queue 2 item 51"
    )


def _strides(shape) -> list[int]:
    out, s = [], 1
    for n in reversed(shape):
        out.append(s)
        s *= n
    return out[::-1]


def layout(geom: LevelGeometry, axis: int, colour: int):
    """The kernel's launch for the colour-`colour` lines along `axis` of
    the level, as ZebraLineParams, or None when the colour has no interior
    line there (a 3-point zebra axis has no even one).  Lines run along
    `axis`, their colour is their coordinate's parity on the zebra axis
    (axis + 1) % ndim, and the third axis of a 3D level is (axis + 2) % 3.
    Line g of the colour sits at zebra coordinate zeb0 + 2 (g //
    n_thr_lines) and third coordinate 1 + g % n_thr_lines; CTA b holds
    lines [b * lines_per_cta, (b + 1) * lines_per_cta): whole columns
    along the third axis, at least MIN_LINES where columns are short.
    Raises for a level or axis the kernel does not take."""
    nd = geom.ndim
    if nd not in (2, 3):
        raise _not_taken(f"a {nd}D level")
    if not 0 <= axis < nd:
        raise ValueError(f"line axis {axis} of a {nd}D level")
    if colour not in (0, 1):
        raise ValueError(f"colour {colour}")
    P, S = geom.padded_shape, geom.shape
    st = _strides(P)
    w = inv_h2(geom)
    za = (axis + 1) % nd
    zeb0 = 2 - colour
    n_zeb_lines = len(range(zeb0, S[za] - 1, 2))
    if n_zeb_lines == 0:
        return None
    if nd == 3:
        ta = (axis + 2) % 3
        third = dict(n_thr=P[ta], s_thr=st[ta], thr0=1,
                     n_thr_lines=S[ta] - 2, zeb_term_first=int(za < ta),
                     w_thr=w[ta])
    else:
        third = dict(n_thr=1, s_thr=0, thr0=0, n_thr_lines=1,
                     zeb_term_first=1, w_thr=0.0)
    col = third["n_thr_lines"]
    per_cta = col * max(1, MIN_LINES // col)
    total = n_zeb_lines * col
    return ZebraLineParams(
        n_line=P[axis], s_line=st[axis], row_lo=1, row_hi=S[axis] - 2,
        n_zeb=P[za], s_zeb=st[za], zeb0=zeb0, n_zeb_lines=n_zeb_lines,
        lines_per_cta=per_cta,
        threads=min(MAX_THREADS, -(-per_cta // 32) * 32),
        ctas=-(-total // per_cta), w_zeb=w[za], **third)


def line_coords(p: ZebraLineParams, cta: int):
    """(zebra coordinates, third coordinates) of CTA `cta`'s lines, as
    the kernel finds them (`line_of`); the layout's tests and plain
    emulation walk them."""
    g = np.arange(cta * p.lines_per_cta, (cta + 1) * p.lines_per_cta)
    g = g[g < p.n_zeb_lines * p.n_thr_lines]
    return p.zeb0 + 2 * (g // p.n_thr_lines), p.thr0 + g % p.n_thr_lines


# -------------------------------------------------------------- plan


class LinePlan:
    """One level's line relaxation on `device`: the problem, level and
    axis, each colour's ZebraLineParams (None: no line of that colour), the
    per-row constants alpha | beta | cp of `stencil.thomas_coefficients`
    as one float32 tensor, the dp scratch of the level's shape, and
    `plain`, the level's plain version."""

    def __init__(self, problem, geom: LevelGeometry, axis: int,
                 device="cpu"):
        if not isinstance(problem, Poisson):
            raise _not_taken(f"problem {problem.name}")
        self.problem, self.geom, self.axis = problem, geom, axis
        self.params = [layout(geom, axis, c) for c in (0, 1)]
        a, b, c, _ = problem.line_rows(axis, geom)
        cp, alpha, beta = stencil.thomas_coefficients(a, b, c)
        self.coef = torch.from_numpy(
            np.concatenate([alpha, beta, cp]).astype(np.float32)).to(device)
        self.scratch = torch.empty(geom.padded_shape, dtype=torch.float32,
                                   device=device)

    @functools.cached_property
    def plain(self) -> ZebraLines:
        """The level's plain zebra relaxation (`cycles.ZebraLines`),
        float32 on the plan's device, made at its first use."""
        return ZebraLines(self.problem, self.geom, self.axis, torch.float32,
                          self.coef.device)

    def launches(self, nsweeps: int) -> int:
        """The kernel's launches for `nsweeps` sweeps: one a colour that
        has lines, a sweep."""
        return nsweeps * sum(p is not None for p in self.params)


# ------------------------------------------------------------ wrapper


def _check(v, f, plan: LinePlan) -> bool:
    for t, what in ((v, "v"), (f, "f")):
        if tuple(t.shape) != tuple(plan.geom.padded_shape):
            raise ValueError(f"{what} shape {tuple(t.shape)} != the "
                             f"level's {plan.geom.padded_shape}")
    on_card = _on_cuda(v, f)
    if plan.coef.device != v.device:
        raise ValueError(f"the plan lives on {plan.coef.device}, the level "
                         f"on {v.device}")
    return on_card


def _launch(v, f, plan: LinePlan, colours, nsweeps: int) -> None:
    """`nsweeps` rounds of one launch a colour in `colours` (those with
    lines), on CUDA tensors the wrapper checked."""
    fn = build.load().lib.pdemg_zebra_line
    args = (v.data_ptr(), f.data_ptr(), plan.scratch.data_ptr(),
            plan.coef.data_ptr())
    ps = [ctypes.byref(plan.params[c]) for c in colours
          if plan.params[c] is not None]
    nd, stream = plan.geom.ndim, _stream()
    for _ in range(nsweeps):
        for p in ps:
            rc = fn(*args, p, nd, stream)
            launches["zebra_line"] += 1
            build.check(rc, "zebra_line")


def zebra_half_sweep(v, f, colour: int, plan: LinePlan):
    """One launch: the colour-`colour` lines of the level solved, v updated
    in place (CPU tensors: the plain half-sweep, copied into v)."""
    if not _check(v, f, plan):
        return v.copy_(plan.plain.half_sweep(v, f, colour))
    _launch(v, f, plan, (colour,), 1)
    return v


def zebra_relax(v, f, nsweeps: int, plan: LinePlan):
    """`nsweeps` zebra sweeps on the level of `plan`, even lines first, v
    updated in place and returned: 2 launches a sweep for CUDA tensors,
    the plain version for CPU tensors."""
    if not _check(v, f, plan):
        return v.copy_(plan.plain.relax(v, f, nsweeps))
    _launch(v, f, plan, (0, 1), nsweeps)
    return v


# -------------------------------------------------------------- tier


class LineKernels(TorchKernels):
    """The plain tensor tier with the line kernel's relax: float32
    `smoother="line-K"` on the card.  Every other op (residual,
    restriction, prolongation, the exact coarsest solve) is the plain op
    on the card, as JAX's `JnpKernels` runs them; every level in
    `relaxed_levels` gets its `LinePlan` here, once, and a level the
    kernel does not take raises here."""

    def __init__(self, problem, geoms, smoother: str, relaxed_levels,
                 device):
        super().__init__(problem, geoms, smoother)
        axis = int(smoother[5:])
        self.plans = [None] * len(self.geoms)
        for l in relaxed_levels:
            self.plans[l] = LinePlan(problem, self.geoms[l], axis, device)

    def relax(self, l, v, f, aux, nsweeps, f_zero=False):
        plan = self.plans[l]
        if plan is None:
            raise _not_taken(f"relax on unplanned level {l}")
        return zebra_relax(v, f, nsweeps, plan)
