"""Whole-leg red-black Gauss-Seidel on 1D levels: the CUDA kernel of
`csrc/relax1d.cu` and its plain PyTorch version.

Replaces the TPU kernels `pde_multigrid_tpu/ops/pallas/relax.py`
`make_split_resident_relax_1d` (Ode1D, padded storage) and the 1D branch of
`make_resident_relax` (Poisson(1), wrap storage): all sweeps of a relax leg
in one launch, the level held in registers for the whole leg (`layout`
says how, and whether a level fits): one warp on a level of at most 512
points, else units of one warp each with halos of 2T points (east only
for Ode1D, both sides for Poisson) refreshed every T sweeps, on one CTA
or a cluster of up to 16.  The update is the Pallas kernels'
`v + m * (kernel_update - v)`, red (even index) then black: Ode1D's
`east * a_e + f * a_f`, with a_e and a_f from the model's
`kernel_precompute` (computed once per level and device, and read by the
kernel and the plain version alike), and Poisson's
`(-f + (west + east) * w) * inv_den`.

The wrapper launches the kernel for CUDA tensors, runs the plain version
for CPU tensors, and raises for anything else; there is no fallback from
a CUDA tensor to the plain version.  `launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from pde_multigrid_tpu_torch.grid import LevelGeometry, base_aux
from pde_multigrid_tpu_torch.models.ode1d import Ode1D
from pde_multigrid_tpu_torch.models.poisson import Poisson, split_constants
from pde_multigrid_tpu_torch.ops.cuda import build
from pde_multigrid_tpu_torch.ops.cuda.relax import _on_cuda, _stream
from pde_multigrid_tpu_torch.ops.cuda.subtree import check_cluster

launches = {"relax1d": 0}

# csrc/relax1d.cu's constants: the points of each colour a lane may hold
# (its template instances; K = 4 ran slower than K = 8 on an H100 on
# every level it would serve, PERF.md, Findings), the largest cluster,
# the warps a CTA may run
K_CHOICES = (1, 2, 8)
MAX_CTAS = 16
MAX_WARPS = 16
# the layout's choices for levels one warp does not hold, measured on an
# H100 (PERF.md, Findings): points of each colour a lane, the halo points
# a unit holds, its sides together (half its 512-point span: 2T a side,
# so T = 128 for Ode1D, 64 for Poisson), and warps a CTA (a level of at
# most that many units runs on one CTA, block barriers; a larger one on
# a cluster)
UNIT_K = 8
UNIT_HALO = 256
UNIT_WARPS = 2


class Relax1DLayout(ctypes.Structure):
    """The kernel's `Relax1DLayout` (csrc/relax1d.cu): the level (stored
    points N, the last interior index, points held E: N + 1 in wrap
    storage, whose point N is point 0), CTAs and warps a CTA (a unit
    each), points of each colour a lane K, sweeps between refreshes T
    (0: one unit, no halo), owned points a unit B and its halo points
    west and east, threads a CTA and shared memory bytes."""

    _fields_ = [(name, ctypes.c_int)
                for name in ("N", "last", "E", "nctas", "wpc", "K", "T", "B",
                             "HW", "HE", "threads", "smem_bytes")]

    def as_dict(self) -> dict:
        return {name: getattr(self, name) for name, _ in self._fields_}


class Poisson1DParams(ctypes.Structure):
    """The Poisson constants as the kernel's `Poisson1D` struct: folded in
    double (`split_constants`), rounded once to float32 here."""

    _fields_ = [("w", ctypes.c_float), ("inv_den", ctypes.c_float)]


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _layout(N: int, last: int, wrap: bool, two_sided: bool, K: int,
            T: int, wpc: int):
    """The Relax1DLayout of a level of N stored points (`last` the last
    interior index): T = 0, one warp of K points of each colour a lane,
    which must hold the level; else units of K with halos of 2T points
    (both sides where `two_sided`) on one CTA where the units fit `wpc`
    warps, else on a cluster of CTAs of `wpc` warps (more where MAX_CTAS
    CTAs need them).  None where the kernel cannot take it."""
    E = N + 1 if wrap else N
    span = 64 * K
    if T == 0:
        if E > span:
            return None
        return Relax1DLayout(N, last, E, 1, 1, K, 0, span, 0, 0, 32, 0)
    halo = 2 * T
    HW = halo if two_sided else 0
    B = span - HW - halo
    if halo % (2 * K) or B < halo:
        return None
    units = -(-E // B)
    if units <= wpc:
        nctas, wpc = 1, units
    else:
        wpc = max(wpc, -(-units // MAX_CTAS))
        nctas = -(-units // wpc)
    if wpc > MAX_WARPS:
        return None
    return Relax1DLayout(N, last, E, nctas, wpc, K, T, B, HW, halo,
                         32 * wpc, 4 * wpc * 4 * halo)


@functools.lru_cache(maxsize=64)
def layout(geom: LevelGeometry, problem):
    """The kernel's layout of a 1D level for `problem` (Ode1D reads the
    east neighbour alone, so its halo is east only; Poisson(1) reads both
    sides): one warp, the smallest K that holds the level, where one warp
    can (512 points); else units of UNIT_K with UNIT_HALO halo points (T
    = 128 for Ode1D, 64 for Poisson; halved until the cluster holds the
    level), UNIT_WARPS a CTA (more where 16 CTAs need them).  None where the level is not 1D or the
    cluster cannot hold it.  Cached per level and problem: the wrapper
    asks at every launch."""
    if geom.ndim != 1 or geom.padded_shape[0] < 2:
        return None
    (N,) = geom.padded_shape
    last = geom.shape[0] - 2  # the last interior index, both storages
    two_sided = not isinstance(problem, Ode1D)
    for K in K_CHOICES:
        lay = _layout(N, last, geom.wrap, two_sided, K, 0, 1)
        if lay is not None:
            return lay
    # UNIT_HALO halo points, or fewer where the cluster cannot hold the
    # level so (a side's 2T, whole lanes of 2K points)
    T = UNIT_HALO // (4 if two_sided else 2)
    while T >= UNIT_K:
        lay = _layout(N, last, geom.wrap, two_sided, UNIT_K, T, UNIT_WARPS)
        if lay is not None:
            return lay
        T //= 2
    return None


def _check_problem(problem, geom: LevelGeometry) -> None:
    if isinstance(problem, Ode1D):
        return
    if isinstance(problem, Poisson) and problem.ndim == 1:
        return
    raise TypeError(
        "the relax1d kernel implements the Ode1D and 1D Poisson updates; "
        f"got {type(problem).__name__} ({geom.ndim}D)"
    )


@functools.lru_cache(maxsize=64)
def _plain_fields(problem, geom: LevelGeometry, dtype, device):
    """(m_red, m_black, pre) in `dtype` on `device`; in float32 `pre`
    holds Ode1D's a_e and a_f, the very tensors the kernel reads."""
    aux = base_aux(geom, dtype, device)
    pre = problem.kernel_precompute(geom.coords(dtype, device), geom, dtype)
    pre = {k: t.contiguous() for k, t in pre.items()}
    return aux["m_red"], aux["m_black"], pre


def relax1d_plain(v, f, nsweeps: int, problem, geom: LevelGeometry):
    """`nsweeps` red-black sweeps in place on v in the Pallas kernels' form
    (relax.py:129-137): v += m_color * (kernel_update(v, f) - v)."""
    m_red, m_black, pre = _plain_fields(problem, geom, v.dtype, v.device)
    for _ in range(nsweeps):
        v.add_(m_red * (problem.kernel_update(v, f, pre, geom) - v))
        v.add_(m_black * (problem.kernel_update(v, f, pre, geom) - v))
    return v


def relax1d(v, f, nsweeps: int, problem, geom: LevelGeometry):
    """`nsweeps` red-black sweeps in place on v (one launch)."""
    if geom.ndim != 1 or tuple(v.shape) != tuple(geom.padded_shape):
        raise ValueError(
            f"v {tuple(v.shape)} does not match 1D level {geom.padded_shape}"
        )
    if f is None or f.shape != v.shape:
        raise ValueError("the 1D relax takes f of v's shape")
    _check_problem(problem, geom)
    if not _on_cuda(v, f):
        return relax1d_plain(v, f, nsweeps, problem, geom)
    lay = layout(geom, problem)
    if lay is None:
        raise ValueError(
            f"level {geom.padded_shape} does not fit the relax1d kernel "
            f"({MAX_CTAS} CTAs of {MAX_WARPS} warps)"
        )
    if nsweeps < 1:
        return v
    lib = build.load().lib
    ode = isinstance(problem, Ode1D)
    if lay.nctas > 1:
        check_cluster(
            lambda g, n: lib.pdemg_relax1d_clusters(g, int(not ode), n),
            lay, (lay.nctas, lay.threads, lay.smem_bytes),
            f"relax1d {'ode' if ode else 'poisson'} K = {lay.K}")
    if ode:
        _, _, pre = _plain_fields(problem, geom, v.dtype, v.device)
        rc = lib.pdemg_relax1d_ode(
            v.data_ptr(), f.data_ptr(), pre["a_e"].data_ptr(),
            pre["a_f"].data_ptr(), nsweeps, ctypes.byref(lay), _stream(),
        )
    else:
        w, inv_den = split_constants(geom)
        params = Poisson1DParams(w[0], inv_den)
        rc = lib.pdemg_relax1d_poisson(
            v.data_ptr(), f.data_ptr(), nsweeps, ctypes.byref(lay),
            ctypes.addressof(params), _stream(),
        )
    launches["relax1d"] += 1
    build.check(rc, "relax1d")
    return v
