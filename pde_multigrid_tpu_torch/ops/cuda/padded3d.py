"""Whole-leg red-black Gauss-Seidel on small 3D Poisson levels in padded
storage (a nonzero Dirichlet boundary): the CUDA kernel of
`csrc/padded3d.cu`, the plain PyTorch version of the sweeps, and the
layout that says which levels the kernel holds.

Replaces the TPU kernel `pde_multigrid_tpu/ops/pallas/relax.py`
`make_resident_relax` (row 1) on 3D padded Poisson levels: all sweeps of
a relax leg in one launch, the level on chip for the whole leg.  The
function is `_sweeps` (relax.py:129-137) with `_coords_and_masks`' masks:
per sweep, red (x + y + z even) then black, every point of the level
becomes v + m (kernel_update(v, f) - v), m the colour's interior mask
(1 .. n - 2 on every axis); the boundary values are read and never change.
`sweeps_plain` computes exactly that with torch.roll; the kernel computes
it from the global index with the operations in the same order, so the
two agree bit for bit on the card.

Design (csrc/padded3d.cu): the level's x planes over one cluster of up to
16 CTAs (one CTA on levels of at most ONE_CTA_MAX_POINTS points), each
holding two copies of its planes of v in shared memory, a half-sweep
reading one and writing the other, then one cluster barrier; the x
neighbours past a CTA's planes are read from the neighbouring CTA's copy
through distributed shared memory; a thread's f for the whole leg in
registers.  Bytes a point a leg: 12 (v read and written, f read); the
bound is the operations (13 an interior point and sweep) on paper, the
2 nsweeps dependent half-sweeps on the card.

`leg_layout` is the capacity gate: 65^3 ... 3^3 on a cubic hierarchy (JAX
gives 65^3 its slab kernel, the VMEM budget; the levels it does not hold
go to `ops/cuda/slab3d.py`, row 3's padded form).  The wrapper launches the
kernel for CUDA tensors, runs the plain version for CPU tensors, and raises
for anything else; there is no fallback from a CUDA tensor to the plain
version.  v is updated in place on both devices.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from pde_multigrid_tpu_torch.grid import LevelGeometry
from pde_multigrid_tpu_torch.models.poisson import split_constants
from pde_multigrid_tpu_torch.ops.cuda import build
from pde_multigrid_tpu_torch.ops.cuda import relax as R
from pde_multigrid_tpu_torch.ops.cuda.relax import (
    _check_poisson,
    _on_cuda,
    _stream,
)
from pde_multigrid_tpu_torch.ops.cuda.subtree import check_cluster

launches = {"padded3d": 0}

MAX_CTAS = 16
MAX_THREADS = 1024
MAX_SMEM_BYTES = 232448
# a level of at most this many points lives on one CTA (block barriers)
ONE_CTA_MAX_POINTS = 1024
# the kernel's template instances (most planes a CTA, most points of a
# plane a thread): the smallest that fits is launched
LEG_INSTANCES = ((2, 1), (3, 2), (5, 5), (9, 1))


class Poisson3DParams(ctypes.Structure):
    """csrc/poisson3d.cuh `Poisson3D`."""

    _fields_ = [(n, ctypes.c_float) for n in ("w0", "w1", "w2", "inv_den")]
    _fields_ += [(n, ctypes.c_int) for n in ("nx", "ny", "nz")]


class Padded3DLayout(ctypes.Structure):
    """csrc/padded3d.cu `Padded3DLayout`."""

    _fields_ = [(n, ctypes.c_int) for n in
                ("nctas", "threads", "planes", "slots", "pm", "jm",
                 "smem_bytes")]


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def padded_3d(geom: LevelGeometry) -> bool:
    """A 3D level in padded storage stored unpadded (the port's storage:
    the kernels take the level's own extents)."""
    return (geom.ndim == 3 and not geom.wrap
            and tuple(geom.padded_shape) == tuple(geom.shape))


def poisson3d_params(geom: LevelGeometry) -> Poisson3DParams:
    """The kernels' constants: split_constants rounded to float32 once,
    and the extents."""
    (w0, w1, w2), inv_den = split_constants(geom)
    return Poisson3DParams(w0, w1, w2, inv_den, *geom.shape)


@functools.lru_cache(maxsize=None)
def leg_layout(geom: LevelGeometry):
    """The kernel's layout of the level (`Padded3DLayout`), or None where
    it cannot hold it: one CTA on at most ONE_CTA_MAX_POINTS points, else
    min(MAX_CTAS, X) CTAs; a thread a point of each plane, ceil(Y Z /
    MAX_THREADS) slots of a plane a thread; two copies of a CTA's
    ceil(X / nctas) planes within MAX_SMEM_BYTES, and an instance of
    LEG_INSTANCES holding its planes and slots."""
    if not padded_3d(geom):
        return None
    X, Y, Z = geom.shape
    if min(X, Y, Z) < 3:
        return None
    yz = Y * Z
    nctas = 1 if X * yz <= ONE_CTA_MAX_POINTS else min(MAX_CTAS, X)
    slots = -(-yz // MAX_THREADS)
    threads = (-(-yz // slots) + 31) // 32 * 32
    planes = -(-X // nctas)
    smem = 8 * planes * yz
    fit = [(pm, jm) for pm, jm in LEG_INSTANCES
           if pm >= planes and jm >= slots]
    if smem > MAX_SMEM_BYTES or not fit:
        return None
    pm, jm = min(fit, key=lambda t: t[0] * t[1])
    return Padded3DLayout(nctas, threads, planes, slots, pm, jm, smem)


def fits(geom: LevelGeometry) -> bool:
    """Whether the kernel holds the level."""
    return leg_layout(geom) is not None


# ------------------------------------------------------ plain version


@R._cached
def masks(X: int, Y: int, Z: int, dtype, device):
    """(m_red, m_black) (X, Y, Z) of `dtype`: the interior 1 .. n - 2 of
    every axis, of parity x + y + z even / odd (relax.py:92-127), built on
    the device (a CUDA graph capture may call it)."""
    x = torch.arange(X, device=device)[:, None, None]
    y = torch.arange(Y, device=device)[None, :, None]
    z = torch.arange(Z, device=device)[None, None, :]
    interior = ((x >= 1) & (x <= X - 2) & (y >= 1) & (y <= Y - 2)
                & (z >= 1) & (z <= Z - 2))
    par = (x + y + z) % 2
    return (((par == 0) & interior).to(dtype),
            ((par == 1) & interior).to(dtype))


def half_sweep_plain(v, f, colour: int, problem, geom: LevelGeometry):
    """One colour (0 red, 1 black) of `_sweeps`: v + m (kernel_update(v, f)
    - v) at every point, a new tensor; f None drops the RHS term."""
    m = masks(*v.shape, v.dtype, v.device)[colour]
    return v + m * (problem.kernel_update(v, f, {}, geom) - v)


def sweeps_plain(v, f, nsweeps: int, problem, geom: LevelGeometry):
    """`nsweeps` sweeps of `_sweeps` (red, then black) as the Pallas
    `make_resident_relax` and `make_slab_relax` compute them on a 3D
    padded level; a new tensor, the inputs are not written.  In any float
    dtype, on any device."""
    for _ in range(nsweeps):
        v = half_sweep_plain(v, f, 0, problem, geom)
        v = half_sweep_plain(v, f, 1, problem, geom)
    return v


# ------------------------------------------------------------ wrapper


def check_level(v, f, nsweeps: int, problem, geom: LevelGeometry,
                what: str) -> bool:
    """The operands, the problem and the level, checked before a leg; True
    for CUDA tensors (`relax._on_cuda`)."""
    _check_poisson(problem)
    if not padded_3d(geom):
        raise ValueError(f"{what} serves 3D padded levels stored unpadded; "
                         f"got {geom}")
    ts = (v,) if f is None else (v, f)
    if any(tuple(t.shape) != tuple(geom.shape) for t in ts):
        raise ValueError(f"{what}: operands {[tuple(t.shape) for t in ts]}, "
                         f"level {tuple(geom.shape)}")
    if nsweeps < 0:
        raise ValueError(f"nsweeps {nsweeps}")
    return _on_cuda(*ts)


def padded3d_relax(v, f, nsweeps: int, problem, geom: LevelGeometry):
    """`nsweeps` sweeps on the padded level v in place, one launch; f None
    is the f-less leg."""
    lay = leg_layout(geom)
    if lay is None:
        raise ValueError(
            f"level {geom.padded_shape} does not fit the padded leg kernel "
            f"({MAX_CTAS} CTAs of {MAX_SMEM_BYTES} B of shared memory): "
            "the slab kernel's level (ops/cuda/slab3d.py)")
    if not check_level(v, f, nsweeps, problem, geom, "padded3d"):
        return v.copy_(sweeps_plain(v, f, nsweeps, problem, geom))
    if nsweeps < 1:
        return v
    params = poisson3d_params(geom)
    lib = build.load().lib
    if lay.nctas > 1:
        check_cluster(
            lambda lp, c: lib.pdemg_padded3d_clusters(
                lp, ctypes.byref(params), c),
            lay, (lay.nctas, lay.threads, lay.smem_bytes), "padded3d")
    rc = lib.pdemg_padded3d(
        v.data_ptr(), None if f is None else f.data_ptr(), nsweeps,
        ctypes.byref(lay), ctypes.byref(params), _stream())
    launches["padded3d"] += 1
    build.check(rc, "padded3d")
    return v
