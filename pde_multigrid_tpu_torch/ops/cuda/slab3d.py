"""Red-black Gauss-Seidel on large 3D Poisson levels in padded storage,
one colour half-sweep a launch: the CUDA kernel of `csrc/slab3d.cu` and
its plain PyTorch version.

Replaces the TPU kernel `pde_multigrid_tpu/ops/pallas/relax.py`
`make_slab_relax` (row 3) on 3D padded Poisson levels, on the levels the
whole-leg kernel (`ops/cuda/padded3d.py`, row 1's padded form) does not
hold: 129^3, 257^3 and 513^3 on a cubic hierarchy.  JAX's kernel runs T
sweeps of `_sweeps` (relax.py:129-137) a call on x slabs with 2T-plane
halos, and only where its VMEM budget takes a slab (65^3, 129^3; 257^3 and
513^3 run its jnp tier).  Here T = 1 and a sweep is two launches: the red
half-sweep v + m (kernel_update(v, f) - v) at every point from v into a
scratch array, then the black one from the scratch back into v (a thread
a point, blockIdx.y the x plane).  `padded3d.half_sweep_plain` is its
plain version; a launch is bitwise it.

Bytes: 12 a point a sweep (v and f read, v written), its byte bound:
0.484 ms a sweep at 513^3 at 3.35 TB/s; the two launches move 24.

The wrapper launches the kernel for CUDA tensors, runs the plain version
for CPU tensors, and raises for anything else; there is no fallback from
a CUDA tensor to the plain version.  v is updated in place on both
devices.
"""

from __future__ import annotations

import ctypes

import torch

from pde_multigrid_tpu_torch.grid import LevelGeometry
from pde_multigrid_tpu_torch.ops.cuda import build
from pde_multigrid_tpu_torch.ops.cuda.padded3d import (
    check_level,
    half_sweep_plain,
    poisson3d_params,
    sweeps_plain,
)
from pde_multigrid_tpu_torch.ops.cuda.relax import _on_cuda, _stream

launches = {"slab3d": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def half_sweep(v, f, out, colour: int, problem, geom: LevelGeometry):
    """One colour (0 red, 1 black) of `_sweeps` from v into out (one
    launch; out must not alias v); f None is the f-less form."""
    on_cuda = check_level(v, f, 1, problem, geom, "slab3d")
    if (_on_cuda(out) != on_cuda or tuple(out.shape) != tuple(v.shape)
            or out.data_ptr() == v.data_ptr()):
        raise ValueError("slab3d: out must be a tensor like v, apart from it")
    if colour not in (0, 1):
        raise ValueError(f"slab3d: colour {colour}")
    if not on_cuda:
        return out.copy_(half_sweep_plain(v, f, colour, problem, geom))
    params = poisson3d_params(geom)
    rc = build.load().lib.pdemg_slab3d(
        v.data_ptr(), None if f is None else f.data_ptr(), out.data_ptr(),
        colour, ctypes.byref(params), _stream())
    launches["slab3d"] += 1
    build.check(rc, "slab3d")
    return out


def slab3d_relax(v, f, nsweeps: int, problem, geom: LevelGeometry,
                 scratch=None):
    """`nsweeps` sweeps on the padded level v in place, two launches a
    sweep: red from v into `scratch` (a tensor like v; allocated where
    None), black from it back into v; f None is the f-less leg."""
    if not check_level(v, f, nsweeps, problem, geom, "slab3d"):
        return v.copy_(sweeps_plain(v, f, nsweeps, problem, geom))
    if nsweeps < 1:
        return v
    tmp = torch.empty_like(v) if scratch is None else scratch
    for _ in range(nsweeps):
        half_sweep(v, f, tmp, 0, problem, geom)
        half_sweep(tmp, f, v, 1, problem, geom)
    return v
