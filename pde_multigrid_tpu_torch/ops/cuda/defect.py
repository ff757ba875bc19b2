"""Mixed-precision defect-correction relaxation (float32 iterate, bf16
sweeps of the error equation): the CUDA kernels of `csrc/defect.cu`, their
plain PyTorch versions, and the per-level plan.  The counterpart of the
JAX package's `ops/pallas/defect.py`.

Any linear stationary smoother applied to the error equation equals the
same smoother applied to the iterate:

    S^nu(v; f) == v + S^nu(0; r),   r = f - A v

so one relax leg of nu sweeps becomes

    1. r = m_int * (f - L v) in float32, cast to bf16 and split into color
       halves (`residual_split`, replaces `make_residual_split`);
    2. nu red-black sweeps of A e = r from e = 0, halves stored in bf16 and
       computed in float32 (replaces `relax.make_split_resident_sweeps`):
       one launch a leg with the four halves on chip where they fit
       (`relax.error_leg`: 128^3 and below), else TIMESKEW_T sweeps a
       launch on the wavefront's clusters (`relax.error_timeskew`: 256^3,
       512^3), or a launch a half-sweep where neither fits
       (`relax.error_chain`: 1024^3), as `relax.error_form` says;
    3. v += merge(e) in float32 (`merge_fold`, replaces `make_merge_fold`).

The iterate stays float32, so the solve reaches the same float32 fixed
point; the sweeps move about 6 B per updated point instead of 16.

Each wrapper launches its kernel for CUDA tensors, runs the plain version
for CPU tensors, and raises for anything else; there is no fallback from
a CUDA tensor to the plain version.  `launches` counts kernel launches.
"""

from __future__ import annotations

import torch

from pde_multigrid_tpu_torch.grid import LevelGeometry
from pde_multigrid_tpu_torch.models.poisson import Poisson, inv_h2
from pde_multigrid_tpu_torch.ops.cuda import build
from pde_multigrid_tpu_torch.ops.cuda import relax as relax_mod
from pde_multigrid_tpu_torch.ops.cuda.relax import (
    _check_poisson,
    _halves_shape,
    _on_cuda,
    _stream,
)
from pde_multigrid_tpu_torch.ops.cuda.transfer import (
    _check_level,
    residual_plain,
)

# per-leg sweep thresholds, copied from the JAX package (defect.py:59,
# :101): the chunked TPU inner needs 32 sweeps to cover its fixed passes,
# the all-sweeps-resident one 4.  The port's inner is the resident one's
# counterpart, so its plan carries RESIDENT_MIN_SWEEPS.
MIXED_MIN_SWEEPS = 32
RESIDENT_MIN_SWEEPS = 4

launches = {"residual_split": 0, "merge_fold": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


# ------------------------------------------------------ plain versions


def residual_split_plain(v, f, problem, geom: LevelGeometry,
                         dtype=torch.bfloat16):
    """split(m_int * (f - L v) rounded to `dtype`)."""
    r = residual_plain(v, f, problem, geom).to(dtype)
    return relax_mod.split_colors(r)


def merge_fold_plain(er, eb, v):
    """v + merge(er, eb), the halves widened to float32 (exact)."""
    return v + relax_mod.merge_colors(er.to(torch.float32),
                                      eb.to(torch.float32))


# ------------------------------------------------------------ wrappers


def residual_split(v, f, problem, geom: LevelGeometry):
    """(rr, rb) bf16 (X, Y/2, Z) = split(bf16(m_int * (f - L v)))."""
    _check_level(v, geom, "v")
    _check_level(f, geom, "f")
    X, Y2, Z = _halves_shape(v.shape)
    if not _on_cuda(v, f):
        return residual_split_plain(v, f, problem, geom)
    _check_poisson(problem)
    rr = torch.empty((X, Y2, Z), dtype=torch.bfloat16, device=v.device)
    rb = torch.empty_like(rr)
    w0, w1, w2 = inv_h2(geom)
    rc = build.load().lib.pdemg_residual_split(
        v.data_ptr(), f.data_ptr(), rr.data_ptr(), rb.data_ptr(), X, Y2, Z,
        w0, w1, w2, _stream(),
    )
    launches["residual_split"] += 1
    build.check(rc, "residual_split")
    return rr, rb


def merge_fold(er, eb, v):
    """v + merge(er, eb) in float32, folded in place into `v` (the old
    iterate is dead once its correction is added) and returned."""
    X, Y2, Z = _halves_shape(v.shape)
    if tuple(er.shape) != (X, Y2, Z) or er.shape != eb.shape:
        raise ValueError(
            f"halves {tuple(er.shape)}, {tuple(eb.shape)} do not match "
            f"v {tuple(v.shape)}"
        )
    on_cuda = _on_cuda(er, eb, dtype=torch.bfloat16)
    if _on_cuda(v) != on_cuda:
        raise ValueError(f"halves on {er.device}, v on {v.device}")
    if not on_cuda:
        return v.copy_(merge_fold_plain(er, eb, v))
    rc = build.load().lib.pdemg_merge_fold(
        er.data_ptr(), eb.data_ptr(), v.data_ptr(), X, Y2, Z, _stream()
    )
    launches["merge_fold"] += 1
    build.check(rc, "merge_fold")
    return v


# ---------------------------------------------------------------- plan


def plan_defect_relax(problem, geom: LevelGeometry, dtype):
    """relax(v, f, nsweeps) -> v through the bf16 defect correction, or
    None where the level is outside its structural conditions (float32,
    3D wrap storage, a Poisson problem, whose split_update_folded and
    kernel_operator the kernels compute, even extents).
    `relax.min_sweeps` is the leg length from which the caller should
    take it (`dispatch.CudaKernels.relax`), `relax.form` the error-sweep
    kernel `relax.error_form` gives the level ("leg", "wavefront", or
    "chain" where neither fits) and `relax.launches(nsweeps)` its
    launches a leg.

    The JAX planner's TPU gates are dropped: the VMEM tier test
    (defect.py:270-274; on the TPU a level small enough to sit in VMEM
    keeps the f32 resident relax), the lane/sublane conditions
    `Z % 128`, `Y2 % 16`, and the chunked and 2D-blocked inner fallbacks
    (:321-366).  So a 256^3 level takes this path here, where the JAX
    package keeps it in float32 for a VMEM reason (defect.py:67-73)."""
    if dtype != torch.float32:
        return None
    if not (geom.wrap and geom.ndim == 3 and isinstance(problem, Poisson)):
        return None
    if any(n % 2 for n in geom.padded_shape):
        return None
    form = relax_mod.error_form(geom)
    sweeps = relax_mod.ERROR_SWEEPS[form]

    def relax(v, f, nsweeps: int):
        rr, rb = residual_split(v, f, problem, geom)
        er, eb = sweeps(rr, rb, nsweeps, problem, geom)
        return merge_fold(er, eb, v)

    relax.min_sweeps = RESIDENT_MIN_SWEEPS
    relax.form = form
    relax.launches = lambda nsweeps: relax_mod.error_launches(form, nsweeps)
    return relax
