"""The 3D FAS slice of the port: 3D Poisson in wrap storage in the full
approximation scheme, relaxed to 2^3, against the JAX package's jnp tier.

On the card every level relaxes by the plan of `CudaKernels` (the
wavefront on 256^3, the half-sweeps on 128^3, the whole-leg resident
kernel on 64^3 ... 2^3, `ops/cuda/resident3d.py`); here the same plan
runs on CPU tensors, its wrappers taking their plain versions.

  * FMG(2, 3, 3), FAS, coarsest relaxed, then a V-cycle, at 33^3 through
    `CudaKernels` (float32, the dtype its wrappers take) against JAX's
    `backend="jnp"` solve from the same levels: the per-cycle residual
    history and the logical solution within a few float32 ulp of the
    solution's scale;
  * the same schedule in float64 through the plain tier against JAX jnp
    to 1e-12 (what the kernels' arithmetic must reproduce at full
    precision);
  * the CLI, `--scheme fas --coarsest relax --device cpu --n 17`.
"""

import io
import json
from contextlib import redirect_stdout

import numpy as np
import torch

import pde_multigrid_tpu as J
from pde_multigrid_tpu_torch import CycleConfig, MultigridSolver, SolverConfig
from pde_multigrid_tpu_torch.__main__ import main as cli_main
from pde_multigrid_tpu_torch.cycles import CycleProgram
from pde_multigrid_tpu_torch.grid import to_logical
from pde_multigrid_tpu_torch.models import Poisson as TPoisson
from pde_multigrid_tpu_torch.ops.cuda import relax as R
from pde_multigrid_tpu_torch.ops.cuda import resident3d as RS3
from pde_multigrid_tpu_torch.ops.cuda.dispatch import CudaKernels
from pde_multigrid_tpu_torch.utils.convert import levels_from_numpy

CYC = dict(kind="fmg", nu0=2, nu1=3, nu2=3, scheme="fas", coarsest="relax")


def _pair(n, dtype, tier=None):
    """(JAX result, port result, port solver, JAX solver) of one FMG step
    of CYC and one V-cycle at n^3 from the same levels; `tier` replaces
    the port's kernel tier."""
    js = J.MultigridSolver(J.Poisson3D(), n, J.SolverConfig(
        cycle=J.CycleConfig(**CYC), backend="jnp", dtype=dtype,
        max_cycles=2, tol=0.0))
    ts = MultigridSolver(TPoisson(3), n, SolverConfig(
        cycle=CycleConfig(**CYC), dtype=dtype, max_cycles=2, tol=0.0),
        device="cpu")
    if tier is not None:
        ts.program = CycleProgram(ts.problem, ts.geoms, ts.config.cycle,
                                  tier(ts))
    jl = js.fresh_levels()
    arrays = [{"v": np.asarray(l.v), "f": np.asarray(l.f),
               "aux": {k: np.asarray(a) for k, a in l.aux.items()}}
              for l in jl]
    tl = levels_from_numpy(ts.geoms, arrays, dtype=ts.dtype)
    return js.solve_to_tolerance(jl), ts.solve_to_tolerance(tl), ts, js


def test_fas_fmg_through_the_cuda_plan_matches_jax_jnp():
    """33^3 through CudaKernels on CPU tensors: every level relaxed by the
    resident kernel's plain version (merged_resident on 32^3 and 16^3,
    resident3d on 8^3 ... 2^3), the transfers' plain versions, FAS's
    injection and coarse right side as plain ops.  Against JAX jnp in
    float32: the logical solution within 1e-5 of max|v| and the residual
    history and error_linf to 1e-4 relative (the two round the update's
    constants and XLA contracts products into FMAs: a few ulp a sweep)."""
    calls = []
    plain = RS3.merged_resident_plain

    def counted(v, f, ns, problem, geom):
        calls.append(geom.padded_shape[0])
        return plain(v, f, ns, problem, geom)

    RS3.merged_resident_plain = counted
    try:
        jr, tr, ts, js = _pair(33, "float32", lambda s: CudaKernels(
            s.problem, s.geoms, torch.float32))
    finally:
        RS3.merged_resident_plain = plain
    assert ts.program.kernels.tiers == ["merged_resident"] * 2 + [
        "resident3d"] * 3
    # two legs (nu1, nu2) a visit of every level, the coarsest too; the
    # FMG step visits level l nu0 (l + 1) times, the V-cycle after it once
    assert {s: calls.count(s) for s in set(calls)} == {
        32 >> l: 2 * (CYC["nu0"] * (l + 1) + 1) for l in range(5)}
    a = to_logical(np.asarray(jr.v), js.geoms[0])
    b = to_logical(tr.v, ts.geoms[0])
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-5 * np.abs(a).max())
    np.testing.assert_allclose(tr.residual_history, jr.residual_history,
                               rtol=1e-4)
    np.testing.assert_allclose(tr.error_linf, jr.error_linf, rtol=1e-4)
    h = ts.geoms[0].spacing[0]
    assert tr.error_linf < 50 * h * h
    assert not any(R.launches.values()) and not any(RS3.launches.values())


def test_fas_fmg_float64_matches_jax_jnp():
    """The same schedule in float64 (the plain tier: the CUDA tier takes
    float32 only) against JAX jnp: the residual history and the logical
    solution to 1e-12 relative."""
    jr, tr, ts, js = _pair(33, "float64")
    assert type(ts.program.kernels).__name__ == "TorchKernels"
    a = to_logical(np.asarray(jr.v), js.geoms[0])
    b = to_logical(tr.v, ts.geoms[0])
    assert b.dtype == np.float64
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-12 * np.abs(a).max())
    np.testing.assert_allclose(tr.residual_history, jr.residual_history,
                               rtol=1e-12)


def test_cli_fas_relax_coarsest():
    """`--scheme fas --coarsest relax --device cpu --n 17` FMG(2, 3, 3):
    one JSON line, the FAS scheme, converged under 50 h^2."""
    buf = io.StringIO()
    with redirect_stdout(buf):
        cli_main(["--n", "17", "--nu0", "2", "--nu1", "3", "--nu2", "3",
                  "--scheme", "fas", "--coarsest", "relax", "--device",
                  "cpu", "--cycles", "2"])
    out = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert out["cycle"]["scheme"] == "fas"
    assert out["cycle"]["coarsest"] == "relax"
    assert out["cycles_run"] == 2 and not out["diverged"]
    assert out["error_linf"] < 50 * (1.0 / 16) ** 2
    assert out["residual_history"][-1] < out["residual_history"][0]
