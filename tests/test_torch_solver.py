"""Port parity of the whole slice: the port's MultigridSolver on the CPU
against the JAX MultigridSolver(backend="jnp"), both started from
identical level state (carried across with utils/convert.py), in float32
(the slice's dtype) and in float64.

Tolerances:
  * final v (logical arrays): 1e-5 of max|v| — a few float32 ulp;
  * error_linf against the analytic solution: rtol 1e-4;
  * residual history: rtol 1e-4, except with coarsest="exact" in float32.
    With coarsest="relax" the port repeats the JAX arithmetic step for
    step (the residual norms differ only in summation order).  The exact
    coarse solve's float32 contractions sum in another order (XLA's dot
    vs torch's matmul), so v moves by an ulp; in float32 the residual is
    already at the rounding floor after the FMG step and moves by several
    percent (5.4% seen at 17^3), so rtol 1e-1 there.  In float64 the
    same float32 contractions leave the residual 1e-4-close (2e-5 seen
    at 33^3), which holds the exact path to the tight tolerance.
"""

import dataclasses
import importlib.util
import io
import json
import pathlib
import re
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

import pde_multigrid_tpu as J
import pde_multigrid_tpu_torch as T
from pde_multigrid_tpu_torch.__main__ import main as cli_main
from pde_multigrid_tpu_torch.grid import to_logical
from pde_multigrid_tpu_torch.utils.convert import (
    levels_from_numpy,
    levels_to_numpy,
)
from pde_multigrid_tpu_torch.utils.updates import count_smoother_updates

ROOT = pathlib.Path(__file__).resolve().parents[1]
# residual-history rtol by (coarsest, dtype); see the module docstring.
# float64 runs only the exact case: with coarsest="relax" float32 already
# meets the tight tolerance.
HIST_RTOL = {
    ("exact", "float32"): 1e-1,
    ("relax", "float32"): 1e-4,
    ("exact", "float64"): 1e-4,
}


def _solvers(n, coarsest, dtype="float32"):
    cyc = dict(kind="fmg", nu0=2, nu1=4, nu2=4, coarsest=coarsest)
    js = J.MultigridSolver(
        J.Poisson3D(), n,
        J.SolverConfig(cycle=J.CycleConfig(**cyc), backend="jnp",
                       max_cycles=3, tol=0.0, dtype=dtype),
    )
    ts = T.MultigridSolver(
        T.Poisson3D(), n,
        T.SolverConfig(cycle=T.CycleConfig(**cyc), max_cycles=3, tol=0.0,
                       dtype=dtype),
        device="cpu",
    )
    return js, ts


def _same_state(js, ts):
    jl = js.fresh_levels()
    arrays = [
        {"v": np.asarray(l.v), "f": np.asarray(l.f),
         "aux": {k: np.asarray(a) for k, a in l.aux.items()}}
        for l in jl
    ]
    return jl, levels_from_numpy(ts.geoms, arrays, dtype=ts.dtype)


def _check(jr, tr, js, ts, coarsest, dtype):
    a = to_logical(np.asarray(jr.v), js.geoms[0])
    b = to_logical(tr.v, ts.geoms[0])
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-5 * np.abs(a).max())
    np.testing.assert_allclose(tr.error_linf, jr.error_linf, rtol=1e-4)
    assert tr.cycles_run == jr.cycles_run
    assert len(tr.residual_history) == len(jr.residual_history)
    np.testing.assert_allclose(tr.residual_history, jr.residual_history,
                               rtol=HIST_RTOL[coarsest, dtype])


@pytest.mark.parametrize("coarsest,dtype", list(HIST_RTOL))
@pytest.mark.parametrize("n", [17, 33])
def test_fmg_slice_matches_jax(n, coarsest, dtype):
    js, ts = _solvers(n, coarsest, dtype)
    assert [g.padded_shape for g in ts.geoms] == [
        g.padded_shape for g in js.geoms]
    jl, tl = _same_state(js, ts)
    assert tl[0].v.dtype == getattr(torch, dtype)
    assert np.asarray(jl[0].v).dtype == np.dtype(dtype)
    _check(js.solve(jl), ts.solve(tl), js, ts, coarsest, dtype)
    jl, tl = _same_state(js, ts)
    jr, tr = js.solve_to_tolerance(jl), ts.solve_to_tolerance(tl)
    assert len(tr.residual_history) == 3
    _check(jr, tr, js, ts, coarsest, dtype)
    assert not tr.diverged
    # converged to discretization accuracy, as the bench checks it
    h = ts.geoms[0].spacing[0]
    assert tr.error_linf < 50 * h * h


def test_fresh_state_and_defaults_match_jax():
    """Without carried-over state the port builds its own levels; the
    solution still agrees with JAX to float32 sin rounding."""
    js, ts = _solvers(17, "exact")
    jr, tr = js.solve(), ts.solve()
    np.testing.assert_allclose(tr.error_linf, jr.error_linf, rtol=1e-3)
    assert ts.compile_time_s == 0.0 and tr.compile_time_s == 0.0
    assert len(ts.geoms) == len(js.geoms) == 2


def test_convert_round_trip():
    js, ts = _solvers(17, "relax")
    jl, tl = _same_state(js, ts)
    back = levels_to_numpy(tl)
    for a, b in zip(jl, back):
        np.testing.assert_array_equal(b["v"], np.asarray(a.v))
        np.testing.assert_array_equal(b["f"], np.asarray(a.f))
        assert set(b["aux"]) == set(a.aux)
    with pytest.raises(ValueError):
        levels_from_numpy(ts.geoms[:1], back)
    bad = [dict(x, v=x["v"][:1]) for x in back]
    with pytest.raises(ValueError):
        levels_from_numpy(ts.geoms, bad)


def test_divergence_guard():
    """A NaN in the state stops solve_to_tolerance and reports it."""
    _, ts = _solvers(17, "relax")
    lv = ts.fresh_levels()
    lv[0].f[3, 3, 3] = float("nan")
    res = ts.solve_to_tolerance(lv)
    assert res.diverged and res.cycles_run == 1


def test_solver_rejects_what_the_slice_lacks():
    # a mesh solve outside the sharded slice (3D wrap Poisson) names its
    # item: 1D levels are queue 1 item 17
    from pde_multigrid_tpu_torch.parallel.mesh import make_mesh

    with pytest.raises(NotImplementedError, match="queue 1 item 17"):
        T.MultigridSolver(T.Poisson(1), 17, device="cpu",
                          mesh=make_mesh(1, device="cpu"))
    with pytest.raises(ValueError):
        T.MultigridSolver(T.Poisson3D(), 17, device="meta")
    # an exact coarsest level of padded storage takes the dense probed
    # inverse; one too big for it has no direct solve
    padded = T.SolverConfig(storage="padded",
                            cycle=T.CycleConfig(coarsest="exact"))
    assert T.MultigridSolver(T.Poisson3D(), 17, padded,
                             device="cpu").geoms[-1].shape == (9, 9, 9)
    with pytest.raises(ValueError, match="no direct solve"):
        T.MultigridSolver(T.Poisson3D(), 33,
                          dataclasses.replace(padded, num_levels=1),
                          device="cpu")


def test_cuda_device_is_never_silently_replaced():
    """Asking for "cuda" without a GPU raises; there is no CPU fallback."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; this checks the GPU-less refusal")
    with pytest.raises(RuntimeError, match="CUDA"):
        T.MultigridSolver(T.Poisson3D(), 17, device="cuda")


def test_entry_points_default_to_the_card():
    """MultigridSolver and the CLI run on "cuda" unless given "cpu": on a
    host without CUDA, a call that names no device raises; it never
    carries on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; this checks the GPU-less refusal")
    with pytest.raises(RuntimeError, match="CUDA"):
        T.MultigridSolver(T.Ode1D(), 17)
    with pytest.raises(RuntimeError, match="CUDA"):
        T.MultigridSolver(T.Ode1D(), 17, T.SolverConfig(
            cycle=T.CycleConfig(smoother="jacobi")))
    with pytest.raises(RuntimeError, match="CUDA"):
        cli_main(["--problem", "ode1d", "--n", "17"])


def test_update_count_matches_bench():
    spec = importlib.util.spec_from_file_location("bench", ROOT / "bench.py")
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    for shapes, kw in [
        ([(129,) * 3, (65,) * 3], dict(coarsest="exact")),
        ([(257,) * 3, (129,) * 3, (65,) * 3], dict(coarsest="exact")),
        ([(33,) * 3, (17,) * 3, (9,) * 3], dict()),
    ]:
        for kind in ("v", "fmg"):
            assert count_smoother_updates(shapes, kind, 2, 100, 100, **kw) \
                == bench.count_smoother_updates(shapes, kind, 2, 100, 100,
                                                **kw)


def test_cli_prints_the_jax_summary_schema():
    buf = io.StringIO()
    with redirect_stdout(buf):
        cli_main(["--n", "17", "--nu1", "2", "--nu2", "2", "--cycles", "2",
                  "--coarsest", "exact", "--device", "cpu"])
    out = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert set(out) == {
        "problem", "n", "cycle", "cycles_run", "residual_l2",
        "residual_history", "error_l2", "error_linf", "error_mae",
        "diverged", "wall_time_s", "compile_time_s",
    }
    assert out["problem"] == "poisson3d" and out["cycles_run"] == 2
    assert out["cycle"]["coarsest"] == "exact"
    # the bench's default precision: on the CPU tier the same result
    buf = io.StringIO()
    with redirect_stdout(buf):
        cli_main(["--n", "17", "--nu1", "2", "--nu2", "2", "--cycles", "2",
                  "--coarsest", "exact", "--device", "cpu",
                  "--precision", "mixed"])
    mixed = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert set(mixed) == set(out)
    assert mixed["error_linf"] == out["error_linf"]
    with pytest.raises(SystemExit):
        cli_main(["--precision", "bf16"])
    with pytest.raises(SystemExit):
        cli_main(["--kind", "x"])  # not a cycle kind (v, w, fmg)


def test_port_never_imports_jax():
    """Neither the port nor chip_smoke.py imports JAX or the JAX
    package (which pulls in JAX on import)."""
    pat = re.compile(r"^\s*(import jax|from jax)", re.M)
    pkg = re.compile(r"^\s*(import|from)\s+pde_multigrid_tpu\b(?!_torch)",
                     re.M)
    files = list((ROOT / "pde_multigrid_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    for p in files:
        text = p.read_text()
        assert not pat.search(text), p
        assert not pkg.search(text), p
