"""Port parity of the 1D family: `Ode1D` and its exact scan, the damped
Jacobi smoother, and whole solves of the port's MultigridSolver on the CPU
against the JAX MultigridSolver(backend="jnp"), both started from
identical level state (utils/convert.py) and compared on logical arrays.

Tolerances:
  * model methods, exact_solve and relax_jacobi in float64: 1e-12
    relative to the largest value (the same operations; exact_solve
    composes its affine maps in another tree than lax.associative_scan,
    which moves only the last bits);
  * whole solves in float64: solution and error_linf to 1e-9 relative,
    residual histories to 1e-6 (each is the norm of a residual that
    multigrid drives toward rounding level, where the two packages' sums
    in other orders show first), and to 1e-12 absolute with the exact
    smoother, whose residuals are rounding noise (1e-14).  Both coarse
    solves apply the same float32 dense inverse.
"""

import dataclasses
import importlib.util
import io
import json
import pathlib
from contextlib import redirect_stdout

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pde_multigrid_tpu as J
from pde_multigrid_tpu.__main__ import PRESETS as JPRESETS
from pde_multigrid_tpu.grid import build_geometries as jbuild
from pde_multigrid_tpu.ops import stencil as JS
import pde_multigrid_tpu_torch as T
from pde_multigrid_tpu_torch.__main__ import PRESETS
from pde_multigrid_tpu_torch.__main__ import main as cli_main
from pde_multigrid_tpu_torch.grid import build_geometries as tbuild
from pde_multigrid_tpu_torch.grid import to_logical
from pde_multigrid_tpu_torch.ops import stencil as TS
from pde_multigrid_tpu_torch.solver import _exact_num_levels
from pde_multigrid_tpu_torch.utils.convert import levels_from_numpy
from pde_multigrid_tpu_torch.utils.updates import count_smoother_updates

ROOT = pathlib.Path(__file__).resolve().parents[1]
F64 = torch.float64
RTOL = 1e-12


def _geoms(n, domain=((0.0, 1.0),)):
    return jbuild((n,), domain)[0], tbuild((n,), domain)[0]


def _close(got, want, rtol=RTOL):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * max(np.abs(want).max(), 1e-300))


def _rand(n, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(n), rng.standard_normal(n)


# ------------------------------------------------------------------ model


METHODS = ["exact_solution", "rhs", "make_aux", "relax_update",
           "apply_operator", "kernel_precompute", "kernel_update",
           "split_update1d"]


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("domain", [((0.0, 1.0),), ((0.0, 3.0),)], ids=str)
def test_ode1d_methods_match_jax(method, domain):
    n = 33
    jg, tg = _geoms(n, domain)
    jp, tp = J.Ode1D(domain=domain), T.Ode1D(domain=domain)
    (jx,), (tx,) = jg.coords(jnp.float64), tg.coords(F64)
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    v, f = _rand(n, seed=len(method))
    jv, jf = jnp.asarray(v), jnp.asarray(f)
    tv, tf = torch.tensor(v), torch.tensor(f)
    jaux, taux = jp.make_aux(jg, jnp.float64), tp.make_aux(tg, F64, "cpu")
    jpre = jp.kernel_precompute((jx,), jg, jnp.float64)
    tpre = tp.kernel_precompute((tx,), tg, F64)
    pairs = {
        "exact_solution": (tp.exact_solution((tx,)),
                           jp.exact_solution((jx,))),
        "rhs": (tp.rhs((tx,)), jp.rhs((jx,))),
        "make_aux": (taux["epx"], jaux["epx"]),
        "relax_update": (tp.relax_update(tv, tf, tg, taux),
                         jp.relax_update(jv, jf, jg, jaux)),
        "apply_operator": (tp.apply_operator(tv, tg, taux),
                           jp.apply_operator(jv, jg, jaux)),
        "kernel_update": (tp.kernel_update(tv, tf, tpre, tg),
                          jp.kernel_update(jv, jf, jpre, jg)),
        "split_update1d": (tp.split_update1d(tv, tf, tpre, tg),
                           jp.split_update1d(jv, jf, jpre, jg)),
    }
    if method == "kernel_precompute":
        assert set(tpre) == set(jpre) == {"a_e", "a_f"}
        for k in tpre:
            _close(tpre[k], jpre[k])
    else:
        got, want = pairs[method]
        assert got.dtype == F64
        _close(got, want)


@pytest.mark.parametrize("n", [33, 1025, 8193])
def test_exact_solve_matches_jax_scan(n):
    """Random v and f (the Dirichlet ends are v's): the recursive-doubling
    scan against JAX's associative_scan; and the result solves the system
    (relaxation leaves it fixed, the interior residual vanishes)."""
    jg, tg = _geoms(n)
    jp, tp = J.Ode1D(), T.Ode1D()
    v, f = _rand(n, seed=n)
    taux = tp.make_aux(tg, F64, "cpu")
    got = tp.exact_solve(torch.tensor(v), torch.tensor(f), tg, taux)
    want = jp.exact_solve(jnp.asarray(v), jnp.asarray(f), jg,
                          jp.make_aux(jg, jnp.float64))
    _close(got, want)
    assert got[0] == v[0] and got[-1] == v[-1]
    r = TS.residual(lambda a: tp.apply_operator(a, tg, taux), got,
                    torch.tensor(f), T.grid.base_aux(tg, F64)["m_int"])
    assert float(r.abs().max()) < 1e-9 * n


def test_exact_solve_float32_matches_jax():
    """The scan's coefficients come from numpy at the working dtype, as in
    JAX: in float32 the two scans agree to a few ulp."""
    n = 1025
    jg, tg = _geoms(n)
    v, f = (a.astype(np.float32) for a in _rand(n, seed=7))
    taux = T.Ode1D().make_aux(tg, torch.float32, "cpu")
    got = T.Ode1D().exact_solve(torch.tensor(v), torch.tensor(f), tg, taux)
    want = np.asarray(J.Ode1D().exact_solve(
        jnp.asarray(v), jnp.asarray(f), jg, J.Ode1D().make_aux(jg)))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=16 * np.spacing(np.abs(want).max()))


@pytest.mark.parametrize("omega", [2.0 / 3.0, 1.0])
def test_relax_jacobi_matches_jax(omega):
    n = 65
    jg, tg = _geoms(n)
    jp, tp = J.Ode1D(), T.Ode1D()
    v, f = _rand(n, seed=3)
    jaux = {**J.grid.base_aux(jg, jnp.float64), **jp.make_aux(jg, jnp.float64)}
    taux = {**T.grid.base_aux(tg, F64), **tp.make_aux(tg, F64, "cpu")}
    want = JS.relax_jacobi(lambda a, b: jp.relax_update(a, b, jg, jaux),
                           jnp.asarray(v), jnp.asarray(f), jaux["m_int"],
                           omega, 7)
    got = TS.relax_jacobi(lambda a, b: tp.relax_update(a, b, tg, taux),
                          torch.tensor(v), torch.tensor(f), taux["m_int"],
                          omega, 7)
    _close(got, want)


# ------------------------------------------------------- the whole slice


def _pair(n, cyc, dtype="float64", max_cycles=2, tol=0.0):
    js = J.MultigridSolver(
        J.Ode1D(), n,
        J.SolverConfig(cycle=J.CycleConfig(**cyc), backend="jnp",
                       max_cycles=max_cycles, tol=tol, dtype=dtype))
    ts = T.MultigridSolver(
        T.Ode1D(), n,
        T.SolverConfig(cycle=T.CycleConfig(**cyc), max_cycles=max_cycles,
                       tol=tol, dtype=dtype),
        device="cpu")
    assert [g.padded_shape for g in ts.geoms] == [
        g.padded_shape for g in js.geoms]
    jl = js.fresh_levels()
    arrays = [{"v": np.asarray(l.v), "f": np.asarray(l.f),
               "aux": {k: np.asarray(a) for k, a in l.aux.items()}}
              for l in jl]
    tl = levels_from_numpy(ts.geoms, arrays, dtype=ts.dtype)
    return js, ts, js.solve_to_tolerance(jl), ts.solve_to_tolerance(tl)


def _check(js, ts, jr, tr, hist_atol=0.0):
    a = to_logical(np.asarray(jr.v), js.geoms[0])
    b = to_logical(tr.v, ts.geoms[0])
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-9 * np.abs(a).max())
    np.testing.assert_allclose(tr.error_linf, jr.error_linf, rtol=1e-9)
    assert tr.cycles_run == jr.cycles_run
    np.testing.assert_allclose(tr.residual_history, jr.residual_history,
                               rtol=1e-6, atol=hist_atol)
    assert not tr.diverged


SOLVES = {
    # FMG(2, 8, 8), exact coarsest (dense inverse at 513)
    "fmg-exact-1025": (1025, dict(kind="fmg", nu0=2, nu1=8, nu2=8,
                                  coarsest="exact"), {}),
    # full width: 8193 and 4097 relaxed, 2049 solved by the dense inverse
    "fmg-exact-8193": (8193, dict(kind="fmg", nu0=2, nu1=50, nu2=50,
                                  coarsest="exact"), {}),
    # relax down to 3 points
    "fmg-relax-257": (257, dict(kind="fmg", nu0=2, nu1=8, nu2=8), {}),
    # BASELINE.json config 1: V-cycles with damped Jacobi to 1e-8
    "baseline-1": (1025, dict(kind="v", nu0=0, nu1=4, nu2=4,
                              smoother="jacobi", omega=2.0 / 3.0),
                   dict(max_cycles=30, tol=1e-8)),
    # V-cycles with the direct scan as the smoother
    "v-exact": (257, dict(kind="v", nu0=0, nu1=1, nu2=1, smoother="exact"),
                {}),
}


@pytest.mark.parametrize("case", list(SOLVES))
def test_ode1d_solves_match_jax(case):
    n, cyc, kw = SOLVES[case]
    js, ts, jr, tr = _pair(n, cyc, **kw)
    # exact smoothing leaves residuals at the rounding level, where only
    # their size is comparable
    _check(js, ts, jr, tr, hist_atol=1e-12 if case == "v-exact" else 0.0)
    h = ts.geoms[0].spacing[0]
    assert tr.error_linf < 10 * h
    if case == "fmg-exact-8193":
        assert [g.shape[0] for g in ts.geoms] == [8193, 4097, 2049]
    if case == "baseline-1":
        assert tr.residual_l2 <= 1e-8 and 1 < tr.cycles_run < 30
    if case == "v-exact":
        # one V-cycle of exact smoothing solves the discrete system
        assert tr.residual_history[0] < 1e-12


def test_float32_fmg_matches_jax():
    """The slice's dtype: FMG(2, 8, 8) relax-coarsest at 129 in float32.
    The plain tier repeats the jnp arithmetic, but XLA's CPU backend
    contracts relax_update's products with the sums after them, so v
    differs by a few ulp; the residual (|v| eps / h per point, the float32
    floor at this size) moves by up to 1 %."""
    js, ts, jr, tr = _pair(129, dict(kind="fmg", nu0=2, nu1=8, nu2=8),
                           dtype="float32")
    a = to_logical(np.asarray(jr.v), js.geoms[0])
    np.testing.assert_allclose(to_logical(tr.v, ts.geoms[0]), a, rtol=0,
                               atol=4 * np.spacing(np.float32(
                                   np.abs(a).max())))
    np.testing.assert_allclose(tr.residual_history, jr.residual_history,
                               rtol=1e-2)


def test_solver_plans_the_8193_row():
    """The bench's ode1d row truncates to 3 levels (2049 solved by the
    dense inverse), and its update count is the bench's: 65 524 000
    updates per step in 12 legs of 1000 sweeps."""
    assert _exact_num_levels(T.Ode1D(), 8193, False) == 3
    shapes = [(8193,), (4097,), (2049,)]
    spec = importlib.util.spec_from_file_location("bench", ROOT / "bench.py")
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    count = count_smoother_updates(shapes, "fmg", 2, 1000, 1000,
                                   coarsest="exact")
    assert count == bench.count_smoother_updates(
        shapes, "fmg", 2, 1000, 1000, coarsest="exact") == 65_524_000
    assert count == 1000 * (4 * 8191 + 8 * 4095)


# ------------------------------------------------------------------- CLI


def _cli(*args):
    buf = io.StringIO()
    with redirect_stdout(buf):
        cli_main(["--device", "cpu", *args])
    return json.loads(buf.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("coarsest", ["relax", "exact"])
def test_cli_ode1d(coarsest):
    out = _cli("--problem", "ode1d", "--n", "65", "--nu1", "8", "--nu2", "8",
               "--coarsest", coarsest, "--cycles", "2")
    assert out["problem"] == "ode1d" and out["cycles_run"] == 2
    assert out["cycle"]["coarsest"] == coarsest
    assert out["error_linf"] < 10 / 64
    # the domain option stretches the ODE's interval (JAX __main__:64-66)
    wide = _cli("--problem", "ode1d", "--n", "65", "--domain", "2.0",
                "--coarsest", coarsest)
    assert wide["error_linf"] < 10 * 2 / 64


@pytest.mark.parametrize("smoother", ["jacobi", "exact"])
def test_cli_smoothers(smoother):
    out = _cli("--problem", "ode1d", "--n", "65", "--kind", "v",
               "--smoother", smoother, "--omega", "0.6667", "--cycles", "3")
    assert out["cycle"]["smoother"] == smoother
    assert out["cycle"]["omega"] == 0.6667
    assert out["cycles_run"] == 3 and not out["diverged"]
    hist = out["residual_history"]
    assert hist[-1] < hist[0] or hist[0] < 1e-5
    # Poisson 1D relaxes with Jacobi too; it has no direct scan, as in JAX
    args = ("--problem", "poisson1d", "--n", "33", "--kind", "v",
            "--smoother", smoother, "--omega", "0.6667", "--cycles", "3")
    if smoother == "exact":
        with pytest.raises(ValueError, match="exact_solve"):
            _cli(*args)
        return
    p = _cli(*args)
    assert p["problem"] == "poisson1d"
    assert p["residual_history"][-1] < 0.5 * p["residual_history"][0]


def test_cli_ode1d_preset_is_the_jax_preset():
    """The ode1d preset's values (not run: it overrides --n, and 8193
    points x 13 levels x 1000 sweeps on the plain tier take minutes)."""
    assert PRESETS["ode1d"] == JPRESETS["ode1d"] == dict(
        problem="ode1d", n=8193, kind="fmg", nu0=2, nu1=1000, nu2=1000)
    with pytest.raises(SystemExit):
        cli_main(["--device", "cpu", "--smoother", "line-x"])


def test_config_accepts_the_1d_smoothers():
    for sm in ("jacobi", "exact"):
        cfg = T.CycleConfig("v", 0, 2, 2, smoother=sm, omega=0.5)
        assert dataclasses.replace(cfg).smoother == sm
    with pytest.raises(ValueError, match="exact_solve"):
        T.MultigridSolver(T.Poisson3D(), 17, T.SolverConfig(
            cycle=T.CycleConfig(smoother="exact")), device="cpu")


def _recurrence_error(hi, snap, n=8193):
    """error_linf of the float64 backward recurrence the smoother's local
    solve converges to, v[j] = (v[j+1] - h f[j]) e / (e + h) with
    e = e^x + 1, on [0, hi]; `snap` carries the h of e + h as a float32
    sum does: on the grid of e in [2, 4), steps of 2^-22."""
    h = hi / (n - 1)
    x = np.arange(n) * h
    u = (np.exp(x) + x - 3.0) / (1.0 + np.exp(-x))
    e = np.exp(x) + 1.0
    assert 2.0 <= e.min() and e.max() < 4.0
    hs = np.round(h / 2.0 ** -22) * 2.0 ** -22 if snap else h
    a, b = e / (e + hs), -h * e / (e + hs) * np.exp(x)
    v = u.copy()
    for j in range(n - 2, 0, -1):
        v[j] = a[j] * v[j + 1] + b[j]
    return np.abs(v - u)[1:-1].max()


def test_float32_gap_off_a_power_of_two_spacing():
    """On [0, 0.9] every float32 solve of the bench row lies about 44 %
    above the float64 one (JAX's tiers as well as the port's, PERF.md).
    h = 0.9 / 8192 is 460.8 steps of float32's grid for e^x + 1 in
    [2, 4), so the float32 sum e^x + 1 + h carries it as 461 steps: the
    smoother's local solve converges to a shifted scheme, while the
    residual operator, which has no such sum, keeps the true one.  The
    float32 solve lands between the two schemes' errors; on [0, 1],
    h = 2^-13 is 512 steps exactly and the snap changes nothing."""
    assert _recurrence_error(1.0, True) == _recurrence_error(1.0, False)
    lo, hi = _recurrence_error(0.9, False), _recurrence_error(0.9, True)
    cyc = T.CycleConfig("fmg", 2, 1000, 1000, coarsest="exact")
    e64, e32 = (
        T.MultigridSolver(T.Ode1D(domain=((0.0, 0.9),)), 8193,
                          T.SolverConfig(cycle=cyc, dtype=dt),
                          device="cpu").solve().error_linf
        for dt in ("float64", "float32"))
    print(f"\n[0, 0.9]: float64 scheme {lo!r}, snapped {hi!r}, float32 "
          f"solve {e32!r}, float64 solve {e64!r}")
    np.testing.assert_allclose(e64, lo, rtol=1e-6)
    assert 1.3 * lo < e32 < hi
