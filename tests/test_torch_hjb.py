"""Port parity of the HJB slice: the `HJBMinTime` model (both schemes, the
pinned target ball), `stencil.inject`, the FAS V-cycle and whole FAS FMG
solves, against the JAX package (`models/hjb.py`, `cycles.fas_v_cycle`,
`MultigridSolver(backend="jnp")`), on inputs made from numpy seeds.

Tolerances, and why:
  * model ops in float64: 1e-12 of the largest value (same formulas, same
    order);
  * one FAS V-cycle and one FMG step in float64: 1e-10 of max|v| (the
    same ops; the two backends' libm and sums may round apart by an ulp,
    which the sweeps carry along);
  * one FMG step in float32, the port's plain tier (relax_update's
    division form, as JAX jnp) against JAX jnp: v within 1e-5 of max|v|,
    error_linf within 1e-6 (the upwind select w_in <= m2 can flip on one
    ulp, and XLA's CPU backend contracts products into fused
    multiply-adds); measured at 33^2 in `test_fmg_fas_solve_matches_jax`
    (run with -s);
  * the CUDA tier's plan on CPU tensors (the kernels' plain versions,
    kernel_precompute's reciprocal form) against the plain tier in
    float32: 1e-5 of max|v|;
  * float32 against float64, FMG(2, 30, 30) at 129^2 and 257^2, the chip
    gate's evidence: error_linf within 1 % (measured 1e-4 %) and max|dv|
    under 1e-5 (measured 6e-7); its control, the correction scheme at
    129^2, passes the first and fails the second (max|dv| 2.8e-3).
"""

import io
import json
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pde_multigrid_tpu as J
from pde_multigrid_tpu import grid as JG
from pde_multigrid_tpu.models.hjb import (
    min_time_double_integrator as j_min_time,
)
from pde_multigrid_tpu.ops import stencil as JST
import pde_multigrid_tpu_torch as T
from pde_multigrid_tpu_torch import grid as TG
from pde_multigrid_tpu_torch.__main__ import main as cli_main
from pde_multigrid_tpu_torch.cycles import CycleProgram
from pde_multigrid_tpu_torch.models.hjb import (
    min_time_double_integrator as t_min_time,
)
from pde_multigrid_tpu_torch.ops import stencil as TST
from pde_multigrid_tpu_torch.ops.cuda import dispatch as D
from pde_multigrid_tpu_torch.ops.cuda import resident as RS
from pde_multigrid_tpu_torch.ops.cuda import slab2d as SL
from pde_multigrid_tpu_torch.utils.convert import levels_from_numpy

DOM = ((-1.0, 1.0), (-1.0, 1.0))


def _chip_dv_limit():
    """chip_smoke.py's HJB_DV_LIMIT, the gate these tests give evidence
    for."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.HJB_DV_LIMIT


def _close(got, want, rel):
    want = np.asarray(want)
    got = np.asarray(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-300))


# ------------------------------------------------------------------ model


@pytest.mark.parametrize("n", [33, 65])
@pytest.mark.parametrize("pin", [0.0, 2.0])
@pytest.mark.parametrize("scheme", ["upwind", "tesi"])
def test_model_matches_jax(scheme, pin, n):
    """Every HJBMinTime method in float64 against the JAX model, on the
    same seeded inputs: the oracle, rhs, make_aux, apply_operator,
    relax_update (the tesi branches too), kernel_keep_mask,
    kernel_precompute, kernel_update, and init_level (v, f, every mask and
    the rebuilt bv_ring)."""
    jp = J.HJBMinTime(scheme=scheme, pin_radius_cells=pin)
    tp = T.HJBMinTime(scheme=scheme, pin_radius_cells=pin)
    jg = JG.build_geometries((n, n), DOM)[0]
    tg = TG.build_geometries((n, n), DOM)[0]
    rng = np.random.default_rng(n + int(pin) + (scheme == "tesi"))
    jc = jg.coords(np.float64)
    tc = tg.coords(torch.float64)
    _close(t_min_time(*tc), j_min_time(*jc), 1e-12)
    _close(tp.exact_solution(tc), jp.exact_solution(jc), 1e-12)
    _close(tp.rhs(tc), jp.rhs(jc), 0)
    jl = jp.init_level(jg, np.float64)
    tl = tp.init_level(tg, torch.float64)
    assert set(tl.aux) == set(jl.aux)
    for k in jl.aux:
        _close(tl.aux[k], jl.aux[k], 1e-12)
    _close(tl.v, jl.v, 1e-12)
    _close(tl.f, jl.f, 0)
    # the ball and the ring hold exact values in v and in bv_ring
    fixed = (tl.aux["m_log"] - tl.aux["m_int"]) > 0
    assert torch.equal(tl.aux["bv_ring"][fixed], tl.v[fixed])
    v = tl.v.numpy() + tl.aux["m_int"].numpy() * rng.random((n, n))
    f = 1.0 + 0.1 * rng.standard_normal((n, n))
    tv, tf = torch.tensor(v), torch.tensor(f)
    _close(tp.apply_operator(tv, tg, tl.aux),
           jp.apply_operator(v, jg, jl.aux), 1e-12)
    _close(tp.relax_update(tv, tf, tg, tl.aux),
           jp.relax_update(v, f, jg, jl.aux), 1e-12)
    _close(tp.kernel_keep_mask(tc, tg, torch.float64),
           jp.kernel_keep_mask(jc, jg, np.float64), 0)
    jpre = jp.kernel_precompute(jc, jg, np.float64)
    tpre = tp.kernel_precompute(tc, tg, torch.float64)
    assert set(tpre) == set(jpre)
    for k in jpre:
        _close(tpre[k], jpre[k], 1e-12)
    _close(tp.kernel_update(tv, tf, tpre, tg),
           jp.kernel_update(v, f, jpre, jg), 1e-12)


def test_pinned_ball_and_float32_forms():
    """The pinned ball: the origin alone at pin 0, the 2h ball (13 points)
    at pin 2, on every level; float32 coefficient fields and keep mask
    bit for bit the JAX model's."""
    for pin, count in ((0.0, 1), (2.0, 13)):
        for n in (513, 33, 3):
            tg = TG.build_geometries((n, n), DOM)[0]
            lvl = T.HJBMinTime(pin_radius_cells=pin).init_level(tg)
            ball = (lvl.aux["m_log"] - lvl.aux["m_int"]) > 0
            ball[0, :] = ball[-1, :] = ball[:, 0] = ball[:, -1] = False
            assert int(ball.sum()) == min(count, (n - 2) ** 2)
    n = 65
    jp, tp = J.HJBMinTime(), T.HJBMinTime()
    jg = JG.build_geometries((n, n), DOM)[0]
    tg = TG.build_geometries((n, n), DOM)[0]
    jc, tc = jg.coords(np.float32), tg.coords(torch.float32)
    jpre = jp.kernel_precompute(jc, jg, np.float32)
    tpre = tp.kernel_precompute(tc, tg, torch.float32)
    for k in ("c1", "s1", "inv_in", "inv_act"):
        np.testing.assert_array_equal(tpre[k].numpy(), np.asarray(jpre[k]))
    np.testing.assert_array_equal(
        tp.kernel_keep_mask(tc, tg, torch.float32).numpy(),
        np.asarray(jp.kernel_keep_mask(jc, jg, np.float32)))


def test_scheme_and_config_checks():
    with pytest.raises(ValueError):
        T.HJBMinTime(scheme="central")
    assert T.CycleConfig("fmg", 2, 30, 30, scheme="fas").scheme == "fas"
    with pytest.raises(ValueError):
        T.CycleConfig(scheme="fas", coarsest="exact")
    with pytest.raises(ValueError):
        T.CycleConfig(scheme="fas", coarse_operator="galerkin")
    # FAS W-cycles (queue 1 item 16, ported): accepted
    w = T.CycleConfig(scheme="fas", mu=2)
    assert (w.scheme, w.mu) == ("fas", 2)


# ------------------------------------------------------------- injection


@pytest.mark.parametrize("fine,coarse", [((33, 33), (17, 17)),
                                         ((40, 128), (24, 128)),
                                         ((16, 16, 16), (8, 8, 8))])
def test_inject_matches_jax(fine, coarse):
    """stencil.inject against the JAX op: subsampling with the fit to the
    coarse shape (padded and wrap shapes too)."""
    a = np.random.default_rng(1).standard_normal(fine)
    _close(TST.inject(torch.tensor(a), coarse),
           JST.inject(jnp.asarray(a), coarse), 0)


# ------------------------------------------------------------ FAS cycles


def _solvers(n, nus, dtype, kind="fmg", num_levels=None):
    """The JAX jnp-backend and port CPU solvers of one HJB FAS schedule
    (`num_levels` None: down to 3^2; a shallower hierarchy keeps JAX's
    compile short), and the JAX fresh levels as numpy arrays (both start
    from them)."""
    cyc = dict(kind=kind, nu0=nus[0], nu1=nus[1], nu2=nus[2], scheme="fas")
    js = J.MultigridSolver(J.HJBMinTime(), n, J.SolverConfig(
        cycle=J.CycleConfig(**cyc), backend="jnp", dtype=dtype,
        num_levels=num_levels))
    ts = T.MultigridSolver(T.HJBMinTime(), n, T.SolverConfig(
        cycle=T.CycleConfig(**cyc), dtype=dtype, num_levels=num_levels),
        device="cpu")
    assert [g.padded_shape for g in ts.geoms] == [
        g.padded_shape for g in js.geoms]
    arrays = [{"v": np.asarray(l.v), "f": np.asarray(l.f),
               "aux": {k: np.asarray(a) for k, a in l.aux.items()}}
              for l in js.fresh_levels()]
    return js, ts, arrays


@pytest.mark.parametrize("n,num_levels", [(33, None), (65, 4)])
def test_fas_v_cycle_matches_jax(n, num_levels):
    """One FAS V-cycle (3 + 3 sweeps per level) from the initial levels, in
    float64: every level's v and f against JAX `fas_v_cycle` (33^2 down to
    3^2; 65^2 down to 9^2)."""
    js, ts, arrays = _solvers(n, (1, 3, 3), "float64", kind="v",
                              num_levels=num_levels)
    jl = jax.jit(lambda lv: js.program.fas_v_cycle(lv, 0))(
        tuple(js.fresh_levels()))
    tl = ts.program.v_cycle(
        levels_from_numpy(ts.geoms, arrays, dtype=torch.float64), 0)
    for a, b in zip(tl, jl):
        _close(a.v, b.v, 1e-10)
        _close(a.f, b.f, 1e-10)


@pytest.mark.parametrize("n,dtype,num_levels", [(33, "float64", None),
                                                (65, "float64", 4),
                                                (33, "float32", 4)])
def test_fmg_fas_solve_matches_jax(n, dtype, num_levels):
    """One FMG(2, 10, 10) FAS step (`solve`) against JAX backend="jnp": the
    solution, error_linf and the residual norm, to the tolerances of the
    module docstring (float64 33^2 down to 3^2; 65^2 down to 9^2, float32
    33^2 down to 5^2)."""
    js, ts, arrays = _solvers(n, (2, 10, 10), dtype, num_levels=num_levels)
    jr = js.solve(js.fresh_levels())
    tr = ts.solve(levels_from_numpy(ts.geoms, arrays,
                                    dtype=getattr(torch, dtype)))
    f64 = dtype == "float64"
    print(f"{n}^2 {dtype}: max|v - v_jax| "
          f"{np.abs(tr.v.numpy() - np.asarray(jr.v)).max()!r}, error_linf "
          f"{tr.error_linf!r} vs {float(jr.error_linf)!r}")
    _close(tr.v, np.asarray(jr.v), 1e-10 if f64 else 1e-5)
    assert abs(tr.error_linf - float(jr.error_linf)) <= (
        1e-10 if f64 else 1e-6)
    # in float32 the residual of the solution is rounding noise (2.6e-6 at
    # 33^2 on both sides, 1.3 % apart): held to 10 %
    _close(tr.residual_l2, float(jr.residual_l2), 1e-10 if f64 else 0.1)
    assert tr.error_linf < 0.3


def test_fas_equals_cs_on_linear_problem():
    """Port mirror of tests/test_hjb.py::test_fas_equals_cs_on_linear_problem:
    FAS reduces to the correction scheme on Poisson(2)."""
    kw = dict(tol=1e-10, max_cycles=6)
    res = {}
    for scheme in ("cs", "fas"):
        res[scheme] = T.MultigridSolver(
            T.Poisson(2), 65,
            T.SolverConfig(cycle=T.CycleConfig("v", 0, 2, 2, scheme=scheme),
                           **kw),
            device="cpu",
        ).solve_to_tolerance()
    r_cs, r_fas = res["cs"], res["fas"]
    assert abs(r_cs.error_linf - r_fas.error_linf) < 1e-5
    rho_cs = r_cs.residual_history[-1] / r_cs.residual_history[-2]
    rho_fas = r_fas.residual_history[-1] / r_fas.residual_history[-2]
    assert abs(rho_cs - rho_fas) < 0.15


@pytest.mark.parametrize("tier", ["plain", "cuda-plan"])
def test_fmg_preserves_pinned_anchor_cells(tier):
    """Port mirror of tests/test_hjb.py::test_fmg_preserves_pinned_anchor_cells,
    on the plain tier and on the CUDA tier's plan (CPU tensors): FMG
    re-imposes the rebuilt bv_ring, so the ring and the pinned ball keep
    their exact values through a step, bit for bit."""
    prob = T.HJBMinTime()
    cfg = T.SolverConfig(cycle=T.CycleConfig("fmg", 1, 2, 2, scheme="fas"),
                         max_cycles=1)
    solver = T.MultigridSolver(prob, 17, cfg, device="cpu")
    if tier == "cuda-plan":
        k = D.CudaKernels(prob, solver.geoms, torch.float32)
        solver.program = CycleProgram(prob, solver.geoms, cfg.cycle, k)
    levels = solver.fresh_levels()
    lvl0, geom = levels[0], solver.geoms[0]
    fixed = (lvl0.aux["m_log"] - lvl0.aux["m_int"]) > 0
    exact = prob.exact_solution(geom.coords(torch.float32))
    assert int(fixed.sum()) == 4 * 16 + 13
    out = solver.program.solve_step(levels)
    assert torch.equal(out[0].v[fixed], exact[fixed])
    # and through a second step, on solved state
    out = solver.program.solve_step(out)
    assert torch.equal(out[0].v[fixed], exact[fixed])


# ------------------------------------------------- the 513^2 row's slice


@pytest.mark.parametrize("n", [129, 257])
def test_float32_drift_under_the_chip_gate(n):
    """The evidence for the chip gate (chip_smoke.py phase_hjb): FMG(2, 30,
    30) FAS in float32, through the CUDA tier's plan on CPU tensors (the
    kernels' plain versions, which the kernels match bit for bit) and
    through the plain tier, against the float64 solve of the same
    schedule: error_linf within 1 % and max|v - v_float64| under the
    chip's HJB_DV_LIMIT (1e-5)."""
    limit = _chip_dv_limit()
    cyc = T.CycleConfig("fmg", 2, 30, 30, scheme="fas")
    s64 = T.MultigridSolver(T.HJBMinTime(), n,
                            T.SolverConfig(cycle=cyc, dtype="float64"),
                            device="cpu")
    r64 = s64.solve()
    m = s64.fresh_levels()[0].aux["m_int"]
    for tier in ("plain", "cuda-plan"):
        s = T.MultigridSolver(T.HJBMinTime(), n, T.SolverConfig(cycle=cyc),
                              device="cpu")
        if tier == "cuda-plan":
            k = D.CudaKernels(s.problem, s.geoms, torch.float32)
            s.program = CycleProgram(s.problem, s.geoms, cyc, k)
        r = s.solve()
        gap = (r.error_linf - r64.error_linf) / r64.error_linf
        dv = float(torch.max(torch.abs((r.v.double() - r64.v) * m)))
        print(f"{n}^2 {tier}: error_linf {r.error_linf!r} float64 "
              f"{r64.error_linf!r} gap {100 * gap!r} % max|dv| {dv!r}")
        assert abs(gap) < 0.01 and dv < limit
    h = 2.0 / (n - 1)
    assert r64.error_linf < 1.15 * 0.2032 * (32 * h) ** 0.17


def test_chip_gate_rejects_the_correction_scheme():
    """The control of the chip gate at 129^2: the correction scheme, a
    wrong multigrid for this nonlinear operator, in float32.  Its
    error_linf sits at the switching curve and passes the 1 % gate against
    the FAS float64 solve (measured 3e-5 %), so only max|v - v_float64|
    under the chip's HJB_DV_LIMIT (1e-5) tells it apart (measured
    2.8e-3)."""
    def solve(scheme, dtype):
        s = T.MultigridSolver(T.HJBMinTime(), 129, T.SolverConfig(
            cycle=T.CycleConfig("fmg", 2, 30, 30, scheme=scheme),
            dtype=dtype), device="cpu")
        return s, s.solve()

    s64, r64 = solve("fas", "float64")
    _, r = solve("cs", "float32")
    m = s64.fresh_levels()[0].aux["m_int"]
    dv = float(torch.max(torch.abs((r.v.double() - r64.v) * m)))
    assert abs(r.error_linf - r64.error_linf) < 0.01 * r64.error_linf
    assert dv > 10 * _chip_dv_limit()


def test_cuda_plan_on_cpu_matches_plain_tier():
    """FMG(2, 10, 10) FAS at 65^2 through the CUDA tier's plan on CPU
    tensors (resident plain version on every level: 65^2 fits it) against
    the plain tier, and no kernel launch counted."""
    SL.reset_launches()
    RS.reset_launches()
    ts = T.MultigridSolver(T.HJBMinTime(), 65, T.SolverConfig(
        cycle=T.CycleConfig("fmg", 2, 10, 10, scheme="fas")), device="cpu")
    arrays = [{"v": l.v, "f": l.f, "aux": l.aux} for l in ts.fresh_levels()]
    plain = ts.solve(levels_from_numpy(ts.geoms, arrays))
    k = D.CudaKernels(ts.problem, ts.geoms, torch.float32)
    assert all(f.__name__ == "_relax_resident" for f in k._relax)
    ts.program = CycleProgram(ts.problem, ts.geoms, ts.config.cycle, k)
    tier = ts.solve(levels_from_numpy(ts.geoms, arrays))
    _close(tier.v, plain.v, 1e-5)
    assert abs(tier.error_linf - plain.error_linf) < 1e-6
    assert not any(SL.launches.values()) and not any(RS.launches.values())


def test_fas_keeps_split_levels_current(monkeypatch):
    """FAS writes the coarse v and f and reads the fine v itself, so it
    tells the tier's level-state hooks: on Lyapunov2D (linear, so FAS
    applies) with the CUDA tier's plan on CPU tensors and every level down
    to 17^2 on the persistent split tier, FMG(2, 10, 10) FAS matches the
    plain tier's FAS solve (to the kernels' form, 3e-5 of max|v|, as
    tests/test_torch_lyapunov.py holds the split tier) and the CS solve."""
    monkeypatch.setattr(D, "SPLIT2D_MIN_Y2", 8)
    out = {}
    for scheme, tier in (("fas", "plain"), ("fas", "cuda-plan"),
                         ("cs", "cuda-plan")):
        cyc = T.CycleConfig("fmg", 2, 10, 10, scheme=scheme)
        s = T.MultigridSolver(T.Lyapunov2D(), 65, T.SolverConfig(cycle=cyc),
                              device="cpu")
        if tier == "cuda-plan":
            k = D.CudaKernels(s.problem, s.geoms, torch.float32)
            assert k._split == [True, True, True] + [False] * 3
            s.program = CycleProgram(s.problem, s.geoms, cyc, k)
        out[scheme, tier] = s.solve().v
    scale = float(out["fas", "plain"].abs().max())
    _close(out["fas", "cuda-plan"], out["fas", "plain"], 3e-5)
    _close(out["fas", "cuda-plan"], out["cs", "cuda-plan"], 3e-5)
    assert scale > 0


def test_cli_hjb():
    """--problem hjb2d --scheme fas on the CPU tier (the JAX CLI's domain
    handling: --domain d gives [-d, d]^2), and hjb2d-tesi builds the
    thesis scheme."""
    from pde_multigrid_tpu_torch.__main__ import build_problem

    buf = io.StringIO()
    with redirect_stdout(buf):
        cli_main(["--problem", "hjb2d", "--scheme", "fas", "--n", "33",
                  "--nu0", "1", "--nu1", "3", "--nu2", "3", "--device",
                  "cpu", "--cycles", "3"])
    out = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert out["problem"] == "hjb2d" and out["cycle"]["scheme"] == "fas"
    assert out["cycles_run"] == 3 and not out["diverged"]
    assert out["error_linf"] < 0.3
    p = build_problem("hjb2d-tesi", 2.0)
    assert p.scheme == "tesi" and p.domain == ((-2.0, 2.0), (-2.0, 2.0))
    assert build_problem("hjb2d", None).domain == DOM
