"""Port parity of the 2D Lyapunov slice: the model, the probed dense
coarse solve, the half-layout transfers of `ops/split2d.py`, the CUDA
tier's plan on CPU tensors (its wrappers then run the kernels' plain
versions) and the whole FMG solve, against the JAX package.

Tolerances, and why:
  * model ops in float64: 1e-12 relative (same formulas, same order);
  * the dense coarse solve in float64: 1e-10 relative (the probed
    matrices are bitwise equal, the float64 matvecs sum in other orders);
  * the half-layout transfers in float32: those of
    tests/test_split_persist.py (the JAX package's own bounds for them);
  * whole solves in float32: the CUDA tier relaxes with the kernels'
    reciprocal form (kernel_precompute), the JAX jnp tier and the port's
    plain tier with relax_update's division, so the iterates part by
    float32 rounding that the sweeps carry along; both reach the same
    discrete solution.  v within 3e-5 of max|v| (the bound
    tests/test_split_persist.py holds the Pallas tier to against jnp)
    and error_linf within 1e-3 relative.  The port's plain tier against
    JAX jnp (the same division form): 1e-5 of max|v|.
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

import pde_multigrid_tpu as J
from pde_multigrid_tpu import grid as JG
from pde_multigrid_tpu.ops import fastdiag as JF
from pde_multigrid_tpu.ops import split2d as JS
from pde_multigrid_tpu.ops.pallas import relax as JR
import pde_multigrid_tpu_torch as T
from pde_multigrid_tpu_torch import grid as TG
from pde_multigrid_tpu_torch.__main__ import PRESETS
from pde_multigrid_tpu_torch.__main__ import main as cli_main
from pde_multigrid_tpu_torch.cycles import CycleProgram
from pde_multigrid_tpu_torch.ops import fastdiag as TF
from pde_multigrid_tpu_torch.ops import split2d as TS
from pde_multigrid_tpu_torch.ops.cuda import dispatch as D
from pde_multigrid_tpu_torch.ops.cuda import relax2d as R2
from pde_multigrid_tpu_torch.ops.cuda import resident as RS
from pde_multigrid_tpu_torch.solver import _exact_num_levels
from pde_multigrid_tpu_torch.utils.convert import levels_from_numpy
from pde_multigrid_tpu_torch.utils.updates import count_smoother_updates

DOM = ((0.0, 1.0), (0.0, 1.0))


def _close64(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())


# ------------------------------------------------------------------ model


@pytest.mark.parametrize("domain", [DOM, ((0.0, 20.0), (0.0, 20.0))],
                         ids=["unit", "cuda-preset"])
def test_model_ops_match_jax(domain):
    """Every Lyapunov2D op in float64 against the JAX model, on the same
    seeded inputs."""
    n = 33
    jp, tp = J.Lyapunov2D(domain=domain), T.Lyapunov2D(domain=domain)
    jg = JG.build_geometries((n, n), domain)[0]
    tg = TG.build_geometries((n, n), domain)[0]
    rng = np.random.default_rng(11)
    v, f = (rng.standard_normal((n, n)) for _ in range(2))
    jaux = jp.make_aux(jg, np.float64)
    taux = tp.make_aux(tg, torch.float64, "cpu")
    for k in ("k1", "k2"):
        _close64(taux[k], jaux[k])
    tv, tf = torch.tensor(v), torch.tensor(f)
    _close64(tp.apply_operator(tv, tg, taux), jp.apply_operator(v, jg, jaux))
    _close64(tp.relax_update(tv, tf, tg, taux),
             jp.relax_update(v, f, jg, jaux))
    jc = jg.coords(np.float64)
    tc = tg.coords(torch.float64)
    _close64(tp.exact_solution(tc), jp.exact_solution(jc))
    jpre = jp.kernel_precompute(jc, jg, np.float64)
    tpre = tp.kernel_precompute(tc, tg, torch.float64)
    for k in ("a_e", "a_s", "a_f"):
        _close64(tpre[k], jpre[k])
    for ff in (f, None):
        _close64(
            tp.kernel_update(tv, None if ff is None else tf, tpre, tg),
            jp.kernel_update(v, ff, jpre, jg),
        )
    # the half-layout forms, on the port's halves of v
    r, b = (t.numpy() for t in R2.split_colors_2d(tv))
    fr = R2.split_colors_2d(tf)[0].numpy()
    q1 = (np.arange(n) % 2 == 1)[:, None]
    cr, cb, _ = TS.color_coords(tg, torch.float64)
    for C, other, q, cc, fc in ((r, b, q1, cr, fr), (b, r, ~q1, cb, None)):
        tnbr = TS._nbr_factory(torch.tensor(other), torch.tensor(q))
        jnbr = JS._nbr_factory(other, q)
        jcc = tuple(c.numpy() for c in cc)
        tpre = tp.kernel_precompute(cc, tg, torch.float64)
        jpre = jp.kernel_precompute(jcc, jg, np.float64)
        _close64(
            tp.split_update2d(tnbr, None if fc is None else torch.tensor(fc),
                              tpre, tg),
            jp.split_update2d(jnbr, fc, jpre, jg),
        )
        _close64(tp.split_operator2d(torch.tensor(C), tnbr, cc, tg),
                 jp.split_operator2d(C, jnbr, jcc, jg))


def test_kernel_precompute_keeps_float32_rounding():
    """In float32 the coefficient fields round as the JAX kernels' do
    (`a` cast to float32, alpha*hx*hy rounded once from double): equal
    to the JAX model's float32 precompute bit for bit."""
    n = 65
    jp, tp = J.Lyapunov2D(), T.Lyapunov2D()
    jg = JG.build_geometries((n, n), DOM)[0]
    tg = TG.build_geometries((n, n), DOM)[0]
    jpre = jp.kernel_precompute(jg.coords(np.float32), jg, np.float32)
    tpre = tp.kernel_precompute(tg.coords(torch.float32), tg, torch.float32)
    for k in ("a_e", "a_s", "a_f"):
        np.testing.assert_array_equal(tpre[k].numpy(), np.asarray(jpre[k]))


# ----------------------------------------------------- dense coarse solve


def test_dense_coarse_solve_matches_jax():
    """The probed dense inverse at 33^2 (the 4097^2 path's coarsest level)
    against the JAX one, in float64, with the Dirichlet ring in v."""
    n = 33
    jl = J.MultigridSolver(
        J.Lyapunov2D(), n,
        J.SolverConfig(backend="jnp", dtype="float64")).fresh_levels()[0]
    jg = JG.build_geometries((n, n), DOM)[0]
    tg = TG.build_geometries((n, n), DOM)[0]
    rng = np.random.default_rng(3)
    f = rng.standard_normal((n, n)) * np.asarray(jl.aux["m_int"])
    v = np.asarray(jl.v) + rng.standard_normal((n, n)) * np.asarray(
        jl.aux["m_int"])  # interior garbage: the solve must ignore it
    want = np.asarray(JF.make_dense_coarse_solve(J.Lyapunov2D(), jg)(
        v, f, jl.aux))
    taux = {k: torch.tensor(np.asarray(a)) for k, a in jl.aux.items()}
    solve = TF.make_dense_coarse_solve(T.Lyapunov2D(), tg)
    got = solve(torch.tensor(v), torch.tensor(f), taux).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-10,
                               atol=1e-10 * np.abs(want).max())
    # it solves: L v = f on the interior, v = Dirichlet data on the ring
    m = taux["m_int"]
    res = (T.Lyapunov2D().apply_operator(torch.tensor(got), tg, taux)
           - torch.tensor(f)) * m
    assert float(res.abs().max()) < 1e-4 * float(np.abs(f).max())
    ring = (1 - m).numpy()
    np.testing.assert_array_equal(got * ring, np.asarray(jl.v) * ring)
    assert TF.make_coarse_solve(T.Lyapunov2D(), tg) is not None
    big = TG.build_geometries((65, 65), DOM)[0]  # 63^2 > DENSE_COARSE_MAX
    assert TF.make_dense_coarse_solve(T.Lyapunov2D(), big) is None
    with pytest.raises(ValueError, match="no direct solve"):
        TF.make_coarse_solve(T.Lyapunov2D(), big)


# ------------------------------------------------- half-layout transfers


def _transfer_case(n=65, seed=7):
    jh = JG.Hierarchy.build(J.Lyapunov2D(), n, pad_last_to=128,
                            pad_sublane_to=8)
    th = TG.Hierarchy.build(T.Lyapunov2D(), n)
    rng = np.random.default_rng(seed)
    (X, Y), (Xc, Yc) = jh.geoms[0].padded_shape, jh.geoms[1].padded_shape
    nc = th.geoms[1].shape[0]
    v, f = np.zeros((X, Y), np.float32), np.zeros((X, Y), np.float32)
    c = np.zeros((Xc, Yc), np.float32)
    v[:n, :n], f[:n, :n] = (rng.standard_normal((n, n)) for _ in range(2))
    c[:nc, :nc] = rng.standard_normal((nc, nc))
    Y2p = JS.half_width(jh.geoms[0])
    conv = JR.make_color_converters_2d(X, Y, Y2p, np.float32)
    return jh, th, v, f, c, conv


def _port_halves(a):
    return R2.split_colors_2d(torch.tensor(a))


def test_residual_restrict_from_halves_matches_jax():
    """Residual on halves (with f and f-less), and its restriction to the
    dense coarse level, against the JAX split2d forms."""
    jh, th, v, f, _, (split_pad, merge) = _transfer_case()
    jg0, jg1 = jh.geoms[:2]
    tg0, tg1 = th.geoms[:2]
    n, nc = tg0.shape[0], tg1.shape[0]
    jr, jb = split_pad(v)
    r, b = _port_halves(v[:n, :n])
    for with_f in (True, False):
        jfr, jfb = split_pad(f) if with_f else (None, None)
        fr, fb = _port_halves(f[:n, :n]) if with_f else (None, None)
        jrr, jrb = JS.residual_halves(J.Lyapunov2D(), jg0, jr, jb, jfr, jfb,
                                      np.float32)
        rr, rb = TS.residual_halves(T.Lyapunov2D(), tg0, r, b, fr, fb)
        np.testing.assert_allclose(
            R2.merge_colors_2d(rr, rb, n).numpy(),
            np.asarray(merge(jrr, jrb))[:n, :n], rtol=1e-4, atol=1e-3)
        want = JS.restrict_residual_from_halves(
            jg0, jg1, jrr, jrb, jh.levels[1].aux["m_int"],
            jh.levels[1].aux["m_log"])
        got = TS.restrict_residual_from_halves(
            tg0, tg1, rr, rb, th.levels[1].aux["m_int"],
            th.levels[1].aux["m_log"])
        assert tuple(got.shape) == tg1.padded_shape
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(want)[:nc, :nc],
                                   rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("mode", ["add", "replace"])
def test_prolong_blend_halves_matches_jax(mode):
    jh, th, v, _, c, (split_pad, merge) = _transfer_case(seed=8)
    n, nc = th.geoms[0].shape[0], th.geoms[1].shape[0]
    jr, jb = split_pad(v)
    jr2, jb2 = JS.prolong_blend_halves(jh.geoms[1], jh.geoms[0], c, jr, jb,
                                       mode, np.float32)
    r, b = _port_halves(v[:n, :n])
    out = TS.prolong_blend_halves(th.geoms[1], th.geoms[0],
                                  torch.tensor(c[:nc, :nc]), r, b, mode)
    assert out[0] is r and out[1] is b  # in place
    got = R2.merge_colors_2d(r, b, n).numpy()
    np.testing.assert_allclose(got, np.asarray(merge(jr2, jb2))[:n, :n],
                               rtol=1e-5, atol=1e-5)
    keep = 1.0 - th.levels[0].aux["m_int"].numpy()
    np.testing.assert_array_equal(got * keep, v[:n, :n] * keep)
    with pytest.raises(ValueError, match="mode"):
        TS.prolong_blend_halves(th.geoms[1], th.geoms[0],
                                torch.tensor(c[:nc, :nc]), r, b, "blend")


def test_interior_masks_and_coords_halves():
    """The half-layout masks are the dense interior masks split, and the
    coordinates those of LevelGeometry.coords split (inert slot: mask 0,
    coordinate clamped to the domain)."""
    g = TG.build_geometries((17, 17), DOM)[0]
    aux = TG.base_aux(g)
    m_r, m_b = TS.interior_masks_halves(g, torch.float32)
    np.testing.assert_array_equal(R2.merge_colors_2d(m_r, m_b, 17).numpy(),
                                  aux["m_int"].numpy())
    assert torch.equal(m_r, R2.split_colors_2d(aux["m_red"])[0])
    assert torch.equal(m_b, R2.split_colors_2d(aux["m_black"])[1])
    (xr, yr), (xb, yb), (ir, ib) = TS.color_coords(g, torch.float32)
    x, y = g.coords(torch.float32)
    assert torch.equal(R2.merge_colors_2d(yr.expand_as(ir), yb, 17), y)
    assert torch.equal(xr, x[:, :1]) and torch.equal(xb, x[:, :1])
    assert float(yr.max()) == 1.0 and int(ir.max()) == 17


# ------------------------------------------------------- the whole slice


def _jax_and_port(n, nu, kind="fmg"):
    cyc = dict(kind=kind, nu0=2, nu1=nu, nu2=nu, coarsest="exact")
    js = J.MultigridSolver(
        J.Lyapunov2D(), n,
        J.SolverConfig(cycle=J.CycleConfig(**cyc), backend="jnp",
                       max_cycles=2, tol=0.0))
    ts = T.MultigridSolver(
        T.Lyapunov2D(), n,
        T.SolverConfig(cycle=T.CycleConfig(**cyc), max_cycles=2, tol=0.0),
        device="cpu")
    assert [g.padded_shape for g in ts.geoms] == [
        g.padded_shape for g in js.geoms]
    jl = js.fresh_levels()
    arrays = [{"v": np.asarray(l.v), "f": np.asarray(l.f),
               "aux": {k: np.asarray(a) for k, a in l.aux.items()}}
              for l in jl]
    return js, ts, jl, arrays


def _cuda_tier(ts, mixed=False):
    """The solver with the CUDA tier's plan on CPU tensors."""
    relaxed = range(len(ts.geoms) - 1)
    k = D.CudaKernels(ts.problem, ts.geoms, torch.float32, relaxed,
                      mixed=mixed)
    ts.program = CycleProgram(ts.problem, ts.geoms, ts.config.cycle, k)
    return k


@pytest.mark.parametrize("n,gate", [(65, 32), (65, 256), (129, 64)],
                         ids=["65-split", "65-resident", "129-both"])
def test_lyapunov_slice_matches_jax(monkeypatch, n, gate):
    """FMG(2, 40, 40) with the exact coarsest level, then one V-cycle
    (solve_to_tolerance, max_cycles=2): the CUDA tier's plan (split tier
    and resident kernel as the gate sends the levels) and the plain tier
    against JAX MultigridSolver(backend="jnp"), and against each other."""
    monkeypatch.setattr(D, "SPLIT2D_MIN_Y2", gate)
    js, ts, jl, arrays = _jax_and_port(n, 40)
    jr = js.solve_to_tolerance(jl)
    plain = ts.solve_to_tolerance(levels_from_numpy(ts.geoms, arrays))
    k = _cuda_tier(ts)
    want_split = [g.padded_shape[1] // 2 >= gate for g in ts.geoms[:-1]]
    assert k._split[:-1] == want_split
    assert any(k._split) or all(r is not None for r in k._relax[:-1])
    tier = ts.solve_to_tolerance(levels_from_numpy(ts.geoms, arrays))
    a = TG.to_logical(np.asarray(jr.v), js.geoms[0])
    scale = np.abs(a).max()
    np.testing.assert_allclose(TG.to_logical(plain.v, ts.geoms[0]), a,
                               rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(TG.to_logical(tier.v, ts.geoms[0]), a,
                               rtol=0, atol=3e-5 * scale)
    # the CUDA tier's cycle on CPU tensors against the plain tier
    np.testing.assert_allclose(tier.v.numpy(), plain.v.numpy(), rtol=0,
                               atol=3e-5 * scale)
    for res in (plain, tier):
        np.testing.assert_allclose(res.error_linf, jr.error_linf, rtol=1e-3)
        assert res.cycles_run == jr.cycles_run == 2
        assert not res.diverged
    # first order one-sided scheme: error_linf ~ 1.7 h
    h = ts.geoms[0].spacing[0]
    assert tier.error_linf < 10 * h


def test_split_merge_budget(monkeypatch):
    """Per visit of a split level: at most one split of v, one split of f
    (none on f-less legs) and one merge, plus the final solution's merge.
    Counted for FMG(2) with the split levels 129^2 and 65^2: level l is
    visited nu0 (l + 1) times, nu0 l of them as a coarse level (with f);
    v splits once per level (its first FMG visit), f once per coarse
    visit, and a merge ends each coarse visit and each level's FMG stay
    (level 0: the final solution)."""
    monkeypatch.setattr(D, "SPLIT2D_MIN_Y2", 16)
    _, ts, _, arrays = _jax_and_port(129, 3)
    k = _cuda_tier(ts)
    split = [l for l, s in enumerate(k._split) if s]
    assert split == [0, 1]
    levels = ts.program.solve_step(levels_from_numpy(ts.geoms, arrays))
    nu0 = 2
    visits = sum(nu0 * (l + 1) for l in split)
    coarse_visits = sum(nu0 * l for l in split)
    assert k.conversions == {
        "split_v": len(split),
        "split_f": coarse_visits,
        "merge": coarse_visits + len(split),
    }
    assert k.conversions["split_v"] <= visits
    assert k.conversions["merge"] <= visits + 1
    # a second step: the same counts again, and the solution stays dense
    before = dict(k.conversions)
    ts.program.solve_step(levels)
    assert {x: k.conversions[x] - before[x] for x in before} == before
    # V-cycles (no FMG): every visit splits v once, level 0 merges once
    _, tv, _, arrays = _jax_and_port(129, 3, kind="v")
    kv = _cuda_tier(tv)
    tv.program.solve_step(levels_from_numpy(tv.geoms, arrays))
    assert kv.conversions == {"split_v": 1, "split_f": 1, "merge": 2}


def test_two_pair_halves_follow_the_relax(monkeypatch):
    """A split level holds two pairs of persistent halves: a relax of an
    odd count of chunks (1 or 5 ... 8 sweeps at CHUNK_T = 4 is 1 or 2)
    leaves the result in the other pair, which becomes the current one;
    dense_v, residual_restrict and prolong_blend then read it.  The level
    after relax, relax, merge is bitwise the half-sweep chain's, f-less
    legs split no f, and no pair is allocated twice."""
    monkeypatch.setattr(D, "SPLIT2D_MIN_Y2", 32)
    _, ts, _, arrays = _jax_and_port(65, 3)
    k = _cuda_tier(ts)
    assert k._split[0]
    g = ts.geoms[0]
    rng = np.random.default_rng(21)
    v0 = torch.tensor(rng.standard_normal(g.padded_shape), dtype=torch.float32)
    f = torch.tensor(rng.standard_normal(g.padded_shape), dtype=torch.float32)
    r, b = R2.to_halves(v0)
    fr, fb = R2.to_halves(f)
    v = v0.clone()
    k.reset_state()
    seen = []
    for ns, f_zero in ((1, False), (5, True), (4, False), (9, True)):
        before = k._v_halves(0, v)
        k.relax(0, v, f, None, ns, f_zero=f_zero)
        flip = -(-ns // R2.CHUNK_T) % 2 == 1
        assert (k._vh[0] is not before) == flip
        assert (k._vh_spare[0] is before) == flip
        seen += [id(k._vh[0]), id(k._vh_spare[0])]
        for _ in range(ns):
            R2.half_sweep2d_plain(r, b, None if f_zero else fr, R2.RED,
                                  ts.problem, g)
            R2.half_sweep2d_plain(b, r, None if f_zero else fb, R2.BLACK,
                                  ts.problem, g)
    assert len(set(seen)) == 2
    assert k.conversions == {"split_v": 1, "split_f": 1, "merge": 0}
    got = k.dense_v(0, v)
    want = R2.merge_colors_2d(r, b, g.padded_shape[1])
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    # the transfers on halves read the current pair
    caux = levels_from_numpy(ts.geoms, arrays)[1].aux
    rr, rb = TS.residual_halves(ts.problem, g, r, b, fr, fb)
    want = TS.restrict_residual_from_halves(g, ts.geoms[1], rr, rb,
                                            caux["m_int"], caux["m_log"])
    assert torch.equal(k.residual_restrict(0, v, f, None, caux), want)


def test_cuda_tier_mixed_relaxes_in_float32(monkeypatch):
    """precision="mixed" on Lyapunov: no defect plan covers a 2D level, so
    every level relaxes in float32 (as the JAX package does) and the
    result is the f32 tier's bit for bit."""
    monkeypatch.setattr(D, "SPLIT2D_MIN_Y2", 32)
    _, ts, _, arrays = _jax_and_port(65, 10)
    out = []
    for mixed in (False, True):
        k = _cuda_tier(ts, mixed=mixed)
        assert all(d is None for d in k._defect)
        out.append(ts.solve(levels_from_numpy(ts.geoms, arrays)).v)
    assert torch.equal(out[0], out[1])


def test_solver_plans_the_4097_path():
    """The bench's 4097^2 row truncates to 8 levels (33^2 solved by the
    dense inverse), and its update count is the bench's."""
    assert _exact_num_levels(T.Lyapunov2D(), 4097, False) == 8
    shapes = [((4097 - 1) // 2**l + 1,) * 2 for l in range(8)]
    spec = importlib.util.spec_from_file_location(
        "bench", pathlib.Path(__file__).resolve().parents[1] / "bench.py")
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    count = count_smoother_updates(shapes, "fmg", 2, 500, 500,
                                   coarsest="exact")
    assert count == bench.count_smoother_updates(
        shapes, "fmg", 2, 500, 500, coarsest="exact")
    assert round(count / 1e6) == 59566  # 5.9566e10 updates per step
    with pytest.raises(RuntimeError, match="CUDA"):
        if torch.cuda.is_available():
            pytest.skip("a GPU is present; this checks the GPU-less refusal")
        T.MultigridSolver(T.Lyapunov2D(), 33, T.SolverConfig(
            precision="mixed", cycle=T.CycleConfig(coarsest="exact")),
            device="cuda")


def test_cli_lyapunov():
    """--problem lyapunov2d on the CPU tier, and the reference presets
    of the JAX CLI."""
    import io
    import json
    from contextlib import redirect_stdout

    from pde_multigrid_tpu.__main__ import PRESETS as JPRESETS

    for name in ("lyapunov2d", "lyapunov2d-cuda"):
        assert PRESETS[name] == JPRESETS[name]
    buf = io.StringIO()
    with redirect_stdout(buf):
        cli_main(["--problem", "lyapunov2d", "--n", "33", "--nu1", "4",
                  "--nu2", "4", "--coarsest", "exact", "--device", "cpu",
                  "--cycles", "2", "--precision", "mixed"])
    out = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert out["problem"] == "lyapunov2d" and out["cycles_run"] == 2
    assert out["error_linf"] < 10 / 32


def test_lyapunov_halves_never_reach_the_resident_kernel():
    """The resident kernel serves the dense small levels only; the
    split tier's plan never hands it halves."""
    assert not RS.fits(TG.build_geometries((17, 17), DOM, wrap=True)[0])
