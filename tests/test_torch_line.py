"""Port parity of zebra line relaxation: `stencil.thomas_tridiagonal`
(both branches), `stencil.relax_zebra_line`, `Poisson.line_system`,
`cycles._zebra_masks` and whole FMG W-cycle line solves against the JAX
package; then the line kernel's layout (`ops/cuda/zebra_line.py`), a
plain emulation of its in-place half-sweep bitwise against
`relax_zebra_line`, its plan, its wrapper on CPU tensors and the tier
choice.

Tolerances.  Float64: 1e-12 of the largest value (the same operations in
the same order; JAX's scan runs in blocks of 8 rows with identity padding
rows, the port one row a step, which gives the same values).  Float32:
XLA's CPU backend may contract a product into a sum (one rounding fewer)
where PyTorch rounds both, so a few float32 ulp of the largest value:
4e-7 relative for one solve of a line, 2e-6 for sweeps.  Whole solves in
float64: the logical solution to 1e-10 of max|v| and the residual history
to 1e-9 relative or 1e-11 of the first residual (residuals are
differences of terms 1e5 times larger on the squashed level).  The kernel's emulation runs the kernel's arithmetic
in the kernel's order on CPU tensors: bit for bit (`torch.equal`, which
holds -0 == +0; the plain blend may write +0 where the kernel leaves a -0
it does not touch)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pde_multigrid_tpu as J
from pde_multigrid_tpu import cycles as JC
from pde_multigrid_tpu import grid as JG
from pde_multigrid_tpu.models import Poisson as JPoisson
from pde_multigrid_tpu.ops import stencil as JST
import pde_multigrid_tpu_torch as T
from pde_multigrid_tpu_torch import cycles as TC
from pde_multigrid_tpu_torch import grid as TG
from pde_multigrid_tpu_torch import solver as TS
from pde_multigrid_tpu_torch.cycles import TorchKernels
from pde_multigrid_tpu_torch.grid import to_logical
from pde_multigrid_tpu_torch.models import Poisson as TPoisson
from pde_multigrid_tpu_torch.ops import stencil as TST
from pde_multigrid_tpu_torch.ops.cuda import build
from pde_multigrid_tpu_torch.ops.cuda import zebra_line as ZL

# the bench's anis3d domain: x squashed 20x (bench.py:397-401)
ANIS3 = ((0.0, 0.05), (0.0, 1.0), (0.0, 1.0))
ANIS2 = ((0.0, 0.05), (0.0, 1.0))


@pytest.fixture(autouse=True)
def _no_launches():
    """CPU tensors never launch the kernel."""
    ZL.reset_launches()
    yield
    assert ZL.launches["zebra_line"] == 0


def _close(got, want, rel):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-300))


def _geoms(shape, domain, wrap=False):
    return (JG.build_geometries(shape, domain, wrap=wrap)[0],
            TG.build_geometries(shape, domain, wrap=wrap)[0])


# ------------------------------------------------------------ Thomas solve


def _system(rng, n, dtype):
    """Diagonally dominant per-row couplings with identity rows at both
    ends, as line_system gives them, and a random right side."""
    a = rng.uniform(0.5, 1.5, n)
    c = rng.uniform(0.5, 1.5, n)
    b = -(a + c) - rng.uniform(0.1, 1.0, n)
    for i in (0, n - 1):
        a[i], b[i], c[i] = 0.0, 1.0, 0.0
    return a.astype(dtype), b.astype(dtype), c.astype(dtype)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("axis", [0, 1, 2])
@pytest.mark.parametrize("branch", ["host", "device"])
def test_thomas_matches_jax(dtype, axis, branch):
    """Both branches on every axis of a (13, 11, 19) block (no extent a
    multiple of JAX's block of 8 rows): the solution against JAX's, and in
    float64 a solution of the system (the residual of the tridiagonal
    product)."""
    rng = np.random.default_rng(10 * axis + (branch == "host"))
    shape = (13, 11, 19)
    n = shape[axis]
    a, b, c = _system(rng, n, np.float32)
    d = rng.standard_normal(shape).astype(dtype)
    if branch == "host":
        jargs, targs = (a, b, c), (a, b, c)
    else:
        jargs = tuple(jnp.asarray(x.astype(dtype)) for x in (a, b, c))
        targs = tuple(torch.tensor(x.astype(dtype)) for x in (a, b, c))
    want = np.asarray(JST.thomas_tridiagonal(*jargs, jnp.asarray(d), axis))
    got = TST.thomas_tridiagonal(*targs, torch.tensor(d), axis)
    assert got.dtype == getattr(torch, dtype)
    _close(got, want, 1e-12 if dtype == "float64" else 4e-7)
    if dtype == "float64":
        x = np.moveaxis(got.numpy(), axis, 0)
        bs = (-1,) + (1,) * (x.ndim - 1)
        a64, b64, c64 = (np.asarray(r, np.float64).reshape(bs)
                         for r in (a, b, c))
        xm = np.concatenate([np.zeros_like(x[:1]), x[:-1]])
        xp = np.concatenate([x[1:], np.zeros_like(x[:1])])
        _close(a64 * xm + b64 * x + c64 * xp, np.moveaxis(d, axis, 0),
               1e-12)


def test_thomas_coefficients_match_jax_recurrence():
    """thomas_coefficients is JAX's float64 host recurrence (cp, alpha,
    beta) exactly, and the JAX scan's identity padding rows (blocks of 8)
    leave the values of the unblocked recurrence: a host solve of 9 rows
    against the device branch of the same coefficients in float64."""
    rng = np.random.default_rng(3)
    a, b, c = _system(rng, 9, np.float32)
    cp, alpha, beta = TST.thomas_coefficients(a, b, c)
    a64, b64, c64 = (x.astype(np.float64) for x in (a, b, c))
    prev = 0.0
    for i in range(9):
        den = b64[i] - a64[i] * prev
        assert (cp[i], alpha[i], beta[i]) == (c64[i] / den, -a64[i] / den,
                                              1.0 / den)
        prev = cp[i]
    d = rng.standard_normal((9, 5))
    blocked = np.asarray(JST.thomas_tridiagonal(a, b, c, jnp.asarray(d), 0))
    plain = np.asarray(JST.thomas_tridiagonal(
        *(jnp.asarray(x) for x in (a64, b64, c64)), jnp.asarray(d), 0))
    _close(blocked, plain, 1e-13)
    _close(TST.thomas_tridiagonal(a, b, c, torch.tensor(d), 0), blocked,
           1e-13)


# ---------------------------------------------- line_system, zebra masks


@pytest.mark.parametrize("shape,domain,wrap", [
    ((17, 17, 17), ANIS3, False), ((17, 9, 33), ANIS3, False),
    ((17, 17, 17), ((0.0, 1.0),) * 3, True), ((33, 17), ANIS2, False)])
def test_line_system_and_masks_match_jax(shape, domain, wrap):
    """For every line axis: the couplings (equal arrays), d on random v and
    f (float64, 1e-12), the identity rows carrying v, and both zebra
    masks."""
    jg, tg = _geoms(shape, domain, wrap)
    rng = np.random.default_rng(sum(shape))
    v = rng.standard_normal(jg.padded_shape)
    f = rng.standard_normal(jg.padded_shape)
    jp, tp = JPoisson(len(shape), domain), TPoisson(len(shape), domain)
    for axis in range(len(shape)):
        ja, jb, jc, jd = jp.line_system(axis, jg)(jnp.asarray(v),
                                                  jnp.asarray(f))
        ta, tb, tc, td = tp.line_system(axis, tg)(torch.tensor(v),
                                                  torch.tensor(f))
        for x, y in ((ta, ja), (tb, jb), (tc, jc)):
            assert x.dtype == y.dtype == np.float32
            np.testing.assert_array_equal(x, y)
        _close(td, jd, 1e-12)
        ident = np.asarray(ja) == 0
        np.testing.assert_array_equal(
            np.compress(ident, td.numpy(), axis=axis),
            np.compress(ident, v, axis=axis))
        za = (axis + 1) % len(shape)
        for dt, tdt in ((np.float32, torch.float32),
                        (np.float64, torch.float64)):
            jm = JC._zebra_masks(jg, za, dt)
            tm = TC._zebra_masks(tg, za, tdt)
            for x, y in zip(tm, jm):
                assert x.dtype == tdt
                np.testing.assert_array_equal(x.numpy(), y)


# ------------------------------------------------------ relax_zebra_line


def _relax_pair(shape, domain, axis, dtype, nsweeps, seed):
    """relax_zebra_line of both packages from the same v and f."""
    jg, tg = _geoms(shape, domain)
    rng = np.random.default_rng(seed)
    m_int = TG.interior_mask(tg.shape, tg.padded_shape)
    v = (rng.standard_normal(tg.padded_shape) * (1 + m_int)).astype(dtype)
    f = rng.standard_normal(tg.padded_shape).astype(dtype)
    za = (axis + 1) % len(shape)
    jaux = JG.base_aux(jg, jnp.dtype(dtype))
    want = JST.relax_zebra_line(
        JPoisson(len(shape), domain).line_system(axis, jg), jnp.asarray(v),
        jnp.asarray(f), jaux["m_int"], axis, za,
        JC._zebra_masks(jg, za, np.dtype(dtype)), nsweeps)
    got = TC.ZebraLines(TPoisson(len(shape), domain), tg, axis,
                        getattr(torch, dtype)).relax(
        torch.tensor(v), torch.tensor(f), nsweeps)
    return got, np.asarray(want), v


@pytest.mark.parametrize("shape,domain,axis", [
    ((17, 17, 17), ANIS3, 0), ((17, 17, 17), ANIS3, 1),
    ((9, 17, 33), ANIS3, 2), ((33, 17), ANIS2, 0), ((33, 17), ANIS2, 1)])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_relax_zebra_line_matches_jax(shape, domain, axis, dtype):
    """Three sweeps on anisotropic padded 3D (line-0/1/2) and 2D
    (line-0/1) levels from random v and f; the boundary untouched."""
    got, want, v = _relax_pair(shape, domain, axis, dtype, 3,
                               seed=axis + len(shape))
    _close(got, want, 1e-12 if dtype == "float64" else 2e-6)
    tg = TG.build_geometries(shape, domain)[0]
    m_int = TG.interior_mask(tg.shape, tg.padded_shape)
    np.testing.assert_array_equal(got.numpy()[~m_int], v[~m_int])


# ---------------------------------------------------------- whole solves


def _history_close(got, want):
    """Residual histories: 1e-9 relative, or 1e-11 of the first residual
    (a converged residual is rounding noise of terms 1e5 times larger)."""
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-11 * want[0])


def _line_solvers(n, cyc, ndim=3, domain=ANIS3):
    jcfg = J.SolverConfig(cycle=J.CycleConfig(**cyc), dtype="float64",
                          backend="jnp", max_cycles=2, tol=0.0)
    tcfg = T.SolverConfig(cycle=T.CycleConfig(**cyc), dtype="float64",
                          max_cycles=2, tol=0.0)
    return (J.MultigridSolver(JPoisson(ndim, domain), n, jcfg),
            T.MultigridSolver(TPoisson(ndim, domain), n, tcfg,
                              device="cpu"))


def test_fmg_wcycle_line_solve_matches_jax():
    """The bench's anis3d schedule cut to 33^3: FMG(1, 2, 2) with mu = 2
    and zebra lines along x (line-0), exact coarsest (9^3, the dense
    inverse), then one W-cycle, in float64 against JAX backend="jnp": the
    residual history and the logical solution; the port's tier is the
    plain one on the CPU."""
    cyc = dict(kind="fmg", nu0=1, nu1=2, nu2=2, mu=2, smoother="line-0",
               coarsest="exact")
    js, ts = _line_solvers(33, cyc)
    assert type(ts.program.kernels) is TorchKernels
    assert [g.padded_shape for g in ts.geoms] == [(33,) * 3, (17,) * 3,
                                                  (9,) * 3]
    jr, tr = js.solve_to_tolerance(), ts.solve_to_tolerance()
    _history_close(tr.residual_history, jr.residual_history)
    _close(to_logical(tr.v, ts.geoms[0]),
           to_logical(np.asarray(jr.v), js.geoms[0]), 1e-10)
    assert abs(tr.error_linf - float(jr.error_linf)) < 1e-12
    h = max(g for g in ts.geoms[0].spacing)
    assert tr.error_linf < 50 * h * h


def test_line_smoother_refusals():
    """A problem without line_system raises as in JAX (ValueError at the
    tier's construction); the config accepts any line-K."""
    with pytest.raises(ValueError, match="line_system"):
        T.MultigridSolver(T.Lyapunov2D(), 17, T.SolverConfig(
            cycle=T.CycleConfig(smoother="line-0")), device="cpu")
    assert T.CycleConfig(smoother="line-2").smoother == "line-2"
    with pytest.raises(ValueError, match="smoother"):
        T.CycleConfig(smoother="line-x")


# ------------------------------------------------------ the line kernel


LAYOUT_LEVELS = [((257,) * 3, ANIS3, False), ((129,) * 3, ANIS3, False),
                 ((65, 33, 17), ANIS3, False), ((17,) * 3, ANIS3, True),
                 ((5,) * 3, ANIS3, False), ((257, 129), ANIS2, False),
                 ((3, 3), ANIS2, False)]


@pytest.mark.parametrize("shape,domain,wrap", LAYOUT_LEVELS)
def test_layout_covers_every_line_once(shape, domain, wrap):
    """On every line axis and colour: the CTAs' lines are exactly the
    colour's interior lines, each once; a CTA holds whole columns along
    the third axis (the lines that read each other's old values); the
    threads and CTAs fit the launch."""
    g = TG.build_geometries(shape, domain, wrap=wrap)[0]
    nd = len(shape)
    m_int = TG.interior_mask(g.shape, g.padded_shape) if not wrap else \
        TG.wrap_interior(g.padded_shape)
    for axis in range(nd):
        za = (axis + 1) % nd
        for colour in (0, 1):
            p = ZL.layout(g, axis, colour)
            # lines: the interior points of the colour seen along the axis
            want = np.moveaxis(m_int, axis, -1).any(-1)
            par = np.indices(want.shape)[za - (za > axis)] % 2 == colour
            want = sorted(zip(*np.nonzero(want & par)))
            if p is None:
                assert want == []
                continue
            got = []
            for cta in range(p.ctas):
                zc, tc = ZL.line_coords(p, cta)
                assert len(zc) <= p.lines_per_cta
                if nd == 3:
                    # whole columns: every interior third coordinate of
                    # each zebra coordinate the CTA holds
                    for z in set(zc.tolist()):
                        assert sorted(tc[zc == z].tolist()) == list(
                            range(1, g.shape[(axis + 2) % 3] - 1))
                for z, t in zip(zc.tolist(), tc.tolist()):
                    c = [0] * nd
                    c[za] = z
                    if nd == 3:
                        c[(axis + 2) % 3] = t
                    del c[axis]
                    got.append(tuple(c))
            assert sorted(got) == [tuple(int(i) for i in w) for w in want]
            assert p.lines_per_cta % p.n_thr_lines == 0
            assert 32 <= p.threads <= ZL.MAX_THREADS and p.threads % 32 == 0
            assert p.n_line == g.padded_shape[axis]
            assert (p.row_lo, p.row_hi) == (1, g.shape[axis] - 2)


def test_layout_of_the_anis3d_row():
    """257^3 line-0: 255 lines along z a CTA (256 threads, neighbouring
    threads on neighbouring z, coalesced), one CTA a y row of the colour:
    127 even, 128 odd; the zebra term (y) before the third (z)."""
    g = TG.build_geometries((257,) * 3, ANIS3)[0]
    p0, p1 = ZL.layout(g, 0, 0), ZL.layout(g, 0, 1)
    assert (p0.ctas, p1.ctas) == (127, 128)
    for p in (p0, p1):
        assert (p.lines_per_cta, p.threads, p.s_thr, p.s_line, p.s_zeb,
                p.zeb_term_first) == (255, 256, 1, 257 * 257, 257, 1)
    assert (ZL.layout(g, 1, 0).zeb_term_first,
            ZL.layout(g, 2, 0).zeb_term_first) == (0, 1)
    with pytest.raises(NotImplementedError, match="queue 2 item 51"):
        ZL.layout(TG.build_geometries((17,), ((0.0, 1.0),))[0], 0, 0)


def _emulate_half_sweep(v, f, colour, plan, order):
    """The kernel's half-sweep on CPU tensors, in place on v: CTA by CTA in
    `order`, each CTA's forward pass over all its lines (reading v as the
    earlier CTAs left it, dp into a scratch), then its backward pass
    writing v, with the kernel's arithmetic in the kernel's order.  A
    launch that let one CTA's writes reach another's reads would not
    equal the plain half-sweep."""
    p = plan.params[colour]
    if p is None:
        return v
    g, axis = plan.geom, plan.axis
    nd = g.ndim
    alpha, beta, cp = plan.coef.reshape(3, -1)
    w_zeb = torch.tensor(p.w_zeb, dtype=torch.float32)
    w_thr = torch.tensor(p.w_thr, dtype=torch.float32)
    za, ta = (axis + 1) % nd, (axis + 2) % nd
    vl = torch.movedim(v, axis, 0)  # views: rows first
    fl = torch.movedim(f, axis, 0)
    dp = torch.empty_like(vl)
    rows = range(p.n_line)
    for cta in order:
        zc, tc = (torch.tensor(a) for a in ZL.line_coords(p, cta))
        if len(zc) == 0:
            continue

        def idx(z, t):
            # the line's coordinates on the other axes, in axis order
            c = {za: z, ta: t} if nd == 3 else {za: z}
            return tuple(c[ax] for ax in range(nd) if ax != axis)

        zp = (zc + 1) % p.n_zeb
        tp = (tc + 1) % max(p.n_thr, 1)
        x = torch.zeros(len(zc))
        for i in rows:
            vi, fi = vl[i], fl[i]
            vc, d = vi[idx(zc, tc)], fi[idx(zc, tc)]
            pz = vi[idx(zc - 1, tc)] + vi[idx(zp, tc)]
            if nd == 3:
                pt = vi[idx(zc, tc - 1)] + vi[idx(zc, tp)]
                terms = [(pz, w_zeb), (pt, w_thr)]
                if not p.zeb_term_first:
                    terms.reverse()
                for pr, w in terms:
                    d = d - pr * w
            else:
                d = d - pz * w_zeb
            inter = p.row_lo <= i <= p.row_hi
            dr = vc + (d - vc) if inter else vc
            x = alpha[i] * x + beta[i] * dr
            dp[i][idx(zc, tc)] = x
        x = torch.zeros(len(zc))
        for i in reversed(rows):
            x = dp[i][idx(zc, tc)] - cp[i] * x
            if p.row_lo <= i <= p.row_hi:
                vc = vl[i][idx(zc, tc)]
                vl[i][idx(zc, tc)] = vc + (x - vc)
    return v


@pytest.mark.parametrize("shape,domain,wrap,axis", [
    ((17, 17, 17), ANIS3, False, 0), ((17, 17, 17), ANIS3, False, 1),
    ((9, 17, 33), ANIS3, False, 2), ((16, 16, 16), ((0.0, 1.0),) * 3,
                                     True, 0),
    ((33, 17), ANIS2, False, 0), ((33, 17), ANIS2, False, 1)])
def test_kernel_emulation_is_bitwise_relax_zebra_line(shape, domain, wrap,
                                                      axis):
    """Two sweeps of the kernel's scheme (CTAs in reverse order, in place)
    equal `relax_zebra_line` in float32 bit for bit, on 3D line-0/1/2,
    a wrap level (the last zebra and third coordinates wrap to the zero
    plane) and 2D line-0/1; so does the wrapper on CPU tensors, in
    place."""
    logical = tuple(n + 1 for n in shape) if wrap else shape
    g = TG.build_geometries(logical, domain, wrap=wrap)[0]
    prob = TPoisson(len(shape), domain)
    plan = ZL.LinePlan(prob, g, axis)
    rng = np.random.default_rng(len(shape) + axis)
    m = (TG.wrap_interior(g.padded_shape) if wrap
         else TG.interior_mask(g.shape, g.padded_shape))
    v0 = torch.tensor((rng.standard_normal(g.padded_shape) * m)
                      .astype(np.float32))
    f = torch.tensor(rng.standard_normal(g.padded_shape).astype(np.float32))
    plain = TC.ZebraLines(prob, g, axis)
    want = plain.relax(v0, f, 2)
    v = v0.clone()
    for _ in range(2):
        for colour in (0, 1):
            p = plan.params[colour]
            order = range(p.ctas - 1, -1, -1) if p else ()
            _emulate_half_sweep(v, f, colour, plan, order)
    assert torch.equal(v, want), float((v - want).abs().max())
    w = v0.clone()
    assert ZL.zebra_relax(w, f, 2, plan) is w and torch.equal(w, want)
    assert torch.equal(ZL.zebra_half_sweep(v0.clone(), f, 1, plan),
                       plain.half_sweep(v0, f, 1))


def test_plan_constants_and_launches():
    """The plan's alpha | beta | cp are thomas_coefficients of the level's
    line rows cast to float32, its scratch the level's shape; two launches
    a sweep, one on a level whose zebra axis has lines of one colour; the
    wrapper checks shapes; a problem the kernel does not take raises."""
    g = TG.build_geometries((33, 17, 9), ANIS3)[0]
    prob = TPoisson(3, ANIS3)
    plan = ZL.LinePlan(prob, g, 1)
    a, b, c, _ = prob.line_rows(1, g)
    cp, alpha, beta = TST.thomas_coefficients(a, b, c)
    np.testing.assert_array_equal(
        plan.coef.numpy(), np.concatenate([alpha, beta, cp]).astype(
            np.float32))
    assert tuple(plan.scratch.shape) == g.padded_shape
    assert plan.launches(16) == 32
    g3 = TG.build_geometries((3, 3), ANIS2)[0]
    assert ZL.LinePlan(TPoisson(2, ANIS2), g3, 0).launches(16) == 16
    with pytest.raises(ValueError, match="shape"):
        ZL.zebra_relax(torch.zeros(3, 3, 3), torch.zeros(3, 3, 3), 1, plan)
    with pytest.raises(NotImplementedError, match="queue 2 item 51"):
        ZL.LinePlan(T.Lyapunov2D(), g3, 0)


def test_float32_line_on_cuda_picks_the_line_tier(monkeypatch):
    """The tier is chosen once, at construction: float32 line-K on "cuda"
    is the line kernel's tier (with every relaxed level planned; the
    exact coarsest level has none), float64 the plain tier, as JAX runs
    its jnp tier for both; the CPU always the plain tier."""
    made = []
    monkeypatch.setattr(build, "load", lambda: None)
    monkeypatch.setattr(ZL, "LineKernels",
                        lambda *a: made.append(a) or "line tier")
    cuda = torch.device("cuda")
    geoms = TG.build_geometries((33,) * 3, ANIS3, 3)
    prob = TPoisson(3, ANIS3)
    cyc = T.CycleConfig("fmg", 2, 16, 16, 2, smoother="line-0",
                        coarsest="exact")
    assert TS._pick_kernels(prob, geoms, cyc, torch.float32, cuda) == \
        "line tier"
    assert made[0][2] == "line-0" and list(made[0][3]) == [0, 1]
    for dt, dev in ((torch.float64, cuda),
                    (torch.float32, torch.device("cpu"))):
        k = TS._pick_kernels(prob, geoms, cyc, dt, dev)
        assert type(k) is TorchKernels and k.smoother == "line-0"
    assert len(made) == 1


def test_line_tier_on_cpu_tensors_equals_the_plain_tier():
    """LineKernels built on the CPU (the wrappers' plain versions) runs an
    FMG W-cycle line solve bitwise the plain tier's, float32, 17^3."""
    cyc = T.CycleConfig("fmg", 1, 2, 2, 2, smoother="line-0",
                        coarsest="exact")
    s = T.MultigridSolver(TPoisson(3, ANIS3), 17, T.SolverConfig(cycle=cyc),
                          device="cpu")
    plain = s.solve().v
    relaxed = range(len(s.geoms) - 1)
    s.program.kernels = ZL.LineKernels(s.problem, s.geoms, "line-0",
                                       relaxed, "cpu")
    assert [p is not None for p in s.program.kernels.plans] == [
        True] * (len(s.geoms) - 1) + [False]
    assert torch.equal(s.solve().v, plain)
