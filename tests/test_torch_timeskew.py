"""Port parity of the time-skewed wavefront relax (`ops/cuda/relax.py`:
`timeskew_sweeps_plain`, which the wrapper `timeskew_relax_halves` runs
for CPU tensors) against the JAX package: its `make_split_timeskew_relax`
and `make_split_timeskew_relax_jb` in interpret mode, the jnp tier's
`relax_rbgs` in float64, and the port's own blend-form half-sweeps; then
the wrapper's launch chain and refusals, the kernel's launch layout
(`timeskew_layout`: every column owned once, the cluster and shared
memory within the card's limits, the x chunks, the redundancy, the shard
chunk's windows), the plan on the 129^3, 257^3 and 513^3 hierarchies,
and an FMG slice through the CUDA tier's plan against JAX's jnp solve.

Tolerances.  On the card, with --fmad=false, the kernel equals this plain
version bit for bit at any T (`chip_smoke.py`).  XLA's CPU backend, which
runs the interpreted Pallas kernels here, contracts a product into the
following sum (one fused multiply-add, one rounding fewer): float32 within
2 ulp of the largest value the sweeps read or write.  float64 against
`relax_rbgs`: 1e-12 relative (the where form and the blend form round
differently, by an ulp of float64).  float32 against the blend-form
half-sweeps: 4 ulp of the largest value (`u + (upd - u)` rounds where
`upd` does not, and Gauss-Seidel carries each such ulp into the next
sweeps without growing it)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pde_multigrid_tpu as J
from pde_multigrid_tpu import grid as JG
from pde_multigrid_tpu.models import Poisson as JPoisson
from pde_multigrid_tpu.ops import stencil as JS
from pde_multigrid_tpu.ops.pallas import relax as JR
from pde_multigrid_tpu_torch import CycleConfig, MultigridSolver, SolverConfig
from pde_multigrid_tpu_torch import grid as TG
from pde_multigrid_tpu_torch.cycles import CycleProgram
from pde_multigrid_tpu_torch.grid import to_logical
from pde_multigrid_tpu_torch.models import Poisson as TPoisson
from pde_multigrid_tpu_torch.ops.cuda import defect as D
from pde_multigrid_tpu_torch.ops.cuda import relax as R
from pde_multigrid_tpu_torch.ops.cuda import resident3d as RS3
from pde_multigrid_tpu_torch.ops.cuda.dispatch import CudaKernels
from pde_multigrid_tpu_torch.utils.convert import levels_from_numpy

F32 = jnp.dtype("float32")
DOM = ((0.0, 1.0),) * 3


def _level(n, seed, dtype=np.float32, invariant=True):
    """Wrap geometries of both packages and (v, f) at n^3.  With
    `invariant`, v keeps the wrap invariant (stored planes x, y, z = 0
    zero); otherwise it is random everywhere."""
    jg = JG.build_geometries((n,) * 3, DOM, wrap=True)
    tg = TG.build_geometries((n,) * 3, DOM, wrap=True)
    rng = np.random.default_rng(seed)
    shape = jg[0].padded_shape
    v = rng.standard_normal(shape)
    if invariant:
        v = v * TG.wrap_interior(shape)
    return jg, tg, v.astype(dtype), rng.standard_normal(shape).astype(dtype)


def _halves(v, f):
    """(b, fr, fb) torch halves: the black half of v, both halves of f."""
    _, b = R.split_colors(torch.tensor(v))
    fr, fb = R.split_colors(torch.tensor(f))
    return b, fr, fb


@pytest.fixture(autouse=True)
def _no_launches():
    """CPU tensors never launch a kernel: every counter stays at zero."""
    R.reset_launches()
    yield
    assert not any(R.launches.values()) and not R.timeskew_by_level


# ------------------------------------------------ (a) the Pallas kernels


@pytest.mark.parametrize("n,T,block_j", [(17, 2, None), (33, 3, None),
                                         (65, 2, 8), (65, 2, 16)])
def test_plain_matches_pallas_timeskew(n, T, block_j):
    """timeskew_sweeps_plain against make_split_timeskew_relax (whole
    half-planes; block_j None) and make_split_timeskew_relax_jb (j blocks)
    in interpret mode, raw halves in and out, over nu = 1, T and 2T + 1
    (one launch, a full chain, a chain with a remainder).  The whole-plane
    kernel gets a black half random everywhere: its plane 0 is never read,
    and the j and z wrap reads take the boundary values as torch.roll
    does.  The j-blocked kernel's windows read an appended zero column at
    the y boundary instead, which equals the full plane on a level that
    keeps the wrap invariant, so it gets one."""
    jg, tg, v, f = _level(n, seed=n + T, invariant=block_j is not None)
    X, _, Z = jg[0].padded_shape
    qb = JR._split_qmask(X, Z)
    _, jb = JR.split_colors(jnp.asarray(v), qb)
    jfr, jfb = JR.split_colors(jnp.asarray(f), qb)
    if block_j is None:
        raw = JR.make_split_timeskew_relax(JPoisson(3), jg[0], F32, T,
                                           interpret=True, raw=True)
    else:
        raw = JR.make_split_timeskew_relax_jb(JPoisson(3), jg[0], F32, T,
                                              block_j, interpret=True,
                                              raw=True)
    b, fr, fb = _halves(v, f)
    for ns in (1, T, 2 * T + 1):
        want_r, want_b = map(np.asarray, raw(None, jb, jfr, jfb, ns))
        got_r, got_b = R.timeskew_sweeps_plain(b, fr, fb, ns, TPoisson(3),
                                               tg[0])
        scale = max(np.abs(v).max(), np.abs(want_r).max(),
                    np.abs(want_b).max())
        ulp = np.spacing(np.float32(scale))
        np.testing.assert_allclose(got_r.numpy(), want_r, rtol=0,
                                   atol=2 * ulp)
        np.testing.assert_allclose(got_b.numpy(), want_b, rtol=0,
                                   atol=2 * ulp)


# ------------------------------------------- (b) relax_rbgs, blend form


@pytest.mark.parametrize("n", [17, 33])
def test_plain_matches_relax_rbgs_float64(n):
    """In float64, merge(timeskew_sweeps_plain) equals the jnp tier's
    dense masked red-black sweeps on a level keeping the wrap invariant,
    to 1e-12 relative."""
    jg, tg, v, f = _level(n, seed=40 + n, dtype=np.float64)
    aux = JG.base_aux(jg[0])
    prob = JPoisson(3)
    b, fr, fb = _halves(v, f)
    for ns in (1, 4):
        want = np.asarray(JS.relax_rbgs(
            lambda vv, ff: prob.relax_update(vv, ff, jg[0], aux),
            jnp.asarray(v), jnp.asarray(f), aux["m_red"], aux["m_black"],
            ns))
        r, b2 = R.timeskew_sweeps_plain(b, fr, fb, ns, TPoisson(3), tg[0])
        assert r.dtype == torch.float64
        got = R.merge_colors(r, b2).numpy()
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-12 * np.abs(want).max())


def test_plain_matches_blend_form_half_sweeps():
    """In float32, the where form against the port's blend-form chain
    (`half_sweep_plain`, what the 128^3 level runs) from the same halves:
    within 4 ulp of the largest value, over 1 and 10 sweeps."""
    _, tg, v, f = _level(33, seed=50)
    prob, g = TPoisson(3), tg[0]
    r0, b = R.split_colors(torch.tensor(v))
    fr, fb = R.split_colors(torch.tensor(f))
    for ns in (1, 10):
        r, b2 = R.timeskew_sweeps_plain(b, fr, fb, ns, prob, g)
        pr, pb = r0.clone(), b.clone()
        for _ in range(ns):
            R.half_sweep_plain(pr, pb, fr, R.RED, prob, g)
            R.half_sweep_plain(pb, pr, fb, R.BLACK, prob, g)
        scale = max(float(pr.abs().max()), float(pb.abs().max()),
                    float(np.abs(v).max()))
        ulp = float(np.spacing(np.float32(scale)))
        assert float((r - pr).abs().max()) <= 4 * ulp
        assert float((b2 - pb).abs().max()) <= 4 * ulp


# ------------------------------------------------------- (c) the wrapper


@pytest.mark.parametrize("T", [1, 2, 3, R.TIMESKEW_T])
def test_wrapper_chain_is_independent_of_T(T):
    """The launch chain's arithmetic: ns // T runs of T sweeps and one of
    ns % T, each from the previous run's black half (relax_raw), equal ns
    sweeps in one run bit for bit, at the wrapper's T and at others; the
    wrapper on CPU tensors equals both; with v_zero the black half is
    zero and not read."""
    _, tg, v, f = _level(17, seed=60 + T, invariant=False)
    prob, g = TPoisson(3), tg[0]
    b, fr, fb = _halves(v, f)
    ns = 2 * T + 1
    want = R.timeskew_sweeps_plain(b, fr, fb, ns, prob, g)
    src = b
    n_full, rem = divmod(ns, T)
    for t in [T] * n_full + [rem] * (rem > 0):
        r, src = R.timeskew_sweeps_plain(src, fr, fb, t, prob, g)
    assert torch.equal(r, want[0]) and torch.equal(src, want[1])
    got = R.timeskew_relax_halves(b, fr, fb, ns, prob, g)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    b_in = b.clone()
    R.timeskew_relax_halves(b, fr, fb, ns, prob, g)
    assert torch.equal(b, b_in)  # the inputs are not written
    zero = R.timeskew_relax_halves(None, fr, fb, ns, prob, g, v_zero=True)
    want = R.timeskew_sweeps_plain(torch.zeros_like(b), fr, fb, ns, prob, g)
    assert torch.equal(zero[0], want[0]) and torch.equal(zero[1], want[1])


def test_plane_zero_of_b_is_not_read():
    """The kernels never load plane x = 0 of the black half: any values
    there give the same result, and plane 0 of both outputs is zero."""
    _, tg, v, f = _level(17, seed=70, invariant=False)
    prob, g = TPoisson(3), tg[0]
    b, fr, fb = _halves(v, f)
    r, b2 = R.timeskew_relax_halves(b, fr, fb, 3, prob, g)
    b_other = b.clone()
    b_other[0] = 123.0
    r2, b3 = R.timeskew_relax_halves(b_other, fr, fb, 3, prob, g)
    assert torch.equal(r, r2) and torch.equal(b2, b3)
    assert not r[0].any() and not b2[0].any()


def test_black_only_split():
    """split(v, red=False), the wavefront's split of the iterate, gives
    the black half of the full split and no red half; the dense relax
    through it equals split, sweeps and merge by hand."""
    _, tg, v, f = _level(17, seed=75)
    prob, g = TPoisson(3), tg[0]
    vt, ft = torch.tensor(v), torch.tensor(f)
    r, b = R.split(vt, red=False)
    assert r is None and torch.equal(b, R.split_colors(vt)[1])
    b, fr, fb = _halves(v, f)
    want = R.merge_colors(*R.timeskew_sweeps_plain(b, fr, fb, 3, prob, g))
    got = R.make_timeskew_relax(prob, g)(vt, ft, 3)
    assert got is vt and torch.equal(got, want)


def test_wrapper_refusals():
    """Wrong dtype, non-contiguous halves, odd extents, a non-wrap or 2D
    level, another device and an empty leg raise; nothing falls back."""
    _, tg, v, f = _level(9, seed=80)
    prob, g = TPoisson(3), tg[0]
    b, fr, fb = _halves(v, f)
    with pytest.raises(TypeError, match="float32"):
        R.timeskew_relax_halves(b.double(), fr.double(), fb.double(), 1,
                                prob, g)
    with pytest.raises(ValueError, match="contiguous"):
        R.timeskew_relax_halves(b, fr.transpose(0, 2).contiguous()
                                .transpose(0, 2), fb, 1, prob, g)
    odd = TG.build_geometries((9, 10, 9), DOM, 1, wrap=True)[0]
    with pytest.raises(ValueError):
        R.timeskew_relax_halves(b, fr, fb, 1, prob, odd)
    odd_z = TG.build_geometries((9, 9, 10), DOM, 1, wrap=True)[0]
    hz = torch.zeros((8, 4, 9))
    with pytest.raises(ValueError, match="even Z"):
        R.timeskew_relax_halves(hz, hz, hz, 1, prob, odd_z)
    padded = TG.build_geometries((9,) * 3, DOM, 1, wrap=False)[0]
    with pytest.raises(ValueError):
        R.timeskew_relax_halves(b, fr, fb, 1, prob, padded)
    with pytest.raises(ValueError, match="no kernel for device"):
        R.timeskew_relax_halves(*(torch.zeros(b.shape, device="meta")
                                  for _ in range(3)), 1, prob, g)
    with pytest.raises(ValueError, match="nsweeps"):
        R.timeskew_relax_halves(b, fr, fb, 0, prob, g)
    with pytest.raises(ValueError, match="nsweeps"):
        R.timeskew_sweeps_plain(b, fr, fb, 0, prob, g)


# ---------------------------------------------------- (d) launch layout

# the halves levels of the bench's wavefront (256^3, 512^3) and the
# odd-tiled levels chip_smoke.py holds the kernel bitwise on
LAYOUT_LEVELS = [(256, 128, 256), (512, 256, 512), (10, 13, 38),
                 (64, 65, 100), (16, 8, 16), (8, 16, 32)]


@pytest.mark.parametrize("T", range(1, R.TIMESKEW_MAX_T + 1))
@pytest.mark.parametrize("shape", LAYOUT_LEVELS)
def test_timeskew_layout_owns_every_column_once(shape, T):
    """Every (j, z) column of the level is written by exactly one CTA
    row of exactly one band: a row's threads cover its Z points (K each),
    and a band's owned rows lie 2T rows inside its computed ones unless
    its ring is the level's own j wrap.  The cluster has at most 16 CTAs,
    a CTA at most 512 threads and 232 448 B of shared memory."""
    X, Y2, Z = shape
    for k in ((4, 2) if Z % 4 == 0 else (2,)):
        lay = R.timeskew_layout(X, Y2, Z, T, k=k)
        assert lay["k"] == k and Z % k == 0
        assert 1 <= lay["ctas"] <= 16 and lay["ctas"] in (1, 2, 4, 8, 16)
        assert lay["threads"] >= lay["rows"] * Z // k
        assert lay["threads"] <= 512 and lay["threads"] % 32 == 0
        assert lay["smem_bytes"] <= 232448 - 16
        rows = R.timeskew_rows(lay, Y2)
        owned = sorted(j for j, own in rows if own)
        assert owned == list(range(Y2))
        if lay["halo"] == 0:
            assert lay["bands"] == 1 and lay["ctas"] * lay["rows"] == Y2
            assert sorted(j for j, _ in rows) == list(range(Y2))
        else:
            assert lay["halo"] == 2 * T
            per = lay["ctas"] * lay["rows"]
            for b in range(lay["bands"]):
                pos = [p for p in range(per) if rows[b * per + p][1]]
                assert all(2 * T <= p < per - 2 * T for p in pos)


def test_timeskew_layout_pins():
    """The bench's levels at T = TIMESKEW_T: 256^3 one 16-CTA cluster of
    8 whole rows a CTA, the level's j wrap its ring (no halo at all);
    512^3 six bands of 48 owned rows on 16 CTAs of 4 rows."""
    T = R.TIMESKEW_T
    lay = R.timeskew_layout(256, 128, 256, T)
    assert (lay["ctas"], lay["rows"], lay["halo"], lay["bands"],
            lay["threads"]) == (16, 8, 0, 1, 512)
    lay = R.timeskew_layout(512, 256, 512, T)
    assert (lay["ctas"], lay["rows"], lay["band"], lay["halo"],
            lay["bands"], lay["threads"]) == (16, 4, 48, 8, 6, 512)


@pytest.mark.parametrize("clusters", [1, 7, 8, 60])
@pytest.mark.parametrize("shape", LAYOUT_LEVELS)
def test_timeskew_x_chunks_cover_the_window(shape, clusters):
    """The x chunks cover the window exactly: chunks of lx (even) planes,
    the last one not empty, every chunk starting on an even plane, at
    every T, for the whole level and for a shard chunk's narrower
    windows."""
    X, Y2, Z = shape
    for T in range(1, R.TIMESKEW_MAX_T + 1):
        for W in (X, max(2, X - 4 * T), 2):
            lay = R.timeskew_layout(X, Y2, Z, T, clusters, window=W)
            assert lay["lx"] % 2 == 0 and lay["lx"] >= 2
            assert lay["chunks"] * lay["lx"] >= W
            assert (lay["chunks"] - 1) * lay["lx"] < W


def test_timeskew_redundancy():
    """Updates computed / updates needed at T = TIMESKEW_T with the 7
    resident 16-CTA clusters of an H100 (PERF.md): at most 1.44 at 256^3
    (x warm-up only) and 1.55 at 512^3 (band halos and warm-up)."""
    T = R.TIMESKEW_T
    lay = R.timeskew_layout(256, 128, 256, T, clusters=7)
    assert lay["redundancy"] <= 1.44
    lay = R.timeskew_layout(512, 256, 512, T, clusters=7)
    assert lay["redundancy"] <= 1.55


@pytest.mark.parametrize("x_loc", [8, 64, 256])
@pytest.mark.parametrize("t", range(1, 2 * R.TIMESKEW_T + 2))
def test_shard_windows_end_on_the_owned_window(t, x_loc):
    """A t-sweep shard chunk: its launches run t sweeps in all, T =
    TIMESKEW_T each but the last remainder; the last writes the owned
    window [2t, 2t + x_loc), each earlier one that window widened by the
    2 x sweeps planes the next one reads on either side, inside the slab
    of x_loc + 4t planes."""
    wins = R.shard_windows(t, x_loc)
    assert [tk for tk, _, _ in wins] == R.leg_launches(t)
    assert sum(tk for tk, _, _ in wins) == t
    assert wins[-1][1:] == (2 * t, 2 * t + x_loc)
    for (_, lo, hi), (tk, lo2, hi2) in zip(wins, wins[1:]):
        assert (lo, hi) == (lo2 - 2 * tk, hi2 + 2 * tk)
    assert 0 <= wins[0][1] and wins[0][2] <= x_loc + 4 * t
    assert all(lo % 2 == 0 for _, lo, _ in wins)


# ------------------------------------------------------------- (e) plan


def _kernels(n, mixed=False):
    geoms = TG.build_geometries((n,) * 3, DOM, {129: 2, 257: 3, 513: 4}[n],
                                wrap=True)
    return geoms, CudaKernels(TPoisson(3), geoms, torch.float32,
                              range(len(geoms) - 1), mixed=mixed)


def _is_wavefront(fn):
    return fn is not None and fn.__qualname__.startswith(
        R.make_timeskew_relax.__name__)


def _wavefront_levels(k):
    return [_is_wavefront(fn) for fn in k._relax]


def test_plan_pins():
    """The exact-coarsest hierarchies of the bench's 3D rows: 129^3 has
    no wavefront; 257^3 takes it on 256^3 and the half-sweeps on 128^3;
    513^3 on 512^3 and 256^3.  The gate is JAX's: the same levels as its
    timeskew_plan, the same 16384-point threshold."""
    geoms, k = _kernels(129)
    assert [g.padded_shape[0] for g in geoms] == [128, 64]
    assert _wavefront_levels(k) == [False, False]
    geoms, k = _kernels(257)
    assert [g.padded_shape[0] for g in geoms] == [256, 128, 64]
    assert _wavefront_levels(k) == [True, False, False]
    assert k._relax[1] is not None
    geoms, k = _kernels(513)
    assert [g.padded_shape[0] for g in geoms] == [512, 256, 128, 64]
    assert _wavefront_levels(k) == [True, True, False, False]
    for n in (129, 257, 513):
        for g in TG.build_geometries((n,) * 3, DOM, wrap=True):
            want = JR.timeskew_plan(g.padded_shape) is not None
            assert R.timeskew_plan(g) == want, g.padded_shape
    assert R.TIMESKEW_MIN_PLANE == 16384
    for shape, engaged in (((8, 256, 128), True), ((8, 240, 128), False),
                           ((6, 256, 128), False)):
        assert (JR.timeskew_plan(shape) is not None) == engaged
        g = TG.LevelGeometry(shape=tuple(n + 1 for n in shape),
                             spacing=(0.1,) * 3, origin=(0.0,) * 3,
                             domain=DOM, wrap=True)
        assert g.padded_shape == shape
        assert R.timeskew_plan(g) == engaged


def test_mixed_plan_keeps_the_defect_path():
    """With mixed, every relaxed 513^3 level keeps its defect plan
    (min_sweeps 4); a 3-sweep leg at 512^3 takes the level's float32
    relax, the wavefront, and a 4-sweep leg the defect path."""
    _, k = _kernels(513, mixed=True)
    assert all(d is not None and d.min_sweeps == D.RESIDENT_MIN_SWEEPS == 4
               for d in k._defect[:3])
    assert k._defect[3] is None
    assert _is_wavefront(k._relax[0])
    taken = []
    k._relax[0] = lambda v, f, n: taken.append(("wavefront", n))
    stub = lambda v, f, n: taken.append(("defect", n))  # noqa: E731
    stub.min_sweeps = D.RESIDENT_MIN_SWEEPS
    k._defect[0] = stub
    for n in (3, 4, 100):
        k.relax(0, None, None, None, n)
    assert taken == [("wavefront", 3), ("defect", 4), ("defect", 100)]


# ------------------------------------------------------------ (f) slice


def test_fmg_slice_through_the_wavefront_matches_jax(monkeypatch):
    """FMG(1,4,4), exact coarsest, at 33^3 through CudaKernels on CPU
    tensors, with the gate lowered so that the 32^3 level takes the
    wavefront (its plain version: both of the level's legs; the whole-leg
    resident kernel, which JAX's plan order puts first, given no shared
    memory so that it holds no level), against
    JAX's backend="jnp" solve from the same levels.  Tolerances: the
    logical solution within 1e-5 of max|v| (a few float32 ulp: the where
    form and the blend form round differently), error_linf to 1e-4
    relative, the residual history to 1e-3 relative (the float32 exact
    coarse solve sums in another order, tests/test_torch_solver.py)."""
    monkeypatch.setattr(R, "TIMESKEW_MIN_PLANE", 16 * 32)
    monkeypatch.setattr(RS3, "MAX_SMEM_BYTES", 0)
    calls = []
    plain = R.timeskew_sweeps_plain

    def counted(*args, **kw):
        calls.append(args[3])
        return plain(*args, **kw)

    monkeypatch.setattr(R, "timeskew_sweeps_plain", counted)
    cyc = dict(kind="fmg", nu0=1, nu1=4, nu2=4, coarsest="exact")
    js = J.MultigridSolver(J.Poisson3D(), 33, J.SolverConfig(
        cycle=J.CycleConfig(**cyc), backend="jnp", max_cycles=2, tol=0.0))
    ts = MultigridSolver(TPoisson(3), 33, SolverConfig(
        cycle=CycleConfig(**cyc), max_cycles=2, tol=0.0), device="cpu")
    kern = CudaKernels(ts.problem, ts.geoms, torch.float32,
                       range(len(ts.geoms) - 1))
    assert _wavefront_levels(kern) == [True, False]
    ts.program = CycleProgram(ts.problem, ts.geoms, ts.config.cycle, kern)
    jl = js.fresh_levels()
    arrays = [{"v": np.asarray(l.v), "f": np.asarray(l.f),
               "aux": {k: np.asarray(a) for k, a in l.aux.items()}}
              for l in jl]
    tl = levels_from_numpy(ts.geoms, arrays)
    jr, tr = js.solve_to_tolerance(jl), ts.solve_to_tolerance(tl)
    assert calls == [4] * 4  # two legs per FMG step, two steps
    a = to_logical(np.asarray(jr.v), js.geoms[0])
    b = to_logical(tr.v, ts.geoms[0])
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-5 * np.abs(a).max())
    np.testing.assert_allclose(tr.error_linf, jr.error_linf, rtol=1e-4)
    assert len(tr.residual_history) == len(jr.residual_history) == 2
    np.testing.assert_allclose(tr.residual_history, jr.residual_history,
                               rtol=1e-3)
    h = ts.geoms[0].spacing[0]
    assert tr.error_linf < 50 * h * h
