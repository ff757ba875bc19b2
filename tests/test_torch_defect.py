"""Port parity of the bf16 defect-correction relax (`precision="mixed"`):
the plain versions of `ops/cuda/defect.py` and `relax.error_sweeps`
(what the wrappers run for CPU tensors) against the JAX package's Pallas
kernels in interpret mode, the plan, and the mixed FMG slice against the
JAX pallas tier.

Tolerances.  On the card, with --fmad=false, each kernel matches its
plain version bit for bit (`chip_smoke.py`).  XLA's CPU backend, which
runs the interpreted Pallas kernels here, contracts `a*b - c` into fused
multiply-adds: an f32 value then differs by an ulp and may flip a bf16
rounding.  So the residual halves agree to 1 bf16 ulp (almost all
bitwise), the error sweeps to 2^-7 of max|e|, the fold (one exact widen
and one add) bitwise, and a whole defect leg to 0.02 of the change it
makes, the bound of tests/test_mixed.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pde_multigrid_tpu as J
from pde_multigrid_tpu import grid as JG
from pde_multigrid_tpu.models import Poisson as JPoisson
from pde_multigrid_tpu.ops import stencil as JS
from pde_multigrid_tpu.ops.pallas import defect as JD
from pde_multigrid_tpu.ops.pallas import relax as JR
from pde_multigrid_tpu_torch import CycleConfig, MultigridSolver, SolverConfig
from pde_multigrid_tpu_torch import grid as TG
from pde_multigrid_tpu_torch.cycles import CycleProgram
from pde_multigrid_tpu_torch.grid import to_logical
from pde_multigrid_tpu_torch.models import Poisson as TPoisson
from pde_multigrid_tpu_torch.ops.cuda import defect as D
from pde_multigrid_tpu_torch.ops.cuda import relax as R
from pde_multigrid_tpu_torch.ops.cuda import transfer as T
from pde_multigrid_tpu_torch.ops.cuda.dispatch import CudaKernels

F32 = jnp.dtype("float32")
DOM = ((0.0, 1.0),) * 3


def _level(n, seed):
    """Wrap geometries of both packages and float32 (v, f); v keeps the
    wrap invariant (stored plane 0 zero)."""
    jg = JG.build_geometries((n,) * 3, DOM, wrap=True)
    tg = TG.build_geometries((n,) * 3, DOM, wrap=True)
    rng = np.random.default_rng(seed)
    shape = jg[0].padded_shape
    v = (rng.standard_normal(shape) * TG.wrap_interior(shape)).astype(
        np.float32)
    f = rng.standard_normal(shape).astype(np.float32)
    return jg, tg, v, f


def _bf16(a: torch.Tensor) -> jnp.ndarray:
    """The same bf16 values as a JAX array (exact: through float32)."""
    return jnp.asarray(a.to(torch.float32).numpy()).astype(jnp.bfloat16)


def _ordered(bits: np.ndarray) -> np.ndarray:
    """bf16 bit patterns (int16) -> integers in value order, so adjacent
    representable values differ by 1 (across zero as well)."""
    b = bits.astype(np.int32)
    return np.where(b < 0, -(b & 0x7FFF), b)


@pytest.fixture(autouse=True)
def _no_launches():
    """CPU tensors never launch a kernel: every counter stays at zero."""
    for mod in (R, T, D):
        mod.reset_launches()
    yield
    for mod in (R, T, D):
        assert not any(mod.launches.values()), mod.launches


# --------------------------------------------------------------- kernels


@pytest.mark.parametrize("domain", [DOM, ((0.0, 1.0), (0.0, 2.0),
                                          (0.0, 4.0))], ids=["iso", "aniso"])
def test_split_update_folded_matches(domain):
    """Poisson.split_update_folded against the JAX form on identical pair
    sums, float32, both spacing forms; XLA may contract a product into
    the final sum, so a few ulp of the result.  Same fixed point as
    split_update, to rounding."""
    jg = JG.build_geometries((17,) * 3, domain, wrap=True)[0]
    tg = TG.build_geometries((17,) * 3, domain, wrap=True)[0]
    rng = np.random.default_rng(27)
    pairs = [rng.standard_normal(jg.padded_shape).astype(np.float32)
             for _ in range(4)]
    f = pairs.pop()
    want = np.asarray(JPoisson(3, domain=domain).split_update_folded(
        [jnp.asarray(p) for p in pairs], jnp.asarray(f), jg))
    tp = TPoisson(3, domain=domain)
    got = tp.split_update_folded([torch.tensor(p) for p in pairs],
                                 torch.tensor(f), tg)
    assert got.dtype == torch.float32
    ulp = np.spacing(np.float32(np.abs(want).max()))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=4 * ulp)
    plain = tp.split_update([torch.tensor(p) for p in pairs],
                            torch.tensor(f), tg)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=0,
                               atol=4 * ulp)


def test_residual_split_matches_pallas():
    """(a) residual_split against make_residual_split (needs Z % 128 == 0,
    so the 129^3 level): >= 99.9 % of points bitwise, all within one
    bf16 ulp (an FMA-contracted f32 residual can flip a rounding)."""
    jg, tg, v, f = _level(129, seed=21)
    rs = JD.make_residual_split(JPoisson(3), jg[0], F32, jnp.bfloat16,
                                interpret=True)
    want = rs(jnp.asarray(v), jnp.asarray(f))
    got = D.residual_split(torch.tensor(v), torch.tensor(f), TPoisson(3),
                           tg[0])
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        a = _ordered(g.view(torch.int16).numpy())
        b = _ordered(np.asarray(w).view(np.int16))
        assert np.mean(a == b) >= 0.999
        assert np.max(np.abs(a - b)) <= 1


@pytest.mark.parametrize("nsweeps", [1, 2, 5])
@pytest.mark.parametrize("B", [8, 16])
@pytest.mark.parametrize("n", [33, 129])
def test_error_sweeps_match_resident_kernel(n, B, nsweeps):
    """(b) error_sweeps against make_split_resident_sweeps (bf16 storage,
    f32 compute, from e = 0) on the same bf16 residual halves.  The
    halves are random everywhere, boundary planes included: both sides
    must ignore r there, so this also shows that the port's masks with
    wrapped neighbours equal the TPU kernel's zero padding rows plus its
    re-zeroed row 0 (relax.py:1345-1358, :1419-1421)."""
    jg, tg, _, _ = _level(n, seed=n + B)
    rng = np.random.default_rng(100 * n + B)
    shape = R._halves_shape(tg[0].padded_shape)
    rr, rb = (torch.tensor(rng.standard_normal(shape).astype(np.float32))
              .to(torch.bfloat16) for _ in range(2))
    fn = JR.make_split_resident_sweeps(
        JPoisson(3), jg[0], jnp.bfloat16, B, interpret=True,
        compute_dtype=jnp.float32,
    )
    want = fn(None, None, _bf16(rr), _bf16(rb), nsweeps, v_zero=True)
    got = R.error_sweeps(rr, rb, nsweeps, TPoisson(3), tg[0])
    want = [np.asarray(w.astype(jnp.float32)) for w in want]
    got = [g.to(torch.float32).numpy() for g in got]
    scale = max(np.abs(w).max() for w in want)
    for g, w in zip(got, want):
        assert np.max(np.abs(g - w)) <= 2.0 ** -7 * scale


def test_merge_fold_matches_pallas():
    """(c) merge_fold against make_merge_fold at 129^3: bitwise, and in
    place into v."""
    jg, tg, v, _ = _level(129, seed=23)
    rng = np.random.default_rng(24)
    shape = R._halves_shape(tg[0].padded_shape)
    er, eb = (torch.tensor(rng.standard_normal(shape).astype(np.float32))
              .to(torch.bfloat16) for _ in range(2))
    mf = JD.make_merge_fold(jg[0], jnp.bfloat16, F32, interpret=True)
    want = np.asarray(mf(_bf16(er), _bf16(eb), jnp.asarray(v)))
    vt = torch.tensor(v)
    got = D.merge_fold(er, eb, vt)
    assert got is vt
    np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------------------- defect leg


def _direct(jg, v, f, n):
    """The direct f32 red-black sweeps of the JAX jnp tier."""
    prob = JPoisson(3)
    aux = JG.base_aux(jg[0], jnp.float32)
    return np.asarray(JS.relax_rbgs(
        lambda vv, ff: prob.relax_update(vv, ff, jg[0], aux),
        jnp.asarray(v), jnp.asarray(f), aux["m_red"], aux["m_black"], n,
    ))


def test_defect_leg_matches_pallas_and_direct():
    """(d) one bf16 defect leg, port plan vs JAX plan_defect_relax, both
    within 0.02 of the change a leg makes from the direct f32 sweeps and
    from each other (the bound of tests/test_mixed.py:76-84)."""
    jg, tg, v, f = _level(129, seed=25)
    jfn = JD.plan_defect_relax(JPoisson(3), jg[0], F32, interpret=True)
    tfn = D.plan_defect_relax(TPoisson(3), tg[0], torch.float32)
    assert jfn is not None and tfn is not None
    jax_v = np.asarray(jfn(jnp.asarray(v), jnp.asarray(f), 5))
    port_v = tfn(torch.tensor(v), torch.tensor(f), 5).numpy()
    want = _direct(jg, v, f, 5)
    scale = np.max(np.abs(want - v))
    assert np.max(np.abs(port_v - want)) < 0.02 * scale
    assert np.max(np.abs(jax_v - want)) < 0.02 * scale
    assert np.max(np.abs(port_v - jax_v)) < 0.02 * scale


def test_f32_error_smoother_is_the_direct_smoother():
    """(e) with float32 storage the plain defect form is algebraically
    the direct iteration (test_defect_relax_f32_inner_is_identity); only
    re-association separates them.  The CUDA wrapper takes bf16 only."""
    _, tg, v, f = _level(33, seed=26)
    prob, g = TPoisson(3), tg[0]
    vt, ft = torch.tensor(v), torch.tensor(f)
    rr, rb = D.residual_split_plain(vt, ft, prob, g, dtype=torch.float32)
    er, eb = R.error_sweeps_plain(rr, rb, 4, prob, g)
    got = D.merge_fold_plain(er, eb, vt)
    want = R.make_split_relax(prob, g)(vt.clone(), ft, 4)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=3e-5,
                               atol=3e-6)
    with pytest.raises(TypeError, match="bfloat16"):
        R.error_sweeps(rr, rb, 4, prob, g)


# -------------------------------------------------------------------- plan


class _NotPoisson:
    name = "other"


def test_mixed_plan_pins():
    """(f) CudaKernels(mixed=True) on the 129^3 exact-coarsest geometries:
    a defect plan on level 0 with min_sweeps 4, its error sweeps the
    whole-leg kernel (one launch a leg at any nu), none on the exact
    level; a leg of < 4 sweeps takes the f32 split relax.  float64 still
    raises; padded 3D storage and 2D Poisson relax in float32."""
    prob = TPoisson(3)
    geoms = TG.build_geometries((129,) * 3, DOM, 2, wrap=True)
    k = CudaKernels(prob, geoms, torch.float32, range(len(geoms) - 1),
                    mixed=True)
    assert k._defect[0] is not None and k._defect[-1] is None
    assert k._defect[0].min_sweeps == D.RESIDENT_MIN_SWEEPS == 4
    assert k._defect[0].form == R.error_form(geoms[0]) == "leg"
    assert [k._defect[0].launches(n) for n in (4, 100, 3000)] == [1, 1, 1]
    assert D.MIXED_MIN_SWEEPS == JD.MIXED_MIN_SWEEPS
    assert D.RESIDENT_MIN_SWEEPS == JD.RESIDENT_MIN_SWEEPS
    taken = []
    k._relax[0] = lambda v, f, n: taken.append(("f32", n))
    stub = lambda v, f, n: taken.append(("defect", n))  # noqa: E731
    stub.min_sweeps = D.RESIDENT_MIN_SWEEPS
    k._defect[0] = stub
    for n in (1, 3, 4, 100):
        k.relax(0, None, None, None, n)
    assert taken == [("f32", 1), ("f32", 3), ("defect", 4), ("defect", 100)]
    # without mixed, no level has a defect plan
    k32 = CudaKernels(prob, geoms, torch.float32, range(len(geoms) - 1))
    assert all(fn is None for fn in k32._defect)

    padded = TG.build_geometries((17,) * 3, DOM, wrap=False)
    assert D.plan_defect_relax(prob, geoms[0], torch.float64) is None
    assert D.plan_defect_relax(prob, padded[0], torch.float32) is None
    assert D.plan_defect_relax(_NotPoisson(), geoms[0], torch.float32) is None
    with pytest.raises(NotImplementedError):
        CudaKernels(prob, geoms, torch.float64, mixed=True)
    # padded 3D levels are planned; with mixed they relax in float32 (no
    # defect plan covers a padded level), as JAX's do
    kp = CudaKernels(prob, padded, torch.float32, mixed=True)
    assert all(d is None for d in kp._defect)
    assert kp.tiers == ["padded3d"] * len(padded)
    # 2D Poisson is planned; with mixed its levels relax in float32 (no
    # defect plan covers a 2D level), as JAX's do
    k2 = CudaKernels(TPoisson(2), TG.build_geometries(
        (17, 17), ((0.0, 1.0),) * 2, wrap=True), torch.float32, mixed=True)
    assert all(d is None for d in k2._defect)
    assert all(fn is not None for fn in k2._relax)


# ------------------------------------------------------------------- slice


def test_mixed_fmg_slice_matches_jax_pallas():
    """(g) FMG(1,4,4) exact coarsest at 129^3 with precision="mixed": the
    port's CUDA-tier plan on CPU tensors (plain versions) against the JAX
    pallas tier in interpret mode, from the same initial levels.  Both
    legs of level 0 take the defect path (4 >= min_sweeps).  Both reach
    discretization accuracy, and they agree far below it."""
    cyc = dict(kind="fmg", nu0=1, nu1=4, nu2=4, coarsest="exact")
    js = J.MultigridSolver(
        J.Poisson(3), 129,
        J.SolverConfig(cycle=J.CycleConfig(**cyc), backend="pallas",
                       precision="mixed"),
    )
    assert js.program.kernels._defect_fns[0] is not None
    ts = MultigridSolver(TPoisson(3), 129, SolverConfig(
        cycle=CycleConfig(**cyc), precision="mixed"), device="cpu")
    kernels = CudaKernels(ts.problem, ts.geoms, torch.float32,
                          range(len(ts.geoms) - 1), mixed=True)
    ts.program = CycleProgram(ts.problem, ts.geoms, ts.config.cycle, kernels)
    assert [g.shape for g in ts.geoms] == [g.shape for g in js.geoms]

    jl = js.fresh_levels()
    tl = ts.fresh_levels()
    for a, b, g in zip(jl, tl, ts.geoms):
        crop = tuple(slice(0, s) for s in g.padded_shape)
        b.v = torch.tensor(np.asarray(a.v)[crop])
        b.f = torch.tensor(np.asarray(a.f)[crop])
    jr, tr = js.solve(jl), ts.solve(tl)
    h = ts.geoms[0].spacing[0]
    assert jr.error_linf < 50 * h * h and tr.error_linf < 50 * h * h
    a = to_logical(np.asarray(jr.v), js.geoms[0])
    b = to_logical(tr.v, ts.geoms[0])
    assert np.max(np.abs(a - b)) <= 0.1 * jr.error_linf
