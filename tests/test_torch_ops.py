"""Port parity: the plain tensor ops, the Poisson problem, the
fast-diagonalization solve and the config gates, against the JAX package.

Ops compare in float64 at rtol 1e-12 (jax x64 is on in this suite, and
both sides run the same operation order).  The fast-diagonalization solve
accumulates its contractions in float32 on both sides (the JAX solve does
so even for float64 input, fastdiag.py:180-186), so it compares in
float32, at a tolerance stated where it is used."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pde_multigrid_tpu import grid as JG
from pde_multigrid_tpu.models import Poisson as JPoisson
from pde_multigrid_tpu.ops import fastdiag as JF
from pde_multigrid_tpu.ops import stencil as JS
from pde_multigrid_tpu_torch import CycleConfig, SolverConfig
from pde_multigrid_tpu_torch import grid as TG
from pde_multigrid_tpu_torch.models import Poisson as TPoisson
from pde_multigrid_tpu_torch.ops import fastdiag as TF
from pde_multigrid_tpu_torch.ops import stencil as TS

RTOL = 1e-12


def _pair(shape, wrap, dtype=np.float64, seed=0):
    """(jax geom, torch geom, jax aux, torch aux, v, f) at `shape`; v is
    zero on the boundary (wrap invariant: stored plane 0 stays zero)."""
    dom = ((0.0, 1.0),) * len(shape)
    jg = JG.build_geometries(shape, dom, wrap=wrap)
    tg = TG.build_geometries(shape, dom, wrap=wrap)
    jdt = jnp.float64 if dtype == np.float64 else jnp.float32
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    ja = [JG.base_aux(g, jdt) for g in jg]
    ta = [TG.base_aux(g, tdt) for g in tg]
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(jg[0].padded_shape).astype(dtype)
    v *= np.asarray(ja[0]["m_int"]).astype(dtype)
    f = rng.standard_normal(jg[0].padded_shape).astype(dtype)
    return jg, tg, ja, ta, v, f


CASES = [((17, 17, 17), True), ((17, 17, 17), False), ((17, 33, 17), True)]


@pytest.mark.parametrize("shape,wrap", CASES, ids=str)
def test_relax_rbgs_matches(shape, wrap):
    jg, tg, ja, ta, v, f = _pair(shape, wrap)
    jp, tp = JPoisson(len(shape)), TPoisson(len(shape))
    want = JS.relax_rbgs(
        lambda a, b: jp.relax_update(a, b, jg[0], ja[0]), jnp.asarray(v),
        jnp.asarray(f), ja[0]["m_red"], ja[0]["m_black"], 3,
    )
    got = TS.relax_rbgs(
        lambda a, b: tp.relax_update(a, b, tg[0], ta[0]), torch.tensor(v),
        torch.tensor(f), ta[0]["m_red"], ta[0]["m_black"], 3,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=1e-13)


@pytest.mark.parametrize("shape,wrap", CASES, ids=str)
def test_residual_and_operator_match(shape, wrap):
    jg, tg, ja, ta, v, f = _pair(shape, wrap)
    jp, tp = JPoisson(len(shape)), TPoisson(len(shape))
    want = JS.residual(lambda a: jp.apply_operator(a, jg[0], ja[0]),
                       jnp.asarray(v), jnp.asarray(f), ja[0]["m_int"])
    got = TS.residual(lambda a: tp.apply_operator(a, tg[0], ta[0]),
                      torch.tensor(v), torch.tensor(f), ta[0]["m_int"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=1e-9)
    # the kernel-side form is the same operator in the same order
    roll = lambda a, ax, off: torch.roll(a, -off, dims=ax)
    np.testing.assert_allclose(
        tp.kernel_operator(torch.tensor(v), tg[0], roll).numpy(),
        np.asarray(jp.apply_operator(jnp.asarray(v), jg[0], ja[0])),
        rtol=RTOL, atol=1e-9,
    )


@pytest.mark.parametrize("shape,wrap", CASES, ids=str)
def test_restrict_full_weighting_matches(shape, wrap):
    jg, tg, ja, ta, v, f = _pair(shape, wrap)
    want = JS.restrict_full_weighting(jnp.asarray(f), ja[1]["m_int"],
                                      ja[1]["m_log"])
    got = TS.restrict_full_weighting(torch.tensor(f), ta[1]["m_int"],
                                     ta[1]["m_log"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=1e-14)
    np.testing.assert_array_equal(
        TS._subsample2(torch.tensor(f)).numpy(),
        np.asarray(JS._subsample2(jnp.asarray(f))),
    )


@pytest.mark.parametrize("shape,wrap", CASES, ids=str)
def test_prolong_linear_matches(shape, wrap):
    jg, tg, ja, ta, _, _ = _pair(shape, wrap)
    c = np.random.default_rng(5).standard_normal(jg[1].padded_shape)
    c *= np.asarray(ja[1]["m_int"])
    want = JS.prolong_linear(jnp.asarray(c), jg[0].padded_shape,
                             periodic=wrap)
    got = TS.prolong_linear(torch.tensor(c), tg[0].padded_shape,
                            periodic=wrap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=1e-14)


def test_correction_and_set_interior_match():
    jg, tg, ja, ta, v, f = _pair((17, 17, 17), False)
    m_j, m_t = ja[0]["m_int"], ta[0]["m_int"]
    np.testing.assert_allclose(
        TS.apply_correction(torch.tensor(v), torch.tensor(f), m_t).numpy(),
        np.asarray(JS.apply_correction(jnp.asarray(v), jnp.asarray(f), m_j)),
        rtol=RTOL, atol=1e-14,
    )
    np.testing.assert_allclose(
        TS.set_interior(torch.tensor(f), 0.25, m_t).numpy(),
        np.asarray(JS.set_interior(jnp.asarray(f), 0.25, m_j)),
        rtol=RTOL, atol=1e-14,
    )


def test_split_update_matches():
    """Color-split local solve on identical pair sums (float32: the
    weights round to float32 on both sides)."""
    jg, tg, _, _, v, f = _pair((17, 17, 17), True, np.float32)
    rng = np.random.default_rng(9)
    pairs = [rng.standard_normal(v.shape).astype(np.float32)
             for _ in range(3)]
    want = JPoisson(3).split_update([jnp.asarray(p) for p in pairs],
                                    jnp.asarray(f), jg[0])
    got = TPoisson(3).split_update([torch.tensor(p) for p in pairs],
                                   torch.tensor(f), tg[0])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------- fastdiag


@pytest.mark.parametrize("n", [17, 33])
def test_fastdiag_matches_jax_float32(n):
    """float32 on both sides; the contractions sum in different orders
    (XLA's dot vs torch's matmul), so the solutions agree to float32
    rounding amplified by the spectral transforms: 1e-5 of max|v|."""
    jg, tg, ja, ta, _, f = _pair((n,) * 3, True, np.float32, seed=3)
    f = f * np.asarray(ja[0]["m_int"])
    want = np.asarray(JF.make_fastdiag_solve(JPoisson(3), jg[0])(
        jnp.asarray(f)))
    got = TF.make_fastdiag_solve(TPoisson(3), tg[0])(torch.tensor(f))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("domain", [((0.0, 1.0),) * 3,
                                    ((0.0, 1.0), (0.0, 2.0), (0.0, 4.0))],
                         ids=["iso", "aniso"])
def test_fastdiag_reproduces_rhs(domain):
    """A v = f on the interior, v = 0 on the boundary planes (float32
    round-off times the operator's condition number)."""
    prob = TPoisson(3, domain=domain)
    h = TG.Hierarchy.build(prob, 33, wrap=True)
    geom, lvl = h.geoms[0], h.levels[0]
    m = lvl.aux["m_int"]
    rng = np.random.default_rng(4)
    f = torch.tensor(rng.standard_normal(geom.padded_shape),
                     dtype=torch.float32) * m
    v = TF.make_fastdiag_solve(prob, geom)(f)
    assert float(torch.max(torch.abs(v * (1 - m)))) == 0.0
    r = (prob.apply_operator(v, geom, lvl.aux) - f) * m
    scale = float(torch.max(torch.abs(f)))
    assert float(torch.max(torch.abs(r))) < 5e-4 * scale * 33**2


def test_coarse_solve_requires_fastdiag():
    """Fast diagonalization needs wrap storage; a small padded level takes
    the probed dense inverse instead (it solves A v = f on the interior),
    and a level too big for either raises."""
    prob = TPoisson(3)
    h = TG.Hierarchy.build(prob, 9, wrap=False)
    padded, lvl = h.geoms[0], h.levels[0]
    assert TF.make_fastdiag_solve(prob, padded) is None
    solve = TF.make_coarse_solve(prob, padded)
    m = lvl.aux["m_int"]
    f = torch.tensor(np.random.default_rng(5).standard_normal(
        padded.padded_shape), dtype=torch.float32) * m
    v = solve(lvl.v, f, lvl.aux)
    r = (prob.apply_operator(v, padded, lvl.aux) - f) * m
    assert float(torch.max(torch.abs(r))) < 1e-3 * float(torch.max(f.abs()))
    big = TG.build_geometries((33,) * 3, prob.domain, wrap=False)[0]
    with pytest.raises(ValueError, match="no direct solve"):
        TF.make_coarse_solve(prob, big)
    wrapped = TG.build_geometries((9,) * 3, prob.domain, wrap=True)[0]
    assert TF.make_coarse_solve(prob, wrapped) is not None


def test_sine_basis_matches():
    for n_int, h in [(15, 1 / 16), (31, 1 / 32)]:
        qj, lj = JF.dirichlet_sine_basis(n_int, h)
        qt, lt = TF.dirichlet_sine_basis(n_int, h)
        np.testing.assert_array_equal(qt, qj)
        np.testing.assert_array_equal(lt, lj)
    g = JG.build_geometries((17,) * 3, ((0.0, 1.0),) * 3, wrap=True)[0]
    tg = TG.build_geometries((17,) * 3, ((0.0, 1.0),) * 3, wrap=True)[0]
    for (qa, la), (qb, lb) in zip(JF.padded_axis_mats(g, np.float32),
                                  TF.padded_axis_mats(tg, np.float32)):
        np.testing.assert_array_equal(qa, qb)
        np.testing.assert_array_equal(la, lb)


# ------------------------------------------------------------------ config


@pytest.mark.parametrize(
    "kwargs",
    [
        dict(smoother="line-2"),
        dict(smoother="line-0"),
        dict(mu=2),
        dict(scheme="fas", mu=2),
        dict(coarse_operator="galerkin", mu=2),
    ],
    ids=str,
)
def test_config_outside_slice_raises(kwargs):
    """The options the port once refused (line smoothers, mu > 1; queue 1
    item 16, since ported) are accepted, field for field as JAX's
    CycleConfig takes them; a malformed one raises as JAX's does."""
    from pde_multigrid_tpu import CycleConfig as JCycleConfig

    got = dataclasses.asdict(CycleConfig(**kwargs))
    assert got == dataclasses.asdict(JCycleConfig(**kwargs))
    for k, v in kwargs.items():
        assert got[k] == v
    bad = ({"smoother": kwargs["smoother"][:5] + "x"}
           if "smoother" in kwargs else {**kwargs, "mu": -1})
    with pytest.raises(ValueError):
        JCycleConfig(**bad)
    with pytest.raises(ValueError):
        CycleConfig(**bad)


def test_solver_config_gates():
    mixed = SolverConfig(precision="mixed")
    assert mixed.precision == "mixed"
    assert dataclasses.replace(mixed, precision="f32").precision == "f32"
    assert dataclasses.replace(mixed) == mixed
    with pytest.raises(ValueError):
        SolverConfig(precision="bf16")
    with pytest.raises(ValueError):
        SolverConfig(backend="pallas")
    with pytest.raises(ValueError):
        CycleConfig(kind="x")
    cfg = SolverConfig(cycle=CycleConfig("fmg", 2, 100, 100,
                                         coarsest="exact"))
    assert cfg.precision == "f32" and cfg.dtype == "float32"
