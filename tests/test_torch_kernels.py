"""Port parity of the CUDA kernel modules' plain versions (what the
wrappers run for CPU tensors) against the JAX package's Pallas kernels in
interpret mode, in float32, at the sizes and tolerances of
tests/test_pallas.py.

The kernels themselves build and run only on a GPU; `chip_smoke.py`
holds each one against its plain version there.  Here the wrappers must
take the plain path for CPU tensors, count no launch, and reject what the
kernels do not take."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pde_multigrid_tpu import grid as JG
from pde_multigrid_tpu.models import Poisson as JPoisson
from pde_multigrid_tpu.ops.pallas import relax as JR
from pde_multigrid_tpu.ops.pallas import transfer as JT
from pde_multigrid_tpu_torch import CycleConfig
from pde_multigrid_tpu_torch import grid as TG
from pde_multigrid_tpu_torch.cycles import CycleProgram, TorchKernels
from pde_multigrid_tpu_torch.models import Lyapunov2D as TLyapunov2D
from pde_multigrid_tpu_torch.models import Poisson as TPoisson
from pde_multigrid_tpu_torch.ops.cuda import relax as R
from pde_multigrid_tpu_torch.ops.cuda import transfer as T
from pde_multigrid_tpu_torch.ops.cuda.dispatch import CudaKernels
from pde_multigrid_tpu_torch.utils.convert import levels_from_numpy

F32 = jnp.dtype("float32")


def _wrap_level(n, seed):
    """Wrap geometries of both packages and float32 (v, f, coarse c)
    inputs; v and c keep the wrap invariant (stored plane 0 zero)."""
    dom = ((0.0, 1.0),) * 3
    jg = JG.build_geometries((n,) * 3, dom, wrap=True)
    tg = TG.build_geometries((n,) * 3, dom, wrap=True)
    rng = np.random.default_rng(seed)
    m = TG.wrap_interior(jg[0].padded_shape)
    v = (rng.standard_normal(jg[0].padded_shape) * m).astype(np.float32)
    f = rng.standard_normal(jg[0].padded_shape).astype(np.float32)
    c = (rng.standard_normal(jg[1].padded_shape)
         * TG.wrap_interior(jg[1].padded_shape)).astype(np.float32)
    return jg, tg, v, f, c


@pytest.fixture(autouse=True)
def _no_launches():
    """CPU tensors never launch a kernel: every counter stays at zero."""
    R.reset_launches()
    T.reset_launches()
    yield
    assert not any(R.launches.values()) and not any(T.launches.values())


# ------------------------------------------------------------ split relax


@pytest.mark.parametrize("B,Tc", [(4, 1), (8, 1), (4, 2), (4, 3)])
def test_split_relax_matches_pallas(B, Tc):
    """The split relax (split, red/black half-sweeps, merge) against
    make_split_slab_relax in interpret mode at 17^3.  Both evaluate the
    same per-point operations in the same order, and on the card, where
    neither side contracts, the kernel and this plain version agree bit
    for bit.  XLA's CPU backend, which runs the interpreted Pallas kernel,
    contracts `upd - r` with the product that forms `upd` into one fused
    multiply-add; that one rounding bounds the difference: at most 2 ulp
    of the largest value the sweeps read."""
    jg, tg, v, f, _ = _wrap_level(17, seed=B * 10 + Tc)
    fn = JR.make_split_slab_relax(JPoisson(3), jg[0], F32, B,
                                  sweeps_per_call=Tc, interpret=True)
    relax = R.make_split_relax(TPoisson(3), tg[0])
    ulp = np.spacing(np.float32(np.abs(v).max()))
    for ns in (1, 4):
        want = np.asarray(fn(jnp.asarray(v), jnp.asarray(f), ns))
        got = relax(torch.tensor(v), torch.tensor(f), ns)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2 * ulp)


def test_split_merge_match_pallas_converters():
    """split_colors / merge_colors against the JAX forms and the Pallas
    pick-matrix converters (interpret mode): exact permutations."""
    jg, tg, v, _, _ = _wrap_level(17, seed=1)
    qb = JR._split_qmask(*v.shape[::2])
    jr, jb = JR.split_colors(jnp.asarray(v), qb)
    r, b = R.split(torch.tensor(v))
    np.testing.assert_array_equal(r.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(b.numpy(), np.asarray(jb))
    back = R.merge(r, b)
    np.testing.assert_array_equal(back.numpy(), v)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(JR.merge_colors(jr, jb, qb)))
    # the Pallas converters need a lane-aligned level: (4, 16, 128)
    big = np.random.default_rng(2).standard_normal((4, 16, 128)).astype(
        np.float32)
    sc, pt = JR._pallas_split(4, 16, 128, F32, True)
    pr, pb = sc(jnp.asarray(big), pt)
    r2, b2 = R.split(torch.tensor(big))
    np.testing.assert_array_equal(r2.numpy(), np.asarray(pr))
    np.testing.assert_array_equal(b2.numpy(), np.asarray(pb))
    mc, u = JR._pallas_merge(4, 16, 128, F32, True)
    np.testing.assert_array_equal(
        R.merge(r2, b2).numpy(), np.asarray(mc(pr, pb, u)))


def test_half_sweep_colors_and_masks():
    """One red half-sweep touches only red interior points (y = 2j + q,
    x >= 1, z >= 1, and never y = 0); black only black ones."""
    _, tg, v, f, _ = _wrap_level(9, seed=4)
    prob = TPoisson(3)
    r, b = R.split(torch.tensor(v))
    fr, fb = R.split(torch.tensor(f))
    r0, b0 = r.clone(), b.clone()
    R.half_sweep_plain(r, b, fr, R.RED, prob, tg[0])
    assert torch.equal(b, b0)
    dense = R.merge(r, b) - R.merge(r0, b0)
    aux = TG.base_aux(tg[0])
    assert float(torch.max(torch.abs(dense * (1 - aux["m_red"])))) == 0.0
    assert int((dense != 0).sum()) == int(aux["m_red"].sum())
    R.half_sweep_plain(b, r, fb, R.BLACK, prob, tg[0])
    dense = R.merge(r, b) - R.merge(r0, b0)
    changed_black = dense * aux["m_black"]
    assert int((changed_black != 0).sum()) == int(aux["m_black"].sum())


# -------------------------------------------------------------- transfers


@pytest.mark.parametrize("block_rows", [None, 4])
def test_residual_restrict_matches_pallas(block_rows):
    """Both modes against make_residual_restrict in interpret mode at
    17^3, at the tolerances of tests/test_pallas.py (the Pallas kernel
    resamples y/z through hi/lo pick-matrix products, so it rounds a
    little differently from the separable jnp form the port follows)."""
    jg, tg, v, f, _ = _wrap_level(17, seed=7)
    prob_j, prob_t = JPoisson(3), TPoisson(3)
    rr = JT.make_residual_restrict(prob_j, jg[0], jg[1], F32,
                                   interpret=True, block_rows=block_rows)
    got = T.residual_restrict(torch.tensor(v), torch.tensor(f), prob_t,
                              tg[0], tg[1])
    np.testing.assert_allclose(
        got.numpy(), np.asarray(rr(jnp.asarray(v), jnp.asarray(f))),
        rtol=1e-4, atol=3e-4)
    ro = JT.make_residual_restrict(prob_j, jg[0], jg[1], F32,
                                   interpret=True, with_residual=False,
                                   block_rows=block_rows)
    got = T.residual_restrict(torch.tensor(f), None, prob_t, tg[0], tg[1],
                              with_residual=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(ro(jnp.asarray(f))),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("mode", ["add", "replace"])
def test_prolong_blend_matches_pallas(mode):
    jg, tg, v, _, c = _wrap_level(17, seed=8)
    pb = JT.make_prolong_blend(jg[1], jg[0], F32, mode, interpret=True)
    want = np.asarray(pb(jnp.asarray(c), jnp.asarray(v)))
    got = T.prolong_blend(torch.tensor(c), torch.tensor(v), mode, tg[1],
                          tg[0])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    # in place into the base tensor gives the same values
    base = torch.tensor(v)
    out = T.prolong_blend(torch.tensor(c), base, mode, tg[1], tg[0],
                          out=base)
    assert out is base
    np.testing.assert_array_equal(base.numpy(), got.numpy())


def test_residual_matches_pallas():
    """Against make_residual in interpret mode at 129^3 (its Pallas form
    needs Z % 128 == 0), at the tolerance of tests/test_pallas.py."""
    jg, tg, v, f, _ = _wrap_level(129, seed=9)
    res = JT.make_residual(JPoisson(3), jg[0], F32, interpret=True)
    want = np.asarray(res(jnp.asarray(v), jnp.asarray(v), jnp.asarray(v),
                          jnp.asarray(f)))
    got = T.residual(torch.tensor(v), torch.tensor(f), TPoisson(3), tg[0])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------- wrappers


def test_wrappers_reject_what_kernels_do_not_take():
    _, tg, v, f, c = _wrap_level(9, seed=3)
    prob = TPoisson(3)
    with pytest.raises(TypeError, match="float32"):
        R.split(torch.tensor(v, dtype=torch.float64))
    with pytest.raises(ValueError, match="contiguous"):
        R.split(torch.tensor(v).transpose(0, 2))
    with pytest.raises(ValueError):
        R.split(torch.zeros(4, 3, 4))  # odd Y
    with pytest.raises(ValueError, match="no kernel for device"):
        R.split(torch.zeros(4, 4, 4, device="meta"))
    with pytest.raises(ValueError):
        T.residual(torch.tensor(c), torch.tensor(c), prob, tg[0])
    with pytest.raises(ValueError):
        T.prolong_blend(torch.tensor(v), torch.tensor(v), "add", tg[1],
                        tg[0])
    with pytest.raises(ValueError, match="mode"):
        T.prolong_blend(torch.tensor(c), torch.tensor(v), "blend", tg[1],
                        tg[0])
    r, b = R.split(torch.tensor(v))
    with pytest.raises(ValueError):
        R.relax_halves(r, b, r[:, :1], b, 1, prob, tg[0])


def test_cuda_dispatch_plan():
    """CudaKernels plans every relaxed 3D wrap level and every level pair,
    and refuses what it cannot serve instead of running plain ops; 3D
    Poisson in padded storage (the padded leg on every 17^3 level, plain
    transfers), 2D Poisson (wrap and padded storage) and 2D Lyapunov are
    planned."""
    prob = TPoisson(3)
    geoms = TG.build_geometries((17,) * 3, prob.domain, wrap=True)
    k = CudaKernels(prob, geoms, torch.float32, range(len(geoms) - 1))
    assert all(fn is not None for fn in k._relax[:-1])
    assert k._relax[-1] is None
    padded = TG.build_geometries((17,) * 3, prob.domain, wrap=False)
    kpad = CudaKernels(prob, padded, torch.float32)
    assert kpad.tiers == ["padded3d"] * 4
    assert kpad._relax == [kpad._relax_padded3d] * 4
    assert all(kpad._plain) and not any(kpad._sub_v)
    with pytest.raises(NotImplementedError):
        CudaKernels(prob, geoms, torch.float64)
    # 2D Poisson: the dense leg on every 17^2 level of either storage
    for wrap in (True, False):
        kp = CudaKernels(TPoisson(2), TG.build_geometries(
            (17, 17), ((0.0, 1.0),) * 2, wrap=wrap), torch.float32)
        assert kp._relax == [kp._relax_resident] * 4
        assert kp._split == [False] * 4
    with pytest.raises(NotImplementedError):
        k.relax(len(geoms) - 1, None, None, None, 1)
    # 2D Lyapunov (padded storage) is planned: no longer refused
    lyap = TLyapunov2D()
    k2 = CudaKernels(lyap, TG.build_geometries((17, 17), lyap.domain),
                     torch.float32)
    assert all(fn is not None for fn in k2._relax)


@pytest.mark.parametrize("coarsest", ["exact", "relax"])
def test_cuda_tier_cycle_matches_plain_tier(coarsest):
    """A whole FMG step through the CUDA tier's plan on CPU tensors (its
    wrappers then run the plain versions) against the plain tensor tier:
    the split sweep multiplies by the float32 reciprocal exactly as the
    plain tier does, so the two agree bit for bit."""
    prob = TPoisson(3)
    cyc = CycleConfig("fmg", 2, 3, 3, coarsest=coarsest)
    geoms = TG.build_geometries((33,) * 3, prob.domain,
                                2 if coarsest == "exact" else None,
                                wrap=True)
    relaxed = range(len(geoms) - (coarsest == "exact"))
    state = [prob.init_level(g) for g in geoms]
    arrays = [{"v": l.v.numpy(), "f": l.f.numpy(),
               "aux": {k: a.numpy() for k, a in l.aux.items()}}
              for l in state]
    plain = CycleProgram(prob, geoms, cyc, TorchKernels(prob, geoms))
    tier = CycleProgram(prob, geoms, cyc,
                        CudaKernels(prob, geoms, torch.float32, relaxed))
    a = plain.solve_step(levels_from_numpy(geoms, arrays))
    b = tier.solve_step(levels_from_numpy(geoms, arrays))
    np.testing.assert_array_equal(b[0].v.numpy(), a[0].v.numpy())
    la, _ = plain.residual_norms(a)
    lb, _ = tier.residual_norms(b)
    assert float(la) == float(lb)
