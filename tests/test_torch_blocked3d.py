"""Port parity of the blocked 3D color-split relax, `ops/cuda/blocked3d.py`
(row 19), against the JAX package: its plain version (what the wrapper
runs for CPU tensors) against `make_split_slab_relax_2d` in interpret mode
and, in float64, against the jnp tier's dense red-black sweeps; bitwise
against row 9's plain half-sweep chain; the plan with the wavefront switch
on and off against JAX's `plan_relax` on the bench's hierarchies and a
non-cubic level; the sharded plan, which the switch must not reach; an
FMG slice forced onto row 19 against JAX's jnp solve; and the wrapper's
refusals.

The kernel itself builds and runs only on a GPU; `chip_smoke.py` holds it
against row 9's kernel chain and this plain version there, bit for bit.

Tolerances, and why:
  * plain vs the interpreted Pallas kernel (float32): 2 ulp of the
    largest value.  Both evaluate the same sums and products in the same
    order; XLA's CPU backend contracts a product into the following sum
    (one rounding fewer) and nothing else differs;
  * float64 vs the jnp tier's `relax_rbgs`: 1e-12 relative (the blend on
    halves and the dense update round apart by an ulp of float64);
  * against row 9's plain chain: bitwise (the same function);
  * the FMG slice: the logical solution within 1e-5 of max|v| and
    error_linf to 1e-4 relative, the residual history to 1e-3 (the bounds
    of the wavefront's slice, tests/test_torch_timeskew.py: the split
    update and the jnp tier's dense update round apart, and the float32
    exact coarse solve sums in another order).
"""

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
from pde_multigrid_tpu_torch.ops.cuda import blocked3d as BL
from pde_multigrid_tpu_torch.ops.cuda import dispatch as D
from pde_multigrid_tpu_torch.ops.cuda import relax as R
from pde_multigrid_tpu_torch.ops.cuda import resident3d as RS3
from pde_multigrid_tpu_torch.parallel import halo
from pde_multigrid_tpu_torch.utils.convert import levels_from_numpy

F32 = jnp.dtype("float32")
DOM = ((0.0, 1.0),) * 3


@pytest.fixture(autouse=True)
def _no_launches():
    """CPU tensors never launch a kernel: every counter stays at zero."""
    BL.reset_launches()
    R.reset_launches()
    yield
    assert not any(BL.launches.values()) and not any(R.launches.values())


def _level(n, seed, dtype=np.float32):
    """Wrap geometries of both packages and (v, f) at n^3, v keeping the
    wrap invariant (stored planes x, y, z = 0 zero)."""
    jg = JG.build_geometries((n,) * 3, DOM, wrap=True)
    tg = TG.build_geometries((n,) * 3, DOM, wrap=True)
    rng = np.random.default_rng(seed)
    shape = jg[0].padded_shape
    v = rng.standard_normal(shape) * TG.wrap_interior(shape)
    return jg, tg, v.astype(dtype), rng.standard_normal(shape).astype(dtype)


def _halves(v, f):
    return (*R.split_colors(torch.tensor(v)), *R.split_colors(torch.tensor(f)))


# ------------------------------------------------ the interpreted kernel


@pytest.fixture(scope="module")
def level65():
    jg, tg, v, f = _level(65, seed=1965)
    X, _, Z = jg[0].padded_shape
    qb = JR._split_qmask(X, Z)
    jh = (*JR.split_colors(jnp.asarray(v), qb),
          *JR.split_colors(jnp.asarray(f), qb))
    return jg[0], tg[0], v, _halves(v, f), jh


@pytest.mark.parametrize("B,Bj,T_", [(4, 8, 1), (8, 8, 2)])
def test_plain_matches_pallas_blocked(level65, B, Bj, T_):
    """The wrapper's plain path against make_split_slab_relax_2d(interpret,
    raw) at 65^3, raw halves in and out, over nu = 1 and 3 (at T = 2 a
    launch of 2 and a remainder of 1): x and j blocks, the j halo clamped
    at both y edges, the appended zero wrap rows."""
    jg, tg, v, hv, jh = level65
    raw = JR.make_split_slab_relax_2d(JPoisson(3), jg, F32, B, Bj,
                                      sweeps_per_call=T_, interpret=True,
                                      raw=True)
    for ns in (1, 3):
        want = [np.asarray(a) for a in raw(*jh, ns)]
        got = BL.blocked_relax_halves(*hv, ns, TPoisson(3), tg, T=T_)
        ulp = np.spacing(np.float32(max(np.abs(v).max(),
                                        *(np.abs(w).max() for w in want))))
        for g_, w in zip(got, want):
            np.testing.assert_allclose(g_.numpy(), w, rtol=0, atol=2 * ulp)


# ------------------------------------- row 9's chain, float64 relax_rbgs


@pytest.mark.parametrize("n", [17, 33])
def test_plain_is_row9_chain_bitwise(n):
    """At T = 1-4, over 7 sweeps (a remainder launch where T does not
    divide 7), the wrapper's plain path equals row 9's plain half-sweep
    chain bit for bit, and leaves its inputs as they were."""
    _, tg, v, f = _level(n, seed=n)
    hv = _halves(v, f)
    keep = [a.clone() for a in hv]
    want = R.relax_halves_plain(hv[0].clone(), hv[1].clone(), *hv[2:], 7,
                                TPoisson(3), tg[0])
    for T_ in (1, 2, 3, 4):
        got = BL.blocked_relax_halves(*hv, 7, TPoisson(3), tg[0], T=T_)
        assert all(map(torch.equal, got, want))
    assert all(map(torch.equal, hv, keep))


def test_plain_matches_relax_rbgs_float64():
    """In float64 the plain version (merged) equals the jnp tier's dense
    masked red-black sweeps, to 1e-12 relative."""
    jg, tg, v, f = _level(17, seed=77, dtype=np.float64)
    aux = JG.base_aux(jg[0])
    prob = JPoisson(3)
    hv = _halves(v, f)
    for ns in (1, 4):
        want = np.asarray(JS.relax_rbgs(
            lambda vv, ff: prob.relax_update(vv, ff, jg[0], aux),
            jnp.asarray(v), jnp.asarray(f), aux["m_red"], aux["m_black"],
            ns))
        r, b = BL.blocked_slab3d_plain(*hv, ns, TPoisson(3), tg[0])
        assert r.dtype == torch.float64
        np.testing.assert_allclose(R.merge_colors(r, b).numpy(), want,
                                   rtol=0, atol=1e-12 * np.abs(want).max())


# ------------------------------------------------------------------ plan

_JAX_TIER = {
    "make_merged_resident_relax": "merged_resident",
    "make_resident_relax": "resident3d",
    "make_split_timeskew_relax": "timeskew",
    "make_split_timeskew_relax_jb": "timeskew",
    "make_split_slab_relax": "half_sweep",
    "make_split_slab_relax_2d": "blocked3d",
}


def _jax_tier(g):
    return _JAX_TIER[JR.plan_relax(JPoisson(3), g, F32, interpret=True)
                     .__qualname__.split(".")[0]]


@pytest.mark.parametrize("timeskew", ["1", "0"])
@pytest.mark.parametrize("n", [129, 257, 513])
def test_plan_pins_match_jax_plan_relax(monkeypatch, n, timeskew):
    """With PDE_MG_TIMESKEW on and off (read at every call, in both
    packages), each relaxed level of the bench's exact-coarsest hierarchy
    takes the tier JAX's plan_relax gives it: off, row 19 on 256^3 and
    512^3, row 9 on 128^3; on, the wavefront there."""
    monkeypatch.setenv("PDE_MG_TIMESKEW", timeskew)
    nlev = {129: 2, 257: 3, 513: 4}[n]
    jg = JG.build_geometries((n,) * 3, DOM, nlev, wrap=True)
    tg = TG.build_geometries((n,) * 3, DOM, nlev, wrap=True)
    k = D.CudaKernels(TPoisson(3), tg, torch.float32, range(nlev - 1))
    assert k.tiers[:-1] == [_jax_tier(g) for g in jg[:-1]]
    big = [t for g, t in zip(tg, k.tiers) if g.padded_shape[0] >= 256]
    assert big == ["blocked3d" if timeskew == "0" else "timeskew"] * len(big)


@pytest.mark.parametrize("shape,off,on", [
    ((257, 257, 129), "half_sweep", "timeskew"),
    ((129, 257, 257), "blocked3d", "timeskew"),
    ((257, 129, 257), "half_sweep", "timeskew"),
])
def test_non_cubic_level_matches_jax(monkeypatch, shape, off, on):
    """Non-cubic levels, where row 9's budget and the wavefront's gate
    part: (256, 256, 128) stays on row 9 with the wavefront off (its
    half-plane fits at B = 8), (128, 256, 256) goes to row 19."""
    for val, want in (("0", off), ("1", on)):
        monkeypatch.setenv("PDE_MG_TIMESKEW", val)
        jg = JG.build_geometries(shape, DOM, 1, wrap=True)[0]
        tg = TG.build_geometries(shape, DOM, 1, wrap=True)[0]
        assert _jax_tier(jg) == want
        assert D._relax3d(TPoisson(3), tg)[0] == want
        assert BL.use_blocked(tg) == (off == "blocked3d")


def test_switch_leaves_sharded_plan_and_reads_each_call(monkeypatch):
    """PDE_MG_TIMESKEW is read at every call of timeskew_plan, and the
    sharded tier keeps its own gate (JAX: PDE_MG_SHARD_TIMESKEW,
    parallel/halo.py:112): its engines over 1, 2, 4 ranks on the 257^3
    levels are the same with the switch on and off."""
    tg = TG.build_geometries((257,) * 3, DOM, 3, wrap=True)
    engines = {}
    for val in ("1", "0"):
        monkeypatch.setenv("PDE_MG_TIMESKEW", val)
        assert R.timeskew_plan(tg[0]) is (val == "1")
        engines[val] = [halo.plan_engine(TPoisson(3), g, n) for g in tg
                        for n in (1, 2, 4)]
    assert engines["0"] == engines["1"]
    assert "timeskew" in engines["0"]
    monkeypatch.delenv("PDE_MG_TIMESKEW")
    assert R.timeskew_plan(tg[0])


# ----------------------------------------------------------------- slice


def test_fmg_slice_through_row19_matches_jax(monkeypatch):
    """FMG(1, 4, 4), exact coarsest, at 33^3 through CudaKernels on CPU
    tensors with the wavefront off and row 9's budget and the resident
    kernel's shared memory set to 0, so that 32^3 and 16^3 take row 19 (its
    plain version, both legs of each level visit), against JAX's
    backend="jnp" solve from the same levels."""
    monkeypatch.setenv("PDE_MG_TIMESKEW", "0")
    monkeypatch.setattr(BL, "SLAB_VMEM_BUDGET", 0)
    monkeypatch.setattr(RS3, "MAX_SMEM_BYTES", 0)
    calls = []
    plain = BL.blocked_slab3d_plain

    def counted(*args, **kw):
        calls.append(args[4])
        return plain(*args, **kw)

    monkeypatch.setattr(BL, "blocked_slab3d_plain", counted)
    cyc = dict(kind="fmg", nu0=1, nu1=4, nu2=4, coarsest="exact")
    js = J.MultigridSolver(J.Poisson3D(), 33, J.SolverConfig(
        cycle=J.CycleConfig(**cyc), backend="jnp", max_cycles=2, tol=0.0))
    ts = MultigridSolver(TPoisson(3), 33, SolverConfig(
        cycle=CycleConfig(**cyc), max_cycles=2, tol=0.0), device="cpu")
    kern = D.CudaKernels(ts.problem, ts.geoms, torch.float32,
                         range(len(ts.geoms) - 1))
    assert kern.tiers[:-1] == ["blocked3d"] * (len(ts.geoms) - 1)
    ts.program = CycleProgram(ts.problem, ts.geoms, ts.config.cycle, kern)
    jl = js.fresh_levels()
    arrays = [{"v": np.asarray(l.v), "f": np.asarray(l.f),
               "aux": {k: np.asarray(a) for k, a in l.aux.items()}}
              for l in jl]
    tl = levels_from_numpy(ts.geoms, arrays)
    jr, tr = js.solve_to_tolerance(jl), ts.solve_to_tolerance(tl)
    # T = 1 launches: 4 sweeps a leg, 2 legs a visit
    assert calls and set(calls) == {BL.BLOCKED_T}
    a = to_logical(np.asarray(jr.v), js.geoms[0])
    b = to_logical(tr.v, ts.geoms[0])
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-5 * np.abs(a).max())
    np.testing.assert_allclose(tr.error_linf, jr.error_linf, rtol=1e-4)
    np.testing.assert_allclose(tr.residual_history, jr.residual_history,
                               rtol=1e-3)
    h = ts.geoms[0].spacing[0]
    assert tr.error_linf < 50 * h * h


# -------------------------------------------------------------- refusals


def test_wrapper_refuses_what_the_kernel_does_not_take():
    _, tg, v, f = _level(17, seed=9)
    g, prob = tg[0], TPoisson(3)
    hv = _halves(v, f)
    out = (torch.empty_like(hv[0]), torch.empty_like(hv[1]))
    for bad_t in (0, BL.MAX_T + 1):
        with pytest.raises(ValueError, match="sweeps"):
            BL.blocked_chunk(*hv, bad_t, prob, g, out)
    with pytest.raises(ValueError, match="alias"):
        BL.blocked_chunk(*hv, 1, prob, g, (hv[0], out[1]))
    with pytest.raises(ValueError, match="alias"):
        BL.blocked_chunk(*hv, 1, prob, g, (out[0], out[0]))
    with pytest.raises(ValueError):
        BL.blocked_chunk(hv[0][:, :2].contiguous(), *hv[1:], 1, prob, g,
                         out)
    with pytest.raises(TypeError, match="float32"):
        BL.blocked_chunk(*(a.double() for a in hv), 1, prob, g,
                         tuple(o.double() for o in out))
    with pytest.raises(ValueError, match="contiguous"):
        BL.blocked_chunk(hv[0].transpose(0, 2).contiguous().transpose(0, 2),
                         *hv[1:], 1, prob, g, out)
    with pytest.raises(ValueError, match="no kernel for device"):
        BL.blocked_chunk(*(torch.empty(hv[0].shape, device="meta")
                           for _ in range(4)), 1, prob, g,
                         tuple(torch.empty(hv[0].shape, device="meta")
                               for _ in range(2)))
    padded = TG.build_geometries((16, 16, 16), DOM, 1)[0]  # halves' shape
    with pytest.raises(ValueError, match="wrap"):
        BL.blocked_chunk(*hv, 1, prob, padded, out)
