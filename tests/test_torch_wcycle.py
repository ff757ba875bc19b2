"""Port parity of W-cycles (`CycleConfig(mu > 1)`): the cycles' mu loops
in the correction scheme and in FAS against the JAX package's jnp tier,
and row 22's fused subtree with mu inside the kernel
(`ops/cuda/subtree.py`): its plain version against JAX's `_build` in
interpret mode and the jnp W-cycle, a plain emulation of the kernel's
walk of the levels against the recursion, the plan, and W-cycles through
the fused hooks.

Tolerances.  Whole solves in float64: the logical solution to 1e-10 of
max|v| and the residual history to 1e-9 relative (the same operations;
libm and sums may round an ulp apart).  The fused subtree's plain version
against the interpreted Pallas kernel in float32: JAX's own rtol 3e-5 /
atol 3e-6 (`tests/test_pallas.py:157`: XLA's CPU backend contracts
products into sums and its dense masked sweeps round where the split form
does not); against the jnp W-cycle in float64: 1e-12 of max|v|.  Through
the hooks against the plain tier in float32: 1e-5 of max|v| (the split
half-sweeps and the blend form round apart by an ulp a sweep)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pde_multigrid_tpu as J
from pde_multigrid_tpu import grid as JG
from pde_multigrid_tpu.cycles import CycleProgram as JCycleProgram
from pde_multigrid_tpu.cycles import JnpKernels
from pde_multigrid_tpu.models import Poisson as JPoisson
from pde_multigrid_tpu.ops.pallas import subtree as JSub
import pde_multigrid_tpu_torch as T
from pde_multigrid_tpu_torch import grid as TG
from pde_multigrid_tpu_torch.cycles import CycleProgram
from pde_multigrid_tpu_torch.grid import to_logical
from pde_multigrid_tpu_torch.models import Poisson as TPoisson
from pde_multigrid_tpu_torch.ops.cuda import subtree as S
from pde_multigrid_tpu_torch.ops.cuda.dispatch import CudaKernels
from pde_multigrid_tpu_torch.utils.convert import levels_from_numpy

F32 = jnp.dtype("float32")
DOM = ((0.0, 1.0),) * 3


def _close(got, want, rel):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-300))


def _pair(problem, n, cyc, **cfg):
    """JAX jnp-backend and port CPU solvers of one float64 schedule."""
    jp = getattr(J, problem[0])(*problem[1:])
    tp = getattr(T, problem[0])(*problem[1:])
    js = J.MultigridSolver(jp, n, J.SolverConfig(
        cycle=J.CycleConfig(**cyc), backend="jnp", dtype="float64", **cfg))
    ts = T.MultigridSolver(tp, n, T.SolverConfig(
        cycle=T.CycleConfig(**cyc), dtype="float64", **cfg), device="cpu")
    assert [g.padded_shape for g in ts.geoms] == [
        g.padded_shape for g in js.geoms]
    return js, ts


# ------------------------------------------------------------ the cycles


def test_w_kind_rbgs_poisson2d_matches_jax():
    """kind="w", V(2, 2) shape with mu = 2, red-black Gauss-Seidel on
    Poisson(2) 65^2, two cycles (tests/test_convergence.py:52's solve, on
    four levels, 65^2 to 9^2 relaxed: JAX traces the W recursion unrolled,
    2^(levels - 1) coarsest visits a cycle, and the whole hierarchy takes
    it four times as long), in float64: the residual history and the
    logical solution against JAX jnp; that test's error gate holds too."""
    js, ts = _pair(("Poisson", 2), 65,
                   dict(kind="w", nu0=0, nu1=2, nu2=2, mu=2),
                   max_cycles=2, tol=0.0, num_levels=4)
    jr, tr = js.solve_to_tolerance(), ts.solve_to_tolerance()
    np.testing.assert_allclose(tr.residual_history, jr.residual_history,
                               rtol=1e-9)
    _close(to_logical(tr.v, ts.geoms[0]),
           to_logical(np.asarray(jr.v), js.geoms[0]), 1e-10)
    assert tr.residual_history[1] < 0.01 * tr.residual_history[0]
    assert tr.error_linf < 4e-4


def test_fas_mu2_hjb_matches_jax():
    """One FMG(1, 3, 3) FAS step with mu = 2 on HJB 33^2 relaxed to 9^2
    (the coarse changes of two visits summed into the fine level), in
    float64, from the same levels: v and error_linf against JAX jnp."""
    js, ts = _pair(("HJBMinTime",), 33,
                   dict(kind="fmg", nu0=1, nu1=3, nu2=3, mu=2,
                        scheme="fas"), num_levels=3)
    arrays = [{"v": np.asarray(l.v), "f": np.asarray(l.f),
               "aux": {k: np.asarray(a) for k, a in l.aux.items()}}
              for l in js.fresh_levels()]
    jr = js.solve(js.fresh_levels())
    tr = ts.solve(levels_from_numpy(ts.geoms, arrays, dtype=torch.float64))
    _close(tr.v, np.asarray(jr.v), 1e-10)
    assert abs(tr.error_linf - float(jr.error_linf)) <= 1e-10


# ---------------------------------------------- row 22: the fused subtree


def _hier(n):
    return (JG.build_geometries((n,) * 3, DOM, wrap=True),
            TG.build_geometries((n,) * 3, DOM, wrap=True))


def _vf(shape, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(shape) * TG.wrap_interior(shape)
    return v.astype(dtype), rng.standard_normal(shape).astype(dtype)


@pytest.mark.parametrize("with_root_relax", [True, False])
def test_subtree_plain_mu2_matches_pallas_build(with_root_relax):
    """subtree_vcycle_plain(mu=2) against JAX's _build(mu=2) in interpret
    mode on the 17^3 wrap hierarchy cut to three levels (16^3, 8^3, 4^3:
    the coarsest visited four times), nu = (2, 1): the whole W-cycle and
    the correction alone."""
    jg, tg = (h[:3] for h in _hier(17))
    v, f = _vf(jg[0].padded_shape, seed=5 + with_root_relax)
    fn = JSub._build(JPoisson(3), jg, F32, 2, 1, 2, with_root_relax, True)
    want = np.asarray(fn(jnp.asarray(v), jnp.asarray(f)))
    got = S.subtree_vcycle_plain(torch.tensor(v), torch.tensor(f),
                                 TPoisson(3), tg, 2, 1, with_root_relax,
                                 mu=2)
    np.testing.assert_allclose(got.numpy(), want, rtol=3e-5, atol=3e-6)


def test_subtree_plain_mu2_matches_jnp_wcycle_float64():
    """In float64 the plain version with mu = 2 equals the jnp tier's
    W-cycle rooted at 33^3 (CycleConfig mu = 2, nu = (2, 3)) to 1e-12."""
    jprob = JPoisson(3)
    h = JG.Hierarchy.build(jprob, 33, dtype=jnp.float64, wrap=True)
    _, tg = _hier(33)
    v, f = _vf(h.geoms[0].padded_shape, seed=11, dtype=np.float64)
    lv0 = h.levels[0]
    levels = (type(lv0)(v=jnp.asarray(v), f=jnp.asarray(f), aux=lv0.aux),
              *h.levels[1:])
    prog = JCycleProgram(jprob, h.geoms, J.CycleConfig("v", 0, 2, 3, 2),
                         JnpKernels(jprob, h.geoms))
    want = np.asarray(jax.jit(lambda lv: prog.v_cycle(lv, 0))(levels)[0].v)
    got = S.subtree_vcycle_plain(torch.tensor(v), torch.tensor(f),
                                 TPoisson(3), tg, 2, 3, mu=2)
    _close(got, want, 1e-12)


def _kernel_walk(nlev, mu, with_root_relax=True):
    """A plain emulation of the kernel's walk of the levels
    (csrc/subtree.cu `subtree_kernel`), step for step, as a list of
    events: ("relax", k, sweeps) with sweeps "nu1", "nu2" or "nu1+nu2"
    (the coarsest level), ("restrict", k) (level k's residual into level
    k + 1, whose v is zeroed) and ("prolong", k) (level k + 1's error added
    into level k).  The loop mirrors the kernel's line for line: per-level
    visit counters in place of the recursion."""
    events = []
    visits = [0] * nlev
    k, down = 0, True
    while True:
        if down:
            if k > 0 or with_root_relax:
                events.append(("relax", k,
                               "nu1+nu2" if k + 1 == nlev else "nu1"))
            if k + 1 < nlev:
                events.append(("restrict", k))
                k += 1
                visits[k] = 0
                continue
            down = False
        if k == 0:
            break
        visits[k] += 1
        if visits[k] < mu:
            down = True
            continue
        k -= 1
        events.append(("prolong", k))
        if k > 0 or with_root_relax:
            events.append(("relax", k, "nu2"))
    return events


def _recursion(nlev, mu, with_root_relax):
    """The schedule of the recursive cycle (`subtree_vcycle_plain`'s, and
    JAX's `vcyc` / `correction`) as events."""
    out = []

    def vcyc(k):
        out.append(("relax", k, "nu1+nu2" if k + 1 == nlev else "nu1"))
        if k + 1 < nlev:
            correction(k)
            out.append(("relax", k, "nu2"))

    def correction(k):
        out.append(("restrict", k))
        for _ in range(mu):
            vcyc(k + 1)
        out.append(("prolong", k))

    if with_root_relax:
        vcyc(0)
    else:
        correction(0)
    return out


@pytest.mark.parametrize("mu", [1, 2, 3])
@pytest.mark.parametrize("nlev", [1, 2, 3, 4, 5, 6])
def test_kernel_walk_is_the_recursion(mu, nlev):
    """The kernel's walk of the levels with per-level visit counters
    (`_kernel_walk`, csrc/subtree.cu's loop line for line) gives the
    recursion's order of relax legs, restrictions and prolongations, with
    and without the root's relax; level k is relaxed in mu^k visits."""
    for wr in (True, False) if nlev > 1 else (True,):
        walk = _kernel_walk(nlev, mu, wr)
        assert walk == _recursion(nlev, mu, wr)
        for k in range(1, nlev):
            pre = sum(e[:2] == ("relax", k) and e[2] != "nu2" for e in walk)
            assert pre == mu ** k


def test_plan_fuses_wcycles_as_jax():
    """With mu = 2 the port fuses the roots JAX's plan_fused_cycles fuses
    on the 129^3 wrap hierarchy (64^3 and below), each fused call a
    W-cycle (the cycle's mu in the kernel's parameters); mu = 0 is planned
    nowhere and refused by the wrapper."""
    jg, tg = _hier(129)
    cyc = dict(kind="fmg", nu0=2, nu1=2, nu2=2, mu=2)
    jv, jc = JSub.plan_fused_cycles(JPoisson(3), jg, F32,
                                    J.CycleConfig(**cyc), interpret=True)
    tv, tc = S.plan_fused_cycles(TPoisson(3), tg, T.CycleConfig(**cyc))
    fused = [fn is not None for fn in tv]
    assert fused == [fn is not None for fn in jv] == [
        g.padded_shape[0] <= 64 for g in tg]
    assert not any(tc) and not any(jc)
    assert all(fn.keywords["mu"] == 2 for fn in tv if fn is not None)
    p = S._params(tuple(tg[1:]), 2, 2, True, S.CAPACITY, mu=2)
    assert (p.mu, p.nu1, p.nu2, p.nlev) == (2, 2, 2, 6)
    tv0, _ = S.plan_fused_cycles(TPoisson(3), tg, T.CycleConfig(**{
        **cyc, "mu": 0}))
    assert not any(tv0)
    v, f = (torch.tensor(a) for a in _vf(tg[-2].padded_shape, seed=1))
    with pytest.raises(ValueError, match="mu=0"):
        S.subtree_vcycle(v, f, TPoisson(3), tg[-2:], 1, 1, mu=0)


def test_wcycle_through_the_hooks(monkeypatch):
    """FMG(2, 2, 2) with mu = 2 relaxed to 2^3 at 17^3, then one W-cycle,
    through CudaKernels on CPU tensors with the capacity shrunk so that
    only the roots of 8^3 and below fit: the 16^3 W-cycles, relaxed by the
    tier, call the 8^3-rooted fused cycle twice each, and every fused call
    is a W-cycle inside (the plain version with mu = 2).  Against the
    plain tier's solve of the same schedule: the solution and the residual
    history; the gate."""
    cyc = T.CycleConfig("fmg", 2, 2, 2, 2)
    cfg = T.SolverConfig(cycle=cyc, max_cycles=2, tol=0.0)
    plain = T.MultigridSolver(TPoisson(3), 17, cfg, device="cpu")
    want = plain.solve_to_tolerance()
    ts = T.MultigridSolver(TPoisson(3), 17, cfg, device="cpu")
    sub8 = tuple(ts.geoms[1:])
    monkeypatch.setattr(S, "CAPACITY", S.CLUSTER_CTAS * S.layout(
        sub8, True)["smem_bytes"])
    kern = CudaKernels(ts.problem, ts.geoms, torch.float32, cycle=cyc)
    assert [fn is not None for fn in kern._sub_v] == [False, True, True,
                                                      True]
    calls = []
    hook = kern.fused_vcycle

    def spy(l, v, f):
        out = hook(l, v, f)
        if out is not None:
            calls.append(l)
        return out

    kern.fused_vcycle = spy
    ts.program = CycleProgram(ts.problem, ts.geoms, cyc, kern)
    got = ts.solve_to_tolerance()
    # FMG: nu0 cycles from 2^3, 4^3, 8^3 (each one fused call), then two
    # 16^3 W-cycles (two 8^3 visits each); then one more 16^3 W-cycle
    assert calls == [3, 3, 2, 2, 1, 1] + [1, 1] * 2 + [1, 1]
    _close(got.v, want.v, 1e-5)
    np.testing.assert_allclose(got.residual_history, want.residual_history,
                               rtol=1e-3)
    h = ts.geoms[0].spacing[0]
    assert got.error_linf < 50 * h * h
