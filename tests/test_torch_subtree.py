"""Port parity of the fused coarse-subtree V-cycle (`ops/cuda/subtree.py`:
`subtree_vcycle_plain`, which the wrapper `subtree_vcycle` runs for CPU
tensors) against the JAX package: its `subtree._build` in interpret mode,
its jnp `CycleProgram.v_cycle` in float64, its small sub-lane transfer
kernels, its `plan_fused_cycles`, and a whole FMG solve through its Pallas
tier; then the port's fused-cycle hooks, the wrapper's refusals and the
3D presets' plans.

Tolerances.  On the card, with --fmad=false, the kernel equals this plain
version and the unfused chain of the port's kernels bit for bit
(`chip_smoke.py`).  Against the interpreted Pallas kernels: JAX's own
test's rtol 3e-5 / atol 3e-6 (tests/test_pallas.py:157): XLA's CPU
backend contracts products into sums (one rounding fewer), and its dense
masked sweeps `v + m (upd - v)` round where the split form's
`old + (upd - old)` does, so the two drift apart by a few float32 ulp per
sweep.  In float64 against the jnp tier: 1e-12 relative (the same
operations, one rounding of float64 apart where the constants fold).  On
CPU tensors the fused hooks and the unfused chain run the same plain
operations in the same order: equal bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pde_multigrid_tpu as J
from pde_multigrid_tpu import grid as JG
from pde_multigrid_tpu.cycles import CycleProgram as JCycleProgram
from pde_multigrid_tpu.cycles import JnpKernels
from pde_multigrid_tpu.models import Poisson as JPoisson
from pde_multigrid_tpu.ops import stencil as JSt
from pde_multigrid_tpu.ops.pallas import subtree as JSub
from pde_multigrid_tpu_torch import CycleConfig, MultigridSolver, SolverConfig
from pde_multigrid_tpu_torch import grid as TG
from pde_multigrid_tpu_torch.__main__ import PRESETS
from pde_multigrid_tpu_torch.cycles import CycleProgram
from pde_multigrid_tpu_torch.grid import to_logical
from pde_multigrid_tpu_torch.models import Poisson as TPoisson
from pde_multigrid_tpu_torch.ops.cuda import defect as D
from pde_multigrid_tpu_torch.ops.cuda import relax as R
from pde_multigrid_tpu_torch.ops.cuda import subtree as S
from pde_multigrid_tpu_torch.ops.cuda import transfer as T
from pde_multigrid_tpu_torch.ops.cuda.dispatch import CudaKernels
from pde_multigrid_tpu_torch.utils.convert import levels_from_numpy

F32 = jnp.dtype("float32")
DOM = ((0.0, 1.0),) * 3


def _hier(n):
    """The unpadded wrap hierarchies of both packages at n^3, down to 2^3."""
    return (JG.build_geometries((n,) * 3, DOM, wrap=True),
            TG.build_geometries((n,) * 3, DOM, wrap=True))


def _vf(shape, seed, dtype=np.float32):
    """v random with the wrap invariant (zero on the stored planes 0), f
    random everywhere."""
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(shape) * TG.wrap_interior(shape)
    return v.astype(dtype), rng.standard_normal(shape).astype(dtype)


def _cycle(**kw):
    return CycleConfig(**{"kind": "fmg", "nu0": 2, "nu1": 3000, "nu2": 3000,
                          **kw})


@pytest.fixture(autouse=True)
def _no_launches():
    """CPU tensors never launch a kernel: every counter stays at zero."""
    for mod in (R, T, S):
        mod.reset_launches()
    yield
    assert not any(S.launches.values()) and not any(T.launches.values())
    assert not any(R.launches.values()) and not T.launches_by_fine


# ------------------------------------------- (a) the Pallas kernel _build


@pytest.mark.parametrize("n,with_root_relax", [(17, True), (17, False),
                                               (33, True), (33, False)])
def test_plain_matches_pallas_build(n, with_root_relax):
    """subtree_vcycle_plain against JAX's _build in interpret mode on the
    unpadded wrap hierarchy, nu = (2, 3) (nu1 != nu2 catches swapped
    legs), the whole V-cycle and the correction alone."""
    jg, tg = _hier(n)
    v, f = _vf(jg[0].padded_shape, seed=n)
    fn = JSub._build(JPoisson(3), jg, F32, 2, 3, 1, with_root_relax, True)
    want = np.asarray(fn(jnp.asarray(v), jnp.asarray(f)))
    got = S.subtree_vcycle_plain(torch.tensor(v), torch.tensor(f),
                                 TPoisson(3), tg, 2, 3, with_root_relax)
    np.testing.assert_allclose(got.numpy(), want, rtol=3e-5, atol=3e-6)


# ------------------------------------------------ (b) jnp tier, float64


@pytest.mark.parametrize("with_root_relax", [True, False])
def test_plain_matches_jnp_vcycle_float64(with_root_relax):
    """In float64 the plain version equals the jnp tier's V-cycle rooted
    at 33^3 (or its coarse-grid correction, composed of the jnp tier's own
    residual, restriction, recursion, prolongation and correction) to
    1e-12 relative."""
    jprob = JPoisson(3)
    h = JG.Hierarchy.build(jprob, 33, dtype=jnp.float64, wrap=True)
    jg = h.geoms
    _, tg = _hier(33)
    v, f = _vf(jg[0].padded_shape, seed=7, dtype=np.float64)
    lv0 = h.levels[0]
    levels = (type(lv0)(v=jnp.asarray(v), f=jnp.asarray(f), aux=lv0.aux),
              *h.levels[1:])
    cfg = J.CycleConfig("v", 0, 2, 3)
    jk = JnpKernels(jprob, jg)
    prog = JCycleProgram(jprob, jg, cfg, jk)
    if with_root_relax:
        want = np.asarray(prog.v_cycle(levels, 0)[0].v)
    else:
        aux0, lv1 = lv0.aux, h.levels[1]
        r = jk.residual(0, levels[0].v, levels[0].f, aux0)
        cf = jk.restrict(0, r, lv1.aux["m_int"], lv1.aux["m_log"])
        levels = (levels[0], type(lv1)(v=jnp.zeros_like(lv1.v), f=cf,
                                       aux=lv1.aux), *levels[2:])
        cv = prog.v_cycle(levels, 1, f_is_rhs=False)[1].v
        want = np.asarray(JSt.apply_correction(
            levels[0].v, jk.prolong(0, cv), aux0["m_int"]))
    got = S.subtree_vcycle_plain(torch.tensor(v), torch.tensor(f),
                                 TPoisson(3), tg, 2, 3, with_root_relax)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-12 * np.abs(want).max())


# ----------------------------------------- (c) the small transfer kernels


@pytest.mark.parametrize("n", [33, 17, 9, 5])
def test_transfers_match_small_pallas_kernels(n):
    """On the sub-lane pairs 32^3 -> 16^3 ... 4^3 -> 2^3 the restrict-only
    mode of residual_restrict and prolong_blend (both modes), the
    functions of rows 23 and 24, against JAX's make_small_restrict and
    make_small_prolong_blend in interpret mode: the 2-point axes of the
    4^3 -> 2^3 pair wrap their x - 1 and x + 1 onto one plane."""
    jg, tg = _hier(n)
    gf, gc = jg[0], jg[1]
    assert JSub._small_pair_ok(gf, gc)
    rng = np.random.default_rng(n)
    fine = rng.standard_normal(gf.padded_shape).astype(np.float32)
    base = rng.standard_normal(gf.padded_shape).astype(np.float32)
    coarse = rng.standard_normal(gc.padded_shape).astype(np.float32)
    want = np.asarray(JSub.make_small_restrict(gf, gc, F32, True)(
        jnp.asarray(fine)))
    got = T.residual_restrict(torch.tensor(fine), None, TPoisson(3), tg[0],
                              tg[1], with_residual=False)
    np.testing.assert_allclose(got.numpy(), want, rtol=3e-5, atol=3e-6)
    for mode in ("add", "replace"):
        pb = JSub.make_small_prolong_blend(gc, gf, F32, mode, True)
        want = np.asarray(pb(jnp.asarray(coarse), jnp.asarray(base)))
        got = T.prolong_blend(torch.tensor(coarse), torch.tensor(base), mode,
                              tg[1], tg[0])
        np.testing.assert_allclose(got.numpy(), want, rtol=3e-5, atol=3e-6)


# ------------------------------------------------------------- (d) plan


def _fused(fns):
    return [fn is not None for fn in fns]


@pytest.mark.parametrize("n", [17, 33, 65, 129, 257])
def test_plan_pins_match_jax(n):
    """The port fuses exactly the roots JAX's plan_fused_cycles fuses on
    the unpadded wrap hierarchies (64^3 and below), and plans the
    correction-only variant nowhere, as JAX does."""
    jg, tg = _hier(n)
    jv, jc = JSub.plan_fused_cycles(JPoisson(3), jg, F32,
                                    J.CycleConfig("fmg", 2, 3000, 3000),
                                    interpret=True)
    tv, tc = S.plan_fused_cycles(TPoisson(3), tg, _cycle())
    assert _fused(tv) == _fused(jv)
    assert _fused(tc) == _fused(jc) == [False] * len(tg)
    assert _fused(tv) == [g.padded_shape[0] <= 64 for g in tg]


def test_plan_refuses_what_the_kernel_does_not_run():
    """No fused kernel for an exact coarsest level (a documented
    difference: JAX fuses an in-kernel fast-diagonalization coarsest at
    coarsest levels of at most 32^3), another smoother, FAS, float64, a
    problem other than Poisson, or without the cycle."""
    jg, tg = _hier(17)
    exact = J.CycleConfig("fmg", 2, 4, 4, coarsest="exact")
    jv, _ = JSub.plan_fused_cycles(JPoisson(3), jg, F32, exact,
                                   interpret=True)
    assert any(_fused(jv))
    for cyc, dtype in ((_cycle(coarsest="exact"), torch.float32),
                       (_cycle(smoother="jacobi"), torch.float32),
                       (_cycle(scheme="fas"), torch.float32),
                       (_cycle(), torch.float64), (None, torch.float32)):
        tv, tc = S.plan_fused_cycles(TPoisson(3), tg, cyc, dtype)
        assert not any(_fused(tv)) and not any(_fused(tc))
    from pde_multigrid_tpu_torch.models import Lyapunov2D

    assert not S.subtree_ok(Lyapunov2D(), tg)


def test_correction_plan_when_the_capacity_shrinks(monkeypatch):
    """With the capacity shrunk so that the 32^3 root's V-cycle does not
    fit but the correction's deeper levels do, the plan puts the
    correction-only variant there (vfns[1] is set), as JAX's rule does
    with its budgets shrunk (tests/test_pallas.py:161-170); a V(2, 3)
    cycle through the hooks (the correction hook, the root relaxed by the
    split relax) equals the unfused chain bit for bit."""
    _, tg = _hier(33)
    need_v = S.layout(tuple(tg), True)["smem_bytes"]
    need_c = S.layout(tuple(tg), False)["smem_bytes"]
    assert need_c < need_v
    monkeypatch.setattr(S, "CAPACITY", S.CLUSTER_CTAS * need_c)
    cyc = CycleConfig("v", 0, 2, 3)
    tv, tc = S.plan_fused_cycles(TPoisson(3), tg, cyc)
    assert _fused(tv) == [False, True, True, True, True]
    assert _fused(tc) == [True, False, False, False, False]
    prob = TPoisson(3)
    v, f = _vf(tg[0].padded_shape, seed=3)
    outs, calls = [], []
    for tier in (CudaKernels(prob, tg, torch.float32, cycle=cyc),
                 CudaKernels(prob, tg, torch.float32)):
        calls.append([])
        for name in ("fused_vcycle", "fused_correction"):
            hook = getattr(tier, name)

            def counted(l, a, b, hook=hook, name=name, log=calls[-1]):
                out = hook(l, a, b)
                log.append((name, l, out is not None))
                return out

            setattr(tier, name, counted)
        levels = [prob.init_level(g) for g in tg]
        levels[0].v, levels[0].f = torch.tensor(v), torch.tensor(f)
        CycleProgram(prob, tg, cyc, tier).v_cycle(levels, 0)
        outs.append(levels[0].v)
    assert torch.equal(outs[0], outs[1])
    # the fused tier: no V-cycle kernel at 0, the correction kernel there;
    # the tier without a plan answers None at every level it is asked
    assert calls[0] == [("fused_vcycle", 0, False),
                        ("fused_correction", 0, True)]
    assert not any(done for _, _, done in calls[1])
    assert [l for name, l, _ in calls[1] if name == "fused_vcycle"] == [
        0, 1, 2, 3, 4]


def test_mixed_keeps_the_fused_roots():
    """With precision="mixed" the 129^3 preset hierarchy keeps its fused
    roots 64^3 ... 2^3, and the 128^3 level's long legs take the defect
    path: the fused hook is consulted before any relax leg."""
    _, tg = _hier(129)
    k = CudaKernels(TPoisson(3), tg, torch.float32, mixed=True,
                    cycle=_cycle())
    assert _fused(k._sub_v) == [False] + [True] * 6
    assert k._defect[0] is not None and k._defect[0].min_sweeps <= 3000
    taken = []
    k._defect[0] = lambda v, f, n: taken.append(("defect", n)) or v
    k._defect[0].min_sweeps = D.RESIDENT_MIN_SWEEPS
    k._sub_v[1] = lambda v, f: taken.append(("fused", 1)) or v
    k.residual_restrict = lambda *a, **kw: torch.zeros(tg[1].padded_shape)
    k.prolong_blend = lambda l, base, c, m, mode: base
    levels = [TG.Level(v=torch.zeros(g.padded_shape),
                       f=torch.zeros(g.padded_shape),
                       aux={"m_int": None, "m_log": None})
              for g in tg[:2]] + [None] * 5
    prog = CycleProgram(TPoisson(3), tg, _cycle(), k)
    prog.v_cycle(levels, 0)
    assert taken == [("defect", 3000), ("fused", 1), ("defect", 3000)]


def test_presets_plan_at_their_real_sizes():
    """The 3D presets (129^3 and 257^3, FMG(2, 3000, 3000), relaxed to
    2^3) on CPU tensors' geometry: every root of 64^3 and below fused,
    the 128^3 level by the half-sweeps, 256^3 by the wavefront; the 64^3
    root's layout holds its v and its f in shared memory, 64^3, 32^3 and
    16^3 cut over one 16-CTA cluster, within one CTA's 227 KB."""
    for name, top in (("poisson3d", [False]), ("poisson3d-cuda",
                                               [False, False])):
        p = PRESETS[name]
        assert (p["nu0"], p["nu1"], p["nu2"]) == (2, 3000, 3000)
        tg = TG.build_geometries((p["n"],) * 3, DOM, wrap=True)
        k = CudaKernels(TPoisson(3), tg, torch.float32,
                        cycle=_cycle())
        assert _fused(k._sub_v) == top + [True] * 6
        assert not any(_fused(k._sub_c))
        wave = [R.timeskew_plan(g) for g in tg[:len(top)]]
        assert wave == ([False] if p["n"] == 129 else [True, False])
    lay = S.layout(tuple(tg[2:]), True)
    assert lay["nctas"] == S.CLUSTER_CTAS == 16
    assert lay["threads"] == S.THREADS
    assert lay["levels"][0][1] >= 0 and lay["levels"][0][2] >= 0
    assert lay["smem_bytes"] <= S.MAX_SMEM_BYTES
    assert [n for n, _, _ in lay["levels"]] == [16, 16, 16, 1, 1, 1]


# ---------------------------------------------------------- (e) wrapper


def test_wrapper_refuses_what_the_kernel_does_not_take():
    _, tg = _hier(17)
    prob = TPoisson(3)
    v, f = (torch.tensor(a) for a in _vf(tg[0].padded_shape, seed=1))
    with pytest.raises(TypeError):
        S.subtree_vcycle(v.double(), f.double(), prob, tg, 1, 1)
    with pytest.raises(ValueError, match="contiguous"):
        S.subtree_vcycle(v.transpose(0, 2), f, prob, tg, 1, 1)
    padded = TG.build_geometries((17,) * 3, DOM, wrap=False)
    with pytest.raises(ValueError, match="wrap"):
        S.subtree_vcycle(torch.zeros(padded[0].padded_shape),
                         torch.zeros(padded[0].padded_shape), prob, padded,
                         1, 1)
    with pytest.raises(ValueError, match="mu=0"):
        S.subtree_vcycle(v, f, prob, tg, 1, 1, mu=0)
    with pytest.raises(ValueError, match="coarser"):
        S.subtree_vcycle(v[:2, :2, :2].contiguous(), f[:2, :2, :2]
                         .contiguous(), prob, tg[-1:], 1, 1, False)
    # on CPU tensors the wrapper runs the plain version, in place on v
    want = S.subtree_vcycle_plain(v, f, prob, tg, 2, 1)
    out = S.subtree_vcycle(v, f, prob, tg, 2, 1)
    assert out is v and torch.equal(v, want)


# ------------------------------------------------------------ (f) slice


def test_fmg_through_the_hooks_matches_jax_pallas():
    """FMG(2, 2, 3), coarsest="relax", at 17^3 through CudaKernels on CPU
    tensors (every V-cycle one fused hook call: the plain version), then
    one V-cycle, against JAX's backend="pallas" solve in interpret mode on
    the unpadded hierarchy (its fused subtree kernels and small transfer
    kernels) from the same levels.  The hooks are called exactly where
    the plan says: once per V-cycle, at its root.  Tolerances: the logical
    solution within 1e-5 of max|v| and the residual history to 1e-4
    relative (a few float32 ulp per sweep, see the module note)."""
    cyc = dict(kind="fmg", nu0=2, nu1=2, nu2=3)
    js = J.MultigridSolver(J.Poisson3D(), 17, J.SolverConfig(
        cycle=J.CycleConfig(**cyc), backend="pallas", max_cycles=2, tol=0.0,
        pad_last_to=1, pad_sublane_to=1))
    from pde_multigrid_tpu.ops.pallas.dispatch import PallasKernels

    assert isinstance(js.program.kernels, PallasKernels)
    assert all(fn is not None for fn in js.program.kernels._sub_v)
    ts = MultigridSolver(TPoisson(3), 17, SolverConfig(
        cycle=CycleConfig(**cyc), max_cycles=2, tol=0.0), device="cpu")
    kern = CudaKernels(ts.problem, ts.geoms, torch.float32,
                       cycle=ts.config.cycle)
    calls = []
    hook = kern.fused_vcycle
    kern.fused_vcycle = lambda l, v, f: (calls.append(l), hook(l, v, f))[1]
    ts.program = CycleProgram(ts.problem, ts.geoms, ts.config.cycle, kern)
    jl = js.fresh_levels()
    arrays = [{"v": np.asarray(l.v), "f": np.asarray(l.f),
               "aux": {k: np.asarray(a) for k, a in l.aux.items()}}
              for l in jl]
    jr = js.solve_to_tolerance(jl)
    tr = ts.solve_to_tolerance(levels_from_numpy(ts.geoms, arrays))
    # FMG: nu0 V-cycles from each of the 4 levels, coarsest first; then
    # one V-cycle from the finest
    assert calls == [3, 3, 2, 2, 1, 1, 0, 0, 0]
    a = to_logical(np.asarray(jr.v), js.geoms[0])
    b = to_logical(tr.v, ts.geoms[0])
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-5 * np.abs(a).max())
    assert len(tr.residual_history) == len(jr.residual_history) == 2
    np.testing.assert_allclose(tr.residual_history, jr.residual_history,
                               rtol=1e-4)
    h = ts.geoms[0].spacing[0]
    assert tr.error_linf < 50 * h * h


def test_layout_reads_the_root_f_from_device_memory():
    """At every root of the 129^3 preset hierarchy, 64^3 ... 2^3, the
    kernel's layout holds every level's v and f in shared memory, the
    root's f loaded beside its v, each level's v then f, packed without
    overlap; the correction-only variant reads the root's f from device
    memory (offset -1) and needs that much less."""
    tg = TG.build_geometries((129,) * 3, DOM, wrap=True)
    for l in range(1, len(tg)):
        sub = tuple(tg[l:])
        full = S.layout(sub, True)
        held = [int(np.prod(g.padded_shape)) // n
                for g, (n, _, _) in zip(sub, full["levels"])]
        offs = [o for _, v, f in full["levels"] for o in (v, f)]
        assert offs == [0] + list(np.cumsum(
            [h for h in held for _ in (0, 1)])[:-1])
        # a split root's halo planes after the levels: 4 of a half's plane
        off, plane = full["halo"]
        g = sub[0].padded_shape
        split = full["nctas"] > 1
        assert (off, plane) == ((2 * sum(held), g[1] * g[2] // 2) if split
                                else (0, 0))
        assert full["smem_bytes"] == 4 * (2 * sum(held) + 4 * plane)
        if len(sub) > 1:
            corr = S.layout(sub, False)
            assert corr["levels"][0][1:] == (0, -1)
            assert corr["levels"][1:] == [
                (n, v - held[0], f - held[0])
                for n, v, f in full["levels"][1:]]
            assert corr["halo"] == ((off - held[0], plane) if split
                                    else (0, 0))
            assert corr["smem_bytes"] == full["smem_bytes"] - 4 * held[0]


def _roots():
    """(root, with_root_relax) of the 65^3 wrap hierarchy: every root of
    64^3 ... 2^3 whole, and the correction where a coarser level exists."""
    return [(l, wr) for l in range(6) for wr in (True, False)
            if wr or l < 5]


def _owned_planes(lay, sub):
    """Per level, the x-planes each CTA of the launch holds, as the kernel
    cuts them (csrc/halves3d.cuh view_of: CTA r of n the planes
    [r X / n, (r + 1) X / n); a level on CTA 0 whole there)."""
    out = []
    for g, (n, _, _) in zip(sub, lay["levels"]):
        X = g.padded_shape[0]
        out.append([list(range(r * X // n, (r + 1) * X // n))
                    for r in range(n)])
    return out


@pytest.mark.parametrize("l,with_root_relax", _roots())
def test_layout_fits_every_root(l, with_root_relax):
    """Every root 64^3 ... 2^3 in both variants fits one CTA's shared
    memory; a split level's x-planes are held exactly once over the
    cluster, each CTA's slab a whole number of the kernel's runs, and its
    arrays sized to that slab; the root's f lies in shared memory exactly
    when the root is relaxed; a split root's halo planes, one per colour
    and side, hold a half's plane of every split level and lie past every
    level's arrays, 16-byte aligned."""
    _, tg = _hier(65)
    sub = tuple(tg[l:])
    lay = S.layout(sub, with_root_relax)
    assert lay is not None and 0 < lay["smem_bytes"] <= S.MAX_SMEM_BYTES
    assert (lay["levels"][0][2] >= 0) == with_root_relax
    assert 32 <= lay["threads"] <= S.THREADS and lay["threads"] % 32 == 0
    cut = False
    for g, (n, v, f), planes in zip(sub, lay["levels"],
                                    _owned_planes(lay, sub)):
        X, Y, Z = g.padded_shape
        assert n in (1, lay["nctas"])
        assert sorted(x for p in planes for x in p) == list(range(X))
        slab = X // n
        assert slab % S.RUN == 0 or slab in (1, 2)
        assert 4 * (v + slab * Y * Z) <= lay["smem_bytes"]
        assert f < 0 or 4 * (f + slab * Y * Z) <= lay["smem_bytes"]
        if n > 1:
            assert not cut  # the split levels come first
            off, plane = lay["halo"]
            assert Y * Z // 2 <= plane and v % 4 == 0
            assert max(v, f) + slab * Y * Z <= off and off % 4 == 0
            assert 4 * (off + 4 * plane) <= lay["smem_bytes"]
        cut = cut or n == 1
    assert lay["nctas"] == (16 if sub[0].padded_shape[0] > 8 else 1)


@pytest.mark.parametrize("root,ctas,fits", [(64, 16, True), (64, 8, False),
                                            (32, 16, True), (32, 8, True)])
def test_layout_cluster_per_root(root, ctas, fits):
    """A split root's cluster: 16 CTAs hold a 64^3 root's v and f (8 do
    not: 256 KB a CTA), the 32^3 root runs on either; the layout takes 16
    by default, and a level below on CTA 0 keeps its arrays whole whatever
    the cluster."""
    _, tg = _hier(65)
    sub = tuple(tg[[g.padded_shape[0] for g in tg].index(root):])
    lay = S.layout(sub, True, ctas=ctas)
    assert (lay is not None) == fits
    if fits:
        assert lay["nctas"] == ctas
        assert [n for n, _, _ in lay["levels"]] == [
            ctas if g.padded_shape[0] >= 16 else 1 for g in sub]
        for g, (n, _, _), planes in zip(sub, lay["levels"],
                                        _owned_planes(lay, sub)):
            assert [len(p) for p in planes] == [g.padded_shape[0] // n] * n
    default = S.layout(sub, True)
    assert default["nctas"] == S.CLUSTER_CTAS


@pytest.mark.parametrize("n", [129, 257])
def test_no_correction_fits_at_128(n):
    """At the kernel's capacity (16 CTAs of 227 KB) neither variant rooted
    at 128^3 fits: the correction-only variant holds the root's v, 512 KB
    a CTA.  So the plan fuses nothing above 64^3, as JAX's budgets do."""
    _, tg = _hier(n)
    l128 = [g.padded_shape[0] for g in tg].index(128)
    for wr in (True, False):
        assert S.layout(tuple(tg[l128:]), wr) is None
    assert S.layout(tuple(tg[l128 + 1:]), True) is not None
    assert S.CAPACITY == 16 * S.MAX_SMEM_BYTES


def test_refused_cluster_raises(monkeypatch):
    """Where the card runs no cluster of the launch
    (cudaOccupancyMaxActiveClusters 0), the launch raises before any
    kernel is launched: no fallback to a smaller cluster or to the plain
    version.  The card is asked once per launch shape."""
    asked = []

    def clusters(params, out):
        asked.append(params._obj.nctas)
        out._obj.value = 0
        return 0

    lib = type("Lib", (), {"pdemg_subtree_clusters": staticmethod(clusters)})
    monkeypatch.setattr(S.build, "load", lambda: type("L", (), {"lib": lib}))
    _, tg = _hier(65)
    params = S._params(tuple(tg), 1, 1, True, S.CAPACITY)
    assert params.nctas == 16
    v, f = (torch.tensor(a) for a in _vf(tg[0].padded_shape, seed=5))
    for _ in range(2):
        with pytest.raises(RuntimeError, match="no cluster of 16 CTAs"):
            S._launch(v, f, params)
    assert asked == [16, 16]  # a refusal is not remembered
