"""Port parity of the 1D kernel module's plain version (what the relax1d
wrapper runs for CPU tensors) against the JAX package's Pallas kernels in
interpret mode, and the CUDA tier's plan for 1D hierarchies.

The kernel itself builds and runs only on a GPU; `chip_smoke.py` holds it
against its plain version there, bit for bit.  Here the wrapper must take
the plain path for CPU tensors, count no launch, and reject what the
kernel does not take.

Tolerances, float32:
  * Ode1D against `make_split_resident_relax_1d`: 2 ulp of the largest
    value per sweep.  Both sides evaluate east * a_e + f * a_f from the
    same coefficients (checked equal), but XLA's CPU backend, which runs
    the interpreted kernel, contracts the product and the sum into one
    fused multiply-add (one rounding less per half-sweep), and the
    differences carry into later sweeps (4 ulp seen after 5 sweeps);
  * Poisson(1) against `make_resident_relax`: bitwise (no contraction
    changes its rounding);
  * against JAX `stencil.relax_rbgs` (the jnp tier's division form) at the
    port's odd, unpadded extents: rtol 2e-5, atol 2e-6, the tolerance of
    the JAX package's own test of the Pallas kernel against it
    (tests/test_pallas.py); in float64, 1e-12.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pde_multigrid_tpu import Ode1D as JOde1D
from pde_multigrid_tpu import Poisson as JPoisson
from pde_multigrid_tpu.grid import base_aux as jbase_aux
from pde_multigrid_tpu.grid import build_geometries as jbuild
from pde_multigrid_tpu.ops import stencil as JS
from pde_multigrid_tpu.ops.pallas import relax as JR
from pde_multigrid_tpu_torch import Lyapunov2D, Ode1D, Poisson
from pde_multigrid_tpu_torch import grid as TG
from pde_multigrid_tpu_torch.cycles import CycleProgram
from pde_multigrid_tpu_torch.ops.cuda import relax1d as R1
from pde_multigrid_tpu_torch.ops.cuda.dispatch import CudaKernels

F32 = jnp.dtype("float32")
F64T = torch.float64
DOM = ((0.0, 1.0),)


@pytest.fixture(autouse=True)
def _no_launches():
    """CPU tensors never launch a kernel: the counter stays at zero."""
    R1.reset_launches()
    yield
    assert not any(R1.launches.values())


def _rand(shape, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(dtype),
            rng.standard_normal(shape).astype(dtype))


def _ulp(a):
    return np.spacing(np.float32(np.abs(a).max()))


# ---------------------------------------------------------------- Ode1D


@pytest.mark.parametrize("ns", [1, 5])
@pytest.mark.parametrize("n", [129, 1025])
def test_ode1d_plain_matches_pallas_split_kernel(n, ns):
    """At the TPU's padded geometry (pad_last_to=128: 129 -> 256 points,
    1025 -> 1152), the plain version against the interpreted Pallas
    kernel, on the logical points (padding is inert on both sides)."""
    jg = jbuild((n,), DOM, None, pad_last_to=128)[0]
    tg = TG.build_geometries((n,), DOM, None, pad_last_to=128)[0]
    assert tg.padded_shape == jg.padded_shape and tg.padded_shape[0] > n
    v, f = _rand(jg.padded_shape, seed=n + ns)
    # the kernel's coefficients are the ones the Pallas kernel computes
    (x,) = tg.coords(torch.float32)
    pre = Ode1D().kernel_precompute((x,), tg, torch.float32)
    jpre = JOde1D().kernel_precompute((jnp.asarray(x.numpy()),), jg, F32)
    for k in pre:
        np.testing.assert_array_equal(pre[k].numpy(), np.asarray(jpre[k]))
    fn = JR.make_split_resident_relax_1d(JOde1D(), jg, F32, interpret=True)
    want = np.asarray(fn(jnp.asarray(v), jnp.asarray(f), ns))[:n]
    got = R1.relax1d(torch.tensor(v), torch.tensor(f), ns, Ode1D(), tg)
    np.testing.assert_allclose(got.numpy()[:n], want, rtol=0,
                               atol=2 * ns * _ulp(want))


@pytest.mark.parametrize("n", [3, 5, 9, 33, 8193])
def test_ode1d_plain_matches_jnp_at_odd_extents(n):
    """The port's unpadded odd extents (8193 and 4097 on the bench row;
    3-17 on the preset's coarse levels, fewer points than a warp): the
    plain version against JAX stencil.relax_rbgs with the jnp division
    form, in float32 and float64.  Boundary points keep their values."""
    jg = jbuild((n,), DOM)[0]
    tg = TG.build_geometries((n,), DOM)[0]
    jp, tp = JOde1D(), Ode1D()
    for dtype, tol in ((np.float32, dict(rtol=2e-5, atol=2e-6)),
                       (np.float64, dict(rtol=0, atol=1e-12))):
        v, f = _rand(n, seed=n, dtype=dtype)
        jdt = jnp.dtype(dtype)
        aux = {**jbase_aux(jg, jdt), **jp.make_aux(jg, jdt)}
        want = np.asarray(JS.relax_rbgs(
            lambda a, b: jp.relax_update(a, b, jg, aux), jnp.asarray(v),
            jnp.asarray(f), aux["m_red"], aux["m_black"], 5))
        got = R1.relax1d_plain(torch.tensor(v), torch.tensor(f), 5, tp, tg)
        assert got.dtype == torch.tensor(v).dtype
        np.testing.assert_allclose(got.numpy(), want, **tol)
        assert got[0] == v[0] and got[-1] == v[-1]


def test_wrapper_takes_the_plain_version_on_cpu():
    """The wrapper on CPU tensors is the plain version, bit for bit, in
    place on v."""
    tg = TG.build_geometries((33,), DOM)[0]
    v, f = (torch.tensor(a) for a in _rand(33, seed=1))
    want = R1.relax1d_plain(v.clone(), f, 7, Ode1D(), tg)
    w = v.clone()
    got = R1.relax1d(w, f, 7, Ode1D(), tg)
    assert got is w and torch.equal(got, want)


# ------------------------------------------------------------ Poisson(1)


@pytest.mark.parametrize("ns", [1, 5])
@pytest.mark.parametrize("n", [33, 257])
def test_poisson1d_plain_matches_pallas_resident(n, ns):
    """Wrap storage (2^k stored points, index 0 the zero plane, the east
    neighbour of the last point wraps onto it): the plain version against
    the interpreted 1D branch of make_resident_relax, bitwise."""
    jg = jbuild((n,), DOM, None, wrap=True)[0]
    tg = TG.build_geometries((n,), DOM, None, wrap=True)[0]
    assert tg.wrap and tg.padded_shape == jg.padded_shape == (n - 1,)
    v, f = _rand(tg.padded_shape, seed=ns)
    v[0] = 0.0
    fn = JR.make_resident_relax(JPoisson(1), jg, F32, interpret=True)
    want = np.asarray(fn(jnp.asarray(v), jnp.asarray(f), ns))
    got = R1.relax1d(torch.tensor(v), torch.tensor(f), ns, Poisson(1), tg)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[0] == 0.0


def test_poisson_kernel_update_matches_jax():
    """Poisson.kernel_update in 1D (and 3D) against the JAX form, float64."""
    for nd, n in ((1, 33), (3, 9)):
        jg = jbuild((n,) * nd, DOM * nd, None, wrap=True)[0]
        tg = TG.build_geometries((n,) * nd, DOM * nd, None, wrap=True)[0]
        v, f = _rand(tg.padded_shape, seed=nd, dtype=np.float64)
        want = JPoisson(nd).kernel_update(jnp.asarray(v), jnp.asarray(f), {},
                                          jg)
        got = Poisson(nd).kernel_update(torch.tensor(v), torch.tensor(f), {},
                                        tg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12)
        assert Poisson(nd).kernel_precompute(None, tg, torch.float64) == {}


# ------------------------------------------------------------- the plan


def _tier(problem, n, coarsest="exact", wrap=False, mixed=False):
    from pde_multigrid_tpu_torch.solver import _exact_num_levels

    nl = _exact_num_levels(problem, n, wrap) if coarsest == "exact" else None
    geoms = TG.build_geometries((n,), problem.domain, nl, wrap=wrap)
    relaxed = range(len(geoms) - (coarsest == "exact"))
    return geoms, CudaKernels(problem, geoms, torch.float32, relaxed,
                              mixed=mixed)


@pytest.mark.parametrize("mixed", [False, True])
def test_plan_for_1d_hierarchies(mixed):
    """ode1d 8193 exact-coarsest: 8193 and 4097 take relax1d, 2049 is the
    dense coarse solve; the preset's 13 levels (relax-coarsest) all take
    it, down to 3 points; Poisson(1) 8193 in wrap storage relaxes 8192 and
    4096 stored points and solves 2049 by fast diagonalization (the first
    level the dense inverse would take, as in JAX).  No defect plan
    covers a 1D level: with mixed the levels relax in float32."""
    geoms, k = _tier(Ode1D(), 8193, mixed=mixed)
    assert [g.shape[0] for g in geoms] == [8193, 4097, 2049]
    assert k._relax[:2] == [k._relax_1d] * 2 and k._relax[2] is None
    assert all(d is None for d in k._defect)
    geoms, k = _tier(Ode1D(), 8193, coarsest="relax", mixed=mixed)
    assert len(geoms) == 13 and geoms[-1].shape == (3,)
    assert all(r == k._relax_1d for r in k._relax)
    geoms, k = _tier(Poisson(1), 8193, wrap=True, mixed=mixed)
    assert geoms[0].padded_shape == (8192,) and geoms[-1].shape == (2049,)
    assert all(r == k._relax_1d for r in k._relax[:-1])
    assert all(d is None for d in k._defect)


def test_plan_raises_above_the_kernel_capacity():
    """65537 points fit the cluster (16 CTAs of units of one warp, K = 8
    where K = 4 does not hold them), in both storages; 131073 do not, and
    the plan raises naming its ROADMAP item instead of running plain ops
    on the card.  2D Poisson is planned on the 2D dense leg, which
    relax1d's layout does not serve."""
    for prob, wrap in ((Ode1D(), False), (Poisson(1), True)):
        fit = TG.build_geometries((65537,), DOM, 1, wrap=wrap)[0]
        lay = R1.layout(fit, prob)
        assert lay is not None and lay.K == 8 and lay.nctas <= R1.MAX_CTAS
        big = TG.build_geometries((131073,), DOM, 2, wrap=wrap)
        assert R1.layout(big[0], prob) is None
        assert R1.layout(big[1], prob) is not None
        with pytest.raises(NotImplementedError, match="queue 2 item 29"):
            CudaKernels(prob, big, torch.float32)
    g2 = TG.build_geometries((17, 17), DOM * 2)
    k2 = CudaKernels(Poisson(2), g2, torch.float32)  # 2D: not relax1d's
    assert k2._relax == [k2._relax_resident] * len(g2)
    assert R1.layout(g2[0], Poisson(2)) is None


def _units(lay):
    """(first held point, first owned, past the last owned) of each unit,
    as csrc/relax1d.cu computes them."""
    return [(u * lay.B - lay.HW, u * lay.B, u * lay.B + lay.B)
            for u in range(lay.nctas * lay.wpc)]


LAYOUT_SIZES = (3, 5, 9, 17, 33, 65, 129, 257, 513, 1025, 4097, 8193, 16385,
                65537)


@pytest.mark.parametrize("n", LAYOUT_SIZES)
@pytest.mark.parametrize("problem,wrap", [(Ode1D(), False),
                                          (Poisson(1), True)],
                         ids=["ode1d", "poisson1d"])
def test_relax1d_layout_covers_each_point(problem, wrap, n):
    """The layout's units own each point the kernel holds exactly once
    (E = N, or N + 1 in wrap storage, whose point N is point 0); a unit's
    span is its lanes' 64 K points, its owned points and halos; the halo
    is 2T points east only for Ode1D and on both sides for Poisson(1),
    whole lanes; a level of at most 512 points runs on one warp without a
    halo; at most 16 CTAs of at most 16 warps."""
    g = TG.build_geometries((n,), DOM, 1, wrap=wrap)[0]
    lay = R1.layout(g, problem)
    (N,) = g.padded_shape
    assert lay.N == N and lay.E == N + wrap and lay.last == n - 2
    assert lay.K in R1.K_CHOICES and lay.threads == 32 * lay.wpc
    assert 1 <= lay.nctas <= R1.MAX_CTAS and 1 <= lay.wpc <= R1.MAX_WARPS
    assert lay.HW + lay.B + lay.HE == 64 * lay.K
    if lay.E <= 512:
        assert (lay.nctas, lay.wpc, lay.T, lay.HW, lay.HE) == (1, 1, 0, 0, 0)
    else:
        assert lay.T >= 1 and lay.HE == 2 * lay.T
        assert lay.HW == (0 if isinstance(problem, Ode1D) else 2 * lay.T)
        assert lay.HE % (2 * lay.K) == 0 and lay.B % (2 * lay.K) == 0
        assert lay.B >= 2 * lay.T
    count = np.zeros(lay.E, dtype=np.int64)
    for st, o0, o1 in _units(lay):
        count[max(o0, 0):min(o1, lay.E)] += 1
        if lay.T:
            assert st == o0 - lay.HW and o1 + lay.HE == st + 64 * lay.K
    np.testing.assert_array_equal(count, 1)


def _unit_schedule(v, f, nsweeps, problem, geom, lay):
    """The relax1d kernel's schedule in plain PyTorch: chunks of T sweeps
    (one chunk on one unit); each unit's span (its owned points with the
    halo points the layout gives it, 0 past the level, point N = point 0
    in wrap storage) relaxed on its own by the plain update, its edge
    points reading whatever sits past the span (here the span's other
    end); after each chunk the owned points form the level the next
    chunk's spans load from (the halo refresh).  Returns a new tensor."""
    N, E = lay.N, lay.E
    m_red, m_black, pre = R1._plain_fields(problem, geom, v.dtype, v.device)

    def held(a, interior=False):
        out = torch.cat([a, a[:1]]) if E > N else a.clone()
        if interior and E > N:
            out[N] = 0  # point N is the zero plane's copy: never updated
        return out

    state, fe = held(v), held(f)
    pe = {k: held(t) for k, t in pre.items()}
    mr, mb = held(m_red, True), held(m_black, True)
    T = lay.T or max(nsweeps, 1)
    done = 0
    while done < nsweeps:
        tc = min(T, nsweeps - done)
        new = state.clone()
        for st, o0, o1 in _units(lay):
            idx = torch.arange(st, st + 64 * lay.K)
            inside = (idx >= 0) & (idx < E)
            gi = idx.clamp(0, E - 1)

            def take(a):
                return torch.where(inside, a[gi], torch.zeros((), dtype=a.dtype))

            sv, sf, smr, smb = take(state), take(fe), take(mr), take(mb)
            spre = {k: take(t) for k, t in pe.items()}
            for _ in range(tc):
                sv = sv + smr * (problem.kernel_update(sv, sf, spre, geom) - sv)
                sv = sv + smb * (problem.kernel_update(sv, sf, spre, geom) - sv)
            own = inside & (idx >= o0) & (idx < o1)
            new[idx[own]] = sv[own]
        state, done = new, done + tc
    return state[:N]


@pytest.mark.parametrize("n", [1025, 8193])
@pytest.mark.parametrize("problem,wrap", [(Ode1D(), False),
                                          (Poisson(1), True)],
                         ids=["ode1d", "poisson1d"])
def test_relax1d_unit_schedule_matches_plain(problem, wrap, n):
    """The units' T-sweep schedule (spans with their recomputed 2T-point
    halos, east only for Ode1D, refreshed every T sweeps) equals
    relax1d_plain bit for bit at 1, T - 1, T, T + 1 and 30 sweeps."""
    g = TG.build_geometries((n,), DOM, 1, wrap=wrap)[0]
    lay = R1.layout(g, problem)
    T = lay.T
    assert T >= 2 and lay.nctas * lay.wpc > 1
    v, f = (torch.tensor(a) for a in _rand(g.padded_shape, seed=n + wrap))
    if wrap:
        v[0] = 0.0  # the wrap invariant: the zero plane
    for ns in (1, T - 1, T, T + 1, 30):
        want = R1.relax1d_plain(v.clone(), f, ns, problem, g)
        got = _unit_schedule(v, f, ns, problem, g, lay)
        assert torch.equal(got, want), ns


def test_wrapper_rejects_what_the_kernel_does_not_take():
    tg = TG.build_geometries((33,), DOM)[0]
    v, f = (torch.tensor(a) for a in _rand(33, seed=2))
    with pytest.raises(ValueError, match="f of v's shape"):
        R1.relax1d(v, None, 1, Ode1D(), tg)
    with pytest.raises(ValueError, match="does not match"):
        R1.relax1d(v[:17], f[:17], 1, Ode1D(), tg)
    with pytest.raises(TypeError, match="Ode1D"):
        R1.relax1d(v, f, 1, Lyapunov2D(), tg)
    with pytest.raises(TypeError, match="float32"):
        R1.relax1d(v.double(), f.double(), 1, Ode1D(), tg)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        R1.relax1d(v.to("meta"), f.to("meta"), 1, Ode1D(), tg)


@pytest.mark.parametrize("problem,n,wrap", [
    (Ode1D(), 257, False), (Poisson(1), 257, True)], ids=["ode1d", "poisson1d"])
def test_cuda_tier_on_cpu_tensors_matches_the_plain_tier(problem, n, wrap):
    """FMG(2, 20, 20) with the CUDA tier's plan on CPU tensors (relax1d's
    plain version; plain transfers) against the plain tier: the Pallas
    update form against the jnp one, the same solve to float32
    rounding."""
    import pde_multigrid_tpu_torch as T

    cfg = T.SolverConfig(cycle=T.CycleConfig("fmg", 2, 20, 20,
                                             coarsest="exact"))
    ts = T.MultigridSolver(problem, n, cfg, device="cpu")
    assert ts.geoms[0].wrap == wrap
    plain = ts.solve()
    k = CudaKernels(problem, ts.geoms, torch.float32,
                    range(len(ts.geoms) - 1))
    ts.program = CycleProgram(problem, ts.geoms, cfg.cycle, k)
    tier = ts.solve()
    scale = float(plain.v.abs().max())
    np.testing.assert_allclose(tier.v.numpy(), plain.v.numpy(), rtol=0,
                               atol=1e-5 * scale)
    np.testing.assert_allclose(tier.error_linf, plain.error_linf, rtol=1e-3)


def _chip_smoke():
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_row_float32_gap_belongs_to_the_pallas_form():
    """The bench's ode1d row (8193, FMG(2, 1000, 1000), exact coarsest) in
    float32: the CUDA tier's plan on CPU tensors (relax1d's plain version,
    the kernel's update bit for bit) against JAX's Pallas tier in
    interpret mode (`make_split_resident_relax_1d` at 8320 padded points)
    and JAX's jnp tier (the division form), each against the port's
    float64 solve (equal to JAX's, test_torch_ode1d.py).  The two Pallas-
    form solves' error_linf agree to 2 ulp of max|u| = |u(0)| = 1 (XLA's
    CPU backend contracts products and sums the plain version keeps
    apart); both lie about 1 % from the float64 solve's, where the issue's
    1 % gate sits, so that distance belongs to the float32 Pallas form, not
    to the port.  Every form stays within chip_smoke.py's gate, 1 % +
    ODE_F32_FLOOR.  Run with -s for the readings."""
    import pde_multigrid_tpu as J
    import pde_multigrid_tpu_torch as T

    n, nus = 8193, (2, 1000, 1000)

    def port(dtype, kernels):
        cfg = T.SolverConfig(cycle=T.CycleConfig("fmg", *nus,
                                                 coarsest="exact"),
                             dtype=dtype)
        ts = T.MultigridSolver(Ode1D(), n, cfg, device="cpu")
        if kernels:
            k = CudaKernels(Ode1D(), ts.geoms, torch.float32,
                            range(len(ts.geoms) - 1))
            ts.program = CycleProgram(Ode1D(), ts.geoms, cfg.cycle, k)
        return ts.solve().error_linf

    def jax(backend):
        cfg = J.SolverConfig(cycle=J.CycleConfig("fmg", *nus,
                                                 coarsest="exact"),
                             backend=backend, dtype="float32")
        js = J.MultigridSolver(JOde1D(), n, cfg)
        if backend == "pallas":
            assert type(js.program.kernels).__name__ == "PallasKernels"
            assert js.geoms[0].padded_shape == (8320,)
        return js.solve().error_linf

    e64 = port("float64", False)
    errs = {"port kernel form": port("float32", True),
            "jax pallas (interpret)": jax("pallas"),
            "port plain (division form)": port("float32", False),
            "jax jnp (division form)": jax("jnp")}
    floor = _chip_smoke().ODE_F32_FLOOR
    print(f"\nfloat64 error_linf {e64!r}")
    for k, e in errs.items():
        print(f"{k}: error_linf {e!r}, {100 * (e - e64) / e64:+.3f} % of "
              f"the float64 solve's, {(e - e64) / 2.0 ** -23:+.2f} ulp")
        assert abs(e - e64) <= 0.01 * e64 + floor, k
    assert abs(errs["port kernel form"]
               - errs["jax pallas (interpret)"]) <= 2 * 2.0 ** -23
    for k in ("port kernel form", "jax pallas (interpret)"):
        assert errs[k] - e64 > 0.009 * e64, k


def test_poisson1d_float32_solves_stay_under_the_floor():
    """Poisson(1) at 8193, FMG(2, 100, 100), exact coarsest, in float32:
    the CUDA tier's plan on CPU tensors, JAX's Pallas tier in interpret
    mode (`make_resident_relax`, 1D branch) and both plain tiers, each
    against the port's float64 solve.  float32 cannot reach 50 h^2 here
    (h^-2 = 6.7e7 amplifies the rounding), and the forms scatter over
    4x; every one stays under chip_smoke.py's POISSON1D_F32_FLOOR, which
    must admit the JAX package's own float32 solves.  Run with -s for the
    readings."""
    import pde_multigrid_tpu as J
    import pde_multigrid_tpu_torch as T

    n, nus = 8193, (2, 100, 100)

    def port(dtype, kernels):
        cfg = T.SolverConfig(cycle=T.CycleConfig("fmg", *nus,
                                                 coarsest="exact"),
                             dtype=dtype)
        ts = T.MultigridSolver(Poisson(1), n, cfg, device="cpu")
        assert ts.geoms[0].wrap
        if kernels:
            k = CudaKernels(Poisson(1), ts.geoms, torch.float32,
                            range(len(ts.geoms) - 1))
            ts.program = CycleProgram(Poisson(1), ts.geoms, cfg.cycle, k)
        return ts.solve().v.double()

    def jax(backend):
        cfg = J.SolverConfig(cycle=J.CycleConfig("fmg", *nus,
                                                 coarsest="exact"),
                             backend=backend, dtype="float32")
        js = J.MultigridSolver(JPoisson(1), n, cfg)
        assert js.geoms[0].wrap
        if backend == "pallas":
            assert type(js.program.kernels).__name__ == "PallasKernels"
        return torch.tensor(np.asarray(js.solve().v)[:n - 1], dtype=F64T)

    v64 = port("float64", False)
    h = 1.0 / (n - 1)
    x = torch.arange(n - 1, dtype=F64T) * h
    assert float((v64 - torch.sin(torch.pi * x)).abs().max()) < 50 * h * h
    floor = _chip_smoke().POISSON1D_F32_FLOOR
    for k, v in {"port kernel form": port("float32", True),
                 "jax pallas (interpret)": jax("pallas"),
                 "port plain": port("float32", False),
                 "jax jnp": jax("jnp")}.items():
        dv = float((v - v64).abs().max())
        print(f"\n{k}: max|v - v_float64| {dv!r}", end="")
        assert dv < floor, k
