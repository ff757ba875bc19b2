"""Port parity of 3D Poisson in padded storage (a nonzero Dirichlet
boundary: [0, 1.5]^3, sin(1.5 pi) = -1 on the far faces) on the CUDA
tier's plan: the plain version of the padded forms of rows 1 and 3 (what
`padded3d.padded3d_relax` and `slab3d.slab3d_relax` run for CPU tensors)
against the JAX package's `make_resident_relax` and `make_slab_relax` in
interpret mode, plain emulations of the two kernels' schedules, the plan
of the 129^3, 257^3 and 513^3 padded hierarchies against JAX's
`plan_relax`, and whole solves through the plan against the plain tier
and JAX's jnp tier.

The kernels build and run only on a GPU; `chip_smoke.py` (phases
kernels_poisson3d_padded, poisson3d_padded, poisson3d_padded_cli) holds
each against its plain version there, bit for bit, on every level of the
513^3 padded hierarchy.  Here the wrappers take the plain path for CPU
tensors and count no launch.

The plan's deliberate differences from JAX's `plan_relax` (the TPU's VMEM
budgets against the kernels' capacity on the card):
  * 65^3: JAX's slab kernel (its VMEM budget refuses the resident one);
    here the whole leg, whose 16-CTA cluster holds the level on chip;
  * 257^3 and 513^3: JAX's jnp tier (its budget refuses every slab); here
    row 3's padded form (a sweep a launch), as the port gives row 6 the
    blocks JAX sends to jnp.
Everywhere JAX picks a kernel otherwise, the port picks its counterpart
(33^3 ... 3^3 the leg, 129^3 the slab).

Tolerances.  The plain versions against the interpreted Pallas kernels in
float32: 2 ulp of the largest value (XLA's CPU backend contracts the
update's products into the following sums).  The emulations against the
plain version: bitwise.  The CUDA tier's plan on CPU tensors against the
plain tier in float32: bitwise (the same blend form, the same plain
transfers).  Float64 solves of the plain tier against JAX jnp: the
residual history to 1e-9 relative and the logical solution to 1e-10 of
max|v|; float32 solves through the plan against JAX jnp: 1e-5 of max|v|
and the history to 1e-4 relative (XLA contracts products into FMAs, a few
ulp a sweep)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import pde_multigrid_tpu as J
from pde_multigrid_tpu import grid as JG
from pde_multigrid_tpu.ops.pallas import relax as JR
import pde_multigrid_tpu_torch as T
from pde_multigrid_tpu_torch import grid as TG
from pde_multigrid_tpu_torch import solver as TS
from pde_multigrid_tpu_torch.cycles import CycleProgram, TorchKernels
from pde_multigrid_tpu_torch.grid import to_logical
from pde_multigrid_tpu_torch.models.poisson import split_constants
from pde_multigrid_tpu_torch.ops.cuda import build
from pde_multigrid_tpu_torch.ops.cuda import dispatch as D
from pde_multigrid_tpu_torch.ops.cuda import padded3d as PD
from pde_multigrid_tpu_torch.ops.cuda import slab3d as SB
from pde_multigrid_tpu_torch.utils.convert import levels_from_numpy

F32 = jnp.dtype("float32")
ULPS = 2
JAX_PAD = dict(pad_last_to=128, pad_sublane_to=8)
DOM = ((0.0, 1.5),) * 3


@pytest.fixture(autouse=True)
def _no_launches():
    """CPU tensors never launch a kernel: every counter stays at zero."""
    for mod in (PD, SB):
        mod.reset_launches()
    yield
    for mod in (PD, SB):
        assert not any(mod.launches.values())


def _geoms(shape, levels=1):
    """(JAX geometries on the TPU padding, the port's unpadded ones)."""
    jg = JG.build_geometries(shape, DOM, levels, wrap=False, **JAX_PAD)
    tg = TG.build_geometries(shape, DOM, levels, wrap=False)
    return jg, tg


def _level(n, seed):
    """JAX and port geometries of an n^3 padded level and (v, f) on the
    JAX padded shape: N(0, 1) on the stored region, zero in the padding."""
    jg, tg = (g[0] for g in _geoms((n,) * 3))
    rng = np.random.default_rng(seed)
    v = np.zeros(jg.padded_shape, np.float32)
    f = np.zeros(jg.padded_shape, np.float32)
    v[:n, :n, :n] = rng.standard_normal((n,) * 3)
    f[:n, :n, :n] = rng.standard_normal((n,) * 3)
    return jg, tg, v, f


def _close(got, want, ulps=ULPS):
    ulp = np.spacing(np.float32(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=ulps * ulp)


def _rel(got, want, rel):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-300))


def _random(shape, seed):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(shape, generator=g), torch.randn(shape, generator=g))


# ---------------------------------------------- plain versions vs Pallas


@pytest.mark.parametrize("n", [9, 17])
def test_leg_plain_matches_pallas(n):
    """Row 1's padded form (padded3d_relax's plain version, v in place)
    against make_resident_relax interpreted on JAX's padded level (17,
    24, 128) / (9, 16, 128): 1 and 7 sweeps with f and 1 f-less
    (kernel_update_f_optional), compared on the logical level; the
    boundary values come out as they went in."""
    jg, tg, v, f = _level(n, seed=n)
    fn = JR.make_resident_relax(J.Poisson(3, domain=DOM), jg, F32,
                                interpret=True)
    prob = T.Poisson(3, domain=DOM)
    assert fn.supports_f_zero and prob.kernel_update_f_optional
    sl = (slice(0, n),) * 3
    fixed = (PD.masks(n, n, n, torch.float32, "cpu")[0]
             + PD.masks(n, n, n, torch.float32, "cpu")[1]) == 0
    for f_zero, ns in ((False, 1), (False, 7), (True, 1)):
        want = np.asarray(fn(jnp.asarray(v), jnp.asarray(f), ns,
                             f_zero=f_zero))[sl]
        vt = torch.tensor(v[sl])
        got = PD.padded3d_relax(vt, None if f_zero else torch.tensor(f[sl]),
                                ns, prob, tg)
        assert got is vt
        _close(got.numpy(), want)
        assert torch.equal(got[fixed], torch.tensor(v[sl])[fixed])


@pytest.mark.parametrize("B,T_", [(4, 1), (8, 1), (4, 2)])
def test_slab_plain_matches_pallas(B, T_):
    """Row 3's padded form (slab3d_relax's plain version) against
    make_slab_relax interpreted on 17^3 padded at B slab planes and T
    sweeps a call, 5 sweeps (JAX chains calls of T and the remainder)."""
    n, ns = 17, 5
    jg, tg, v, f = _level(n, seed=100 + B + T_)
    fn = JR.make_slab_relax(J.Poisson(3, domain=DOM), jg, F32, B, T_,
                            interpret=True)
    sl = (slice(0, n),) * 3
    want = np.asarray(fn(jnp.asarray(v), jnp.asarray(f), ns))[sl]
    vt = torch.tensor(v[sl])
    got = SB.slab3d_relax(vt, torch.tensor(f[sl]), ns,
                          T.Poisson(3, domain=DOM), tg)
    assert got is vt
    _close(got.numpy(), want)


def test_plain_forms_agree():
    """The plain versions: a leg of sweeps_plain is its half-sweeps in
    turn, in float64 too (the f-less half-sweep v + (kernel_update(v,
    None) - v) on its colour and v elsewhere), and the two wrappers' plain
    paths equal on a level both serve."""
    _, tg = (g[0] for g in _geoms((9, 17, 13)))
    prob = T.Poisson(3, domain=DOM)
    for dtype in (torch.float32, torch.float64):
        v, f = (t.to(dtype) for t in _random(tg.shape, 3))
        want = v
        for _ in range(3):
            for c in (0, 1):
                want = PD.half_sweep_plain(want, f, c, prob, tg)
        assert torch.equal(PD.sweeps_plain(v, f, 3, prob, tg), want)
        m = sum(PD.masks(*tg.shape, dtype, "cpu"))
        one = PD.half_sweep_plain(v, None, 0, prob, tg)
        upd = prob.kernel_update(v, None, {}, tg)
        red = PD.masks(*tg.shape, dtype, "cpu")[0] > 0
        assert torch.equal(one[red], (v + (upd - v))[red])
        assert torch.equal(one[m == 0], v[m == 0])
    v, f = _random(tg.shape, 4)
    assert torch.equal(PD.padded3d_relax(v.clone(), f, 4, prob, tg),
                       SB.slab3d_relax(v.clone(), f, 4, prob, tg))


# ------------------------------------------------- kernel emulations


def _blend(c, xm, xp, ym, yp, zm, zp, f, m, geom):
    """poisson3d.cuh's poisson3d_blend on tensors, in its order, with its
    float32 constants."""
    (w0, w1, w2), inv_den = split_constants(geom)
    w0, w1, w2, inv_den = (torch.tensor(np.float32(x)) for x in
                           (w0, w1, w2, inv_den))
    num = -f
    num = num + (xm + xp) * w0
    num = num + (ym + yp) * w1
    num = num + (zm + zp) * w2
    upd = num * inv_den
    return c + m * (upd - c)


def _mask(x, y, z, colour, geom):
    """poisson3d.cuh's poisson3d_mask on index tensors."""
    nx, ny, nz = geom.shape
    inside = ((x >= 1) & (x <= nx - 2) & (y >= 1) & (y <= ny - 2)
              & (z >= 1) & (z <= nz - 2))
    return (inside & ((x + y + z) % 2 == colour)).to(torch.float32)


def _bounds(geom):
    """csrc/padded3d.cu's split of the x planes: the first plane of each
    CTA of the layout and the end, CTA k owning [k X // nctas, (k + 1) X
    // nctas)."""
    lay = PD.leg_layout(geom)
    X = geom.shape[0]
    return tuple(k * X // lay.nctas for k in range(lay.nctas + 1))


def _leg_emulated(v, f, nsweeps, geom):
    """csrc/padded3d.cu's schedule in PyTorch: each CTA of the layout
    holds two copies of its planes (the unused tail NaN, so a read past
    the CTA's planes would show), the CTAs run in reverse order within a
    half-sweep, each reading its src copy and its neighbours' through
    `lo_off` (the lower one's last plane) and offset 0 (the upper one's
    first), writing dst; the copies swap after the barrier, and the first
    copy goes back to v."""
    lay = PD.leg_layout(geom)
    X, Y, Z = geom.shape
    C = lay.nctas
    x0 = _bounds(geom)
    copies = []
    for k in range(C):
        c0 = torch.full((lay.planes, Y, Z), float("nan"))
        c0[:x0[k + 1] - x0[k]] = v[x0[k]:x0[k + 1]]
        copies.append([c0, torch.full_like(c0, float("nan"))])
    y = torch.arange(Y)[None, :, None]
    z = torch.arange(Z)[None, None, :]
    zero = torch.zeros(()) if f is None else None
    for h in range(2 * nsweeps):
        src, dst = h & 1, (h + 1) & 1
        for k in reversed(range(C)):
            np_ = x0[k + 1] - x0[k]
            kl, kh = (k + C - 1) % C, (k + 1) % C
            lo = copies[kl][src][x0[kl + 1] - x0[kl] - 1]
            hi = copies[kh][src][0]
            pl = copies[k][src][:np_]
            ext = torch.cat([lo[None], pl, hi[None]])
            x = (x0[k] + torch.arange(np_))[:, None, None]
            ff = zero if f is None else f[x0[k]:x0[k + 1]]
            copies[k][dst][:np_] = _blend(
                pl, ext[:-2], ext[2:], torch.roll(pl, 1, 1),
                torch.roll(pl, -1, 1), torch.roll(pl, 1, 2),
                torch.roll(pl, -1, 2), ff, _mask(x, y, z, h & 1, geom),
                geom)
    return torch.cat([copies[k][0][:x0[k + 1] - x0[k]] for k in range(C)])


LEG_LEVELS = [(65,) * 3, (33,) * 3, (17,) * 3, (9,) * 3, (5,) * 3,
              (3,) * 3, (17, 9, 33), (33, 17, 5)]


@pytest.mark.parametrize("shape", LEG_LEVELS)
def test_leg_schedule_matches_plain(shape):
    """The leg's schedule, emulated CTA by CTA in reverse order
    (`_leg_emulated`), bitwise sweeps_plain at 1, 2 and 3 sweeps (the
    copies' cycle is a sweep: T = 1, so T, T + 1, T + 2) and a longer leg
    (100 sweeps on 17^3 and below, 7 above), with f and f-less; the
    layout's CTAs cover the level's planes once."""
    _, tg = (g[0] for g in _geoms(shape))
    lay = PD.leg_layout(tg)
    assert lay is not None
    x0 = _bounds(tg)
    assert x0[0] == 0 and x0[-1] == shape[0]
    assert max(b - a for a, b in zip(x0, x0[1:])) == lay.planes
    assert min(b - a for a, b in zip(x0, x0[1:])) >= 1
    prob = T.Poisson(3, domain=DOM)
    v, f = _random(shape, sum(shape))
    long = 100 if shape[0] * shape[1] * shape[2] <= 17**3 else 7
    for ns in (1, 2, 3, long):
        for ff in (f, None):
            if ff is None and ns not in (3, long):
                continue
            assert torch.equal(_leg_emulated(v, ff, ns, tg),
                               PD.sweeps_plain(v, ff, ns, prob, tg)), (ns,)


def _half_sweep_emulated(v, f, colour, geom, threads=256):
    """csrc/slab3d.cu's launch in PyTorch: the blocks of `threads` points
    of each x plane's flat (y, z) index in reverse order, each point from
    its neighbours at the kernel's wrapped indices (the plane before and
    after, flat index -+ Z and -+ 1 within the row) and f, into a new
    array (NaN where no block writes)."""
    X, Y, Z = geom.shape
    YZ = Y * Z
    vf = v.reshape(X, YZ)
    ff = torch.zeros_like(vf) if f is None else f.reshape(X, YZ)
    out = torch.full_like(vf, float("nan"))
    for x in reversed(range(X)):
        for b in reversed(range(-(-YZ // threads))):
            s = torch.arange(b * threads, min(YZ, (b + 1) * threads))
            y, z = s // Z, s % Z
            pl = vf[x]
            out[x, s] = _blend(
                pl[s], vf[(x - 1) % X, s], vf[(x + 1) % X, s],
                pl[torch.where(y == 0, s + YZ - Z, s - Z)],
                pl[torch.where(y == Y - 1, s - (YZ - Z), s + Z)],
                pl[torch.where(z == 0, s + Z - 1, s - 1)],
                pl[torch.where(z == Z - 1, s - (Z - 1), s + 1)], ff[x, s],
                _mask(torch.tensor(x), y, z, colour, geom), geom)
    return out.reshape(X, Y, Z)


@pytest.mark.parametrize("shape", [(17,) * 3, (9, 17, 33), (5, 3, 7),
                                   (33, 9, 65)])
def test_sweep_launches_match_plain(shape):
    """The half-sweep kernel's blocks, emulated in reverse order
    (`_half_sweep_emulated`), red from v into the scratch and black back,
    as slab3d_relax chains them: bitwise sweeps_plain at 1, 2 and 3 sweeps
    (T = 1: T, T + 1, T + 2) with f and at 3 f-less, on planes smaller
    than a block and larger; every output point written.  The wrapper's
    launch on CPU tensors leaves its input as it was."""
    _, tg = (g[0] for g in _geoms(shape))
    prob = T.Poisson(3, domain=DOM)
    v, f = _random(shape, 7)
    for ns, ff in ((1, f), (2, f), (3, f), (3, None)):
        w = v
        for _ in range(ns):
            w = _half_sweep_emulated(w, ff, 0, tg)
            w = _half_sweep_emulated(w, ff, 1, tg)
        assert torch.equal(w, PD.sweeps_plain(v, ff, ns, prob, tg)), ns
    src, dst = v.clone(), torch.empty_like(v)
    SB.half_sweep(src, f, dst, 1, prob, tg)
    assert torch.equal(dst, PD.half_sweep_plain(v, f, 1, prob, tg))
    assert torch.equal(src, v)


# ---------------------------------------------------------------- plan

_JAX_TIER = {"make_resident_relax": "padded3d", "make_slab_relax": "slab3d"}


@pytest.mark.parametrize("n", [129, 257, 513])
def test_plan_matches_jax(n):
    """Every level of the n^3 padded hierarchy takes the kernel JAX's
    plan_relax gives it (on JAX's TPU padding), but for the deviations of
    the module docstring: 65^3 the leg (JAX: the slab), 257^3 and 513^3
    row 3's form (JAX: jnp).  The same plan with mixed (float32: no
    defect plan covers a padded level); transfers and residuals plain;
    no fused subtree; from the geometry alone."""
    jgs, tgs = _geoms((n,) * 3, None)
    assert [g.shape for g in jgs] == [g.shape for g in tgs]
    prob = T.Poisson(3, domain=DOM)
    jp = J.Poisson(3, domain=DOM)
    want = []
    for jg in jgs:
        fn = JR.plan_relax(jp, jg, F32, interpret=True)
        want.append(None if fn is None else
                    _JAX_TIER[fn.__qualname__.split(".")[0]])
    for mixed in (False, True):
        for cyc in (None, T.CycleConfig("fmg", 2, 3, 3),
                    T.CycleConfig("w", 1, 2, 2, 2)):
            k = D.CudaKernels(prob, tgs, torch.float32, mixed=mixed,
                              cycle=cyc)
            assert all(d is None for d in k._defect)
            assert all(k._plain) and not any(k._sub_v) and not any(k._sub_c)
            got = k.tiers
            assert got == ["slab3d" if g.shape[0] > 65 else "padded3d"
                           for g in tgs]
            for g, a, b in zip(tgs, got, want):
                if b is not None and g.shape[0] != 65:
                    assert a == b, (g.shape, a, b)
    by_n = {g.shape[0]: w for g, w in zip(tgs, want)}
    assert by_n.get(65) == "slab3d" and by_n.get(33) == "padded3d"
    assert by_n.get(129) == "slab3d"
    assert by_n.get(257, None) is None and by_n.get(513, None) is None


def test_leg_layouts():
    """The leg's layout on the cubic levels 65^3 ... 3^3: 16 CTAs above a
    thousand points (65^3: 5 planes x 5 slots, 33^3: 3 x 2, 17^3: 2 x 1),
    one CTA below; two copies of a CTA's planes within 227 KB, the
    threads covering a plane; none from 129^3 up (row 3's levels)
    nor on wrap levels."""
    want = {65: (16, 864, 5, 5, (5, 5)), 33: (16, 576, 3, 2, (3, 2)),
            17: (16, 320, 2, 1, (2, 1)), 9: (1, 96, 9, 1, (9, 1)),
            5: (1, 32, 5, 1, (9, 1)), 3: (1, 32, 3, 1, (3, 2))}
    for n, (ctas, threads, planes, slots, inst) in want.items():
        _, tg = (g[0] for g in _geoms((n,) * 3))
        lay = PD.leg_layout(tg)
        assert (lay.nctas, lay.threads, lay.planes, lay.slots,
                (lay.pm, lay.jm)) == (ctas, threads, planes, slots, inst)
        assert lay.smem_bytes == 8 * planes * n * n <= PD.MAX_SMEM_BYTES
        assert lay.threads * lay.slots >= n * n
        assert lay.threads * (lay.slots - 1) < n * n
    for n in (129, 257, 513):
        assert PD.leg_layout(_geoms((n,) * 3)[1][0]) is None
    wrap = TG.build_geometries((17,) * 3, ((0.0, 1.0),) * 3, wrap=True)
    assert PD.leg_layout(wrap[0]) is None


def test_refusals():
    """What the padded forms do not take raises: a wrap level, a level the
    leg does not hold, operands of another shape, a problem without the
    Poisson stencil, an output aliasing its input; float64 keeps the
    plain tier's refusal, and a padded 3D level on a mesh stays ROADMAP
    queue 1 item 17."""
    _, tg = (g[0] for g in _geoms((17,) * 3))
    prob = T.Poisson(3, domain=DOM)
    v, f = _random(tg.shape, 1)
    wrap = TG.build_geometries((17,) * 3, ((0.0, 1.0),) * 3, wrap=True)[0]
    with pytest.raises(ValueError):
        PD.padded3d_relax(torch.zeros(16, 16, 16), None, 1, prob, wrap)
    big = _geoms((129,) * 3)[1][0]
    with pytest.raises(ValueError, match="slab kernel's level"):
        PD.padded3d_relax(torch.zeros(129, 129, 129), None, 1, prob, big)
    with pytest.raises(ValueError):
        SB.slab3d_relax(v[:-1].contiguous(), None, 1, prob, tg)
    with pytest.raises(TypeError):
        SB.slab3d_relax(v, f, 1, T.Lyapunov2D(), tg)
    with pytest.raises(ValueError, match="apart"):
        SB.half_sweep(v, f, v, 0, prob, tg)
    with pytest.raises(ValueError, match="colour"):
        SB.half_sweep(v, f, torch.empty_like(v), 2, prob, tg)
    with pytest.raises(NotImplementedError):
        D.CudaKernels(prob, _geoms((17,) * 3, None)[1], torch.float64)
    from pde_multigrid_tpu_torch.parallel.mesh import make_mesh

    with pytest.raises(NotImplementedError, match="item 17"):
        T.MultigridSolver(prob, 17, T.SolverConfig(), device="cpu",
                          mesh=make_mesh(1, device="cpu"))


def test_solver_picks_the_cuda_plan(monkeypatch):
    """`--problem poisson3d --domain 1.5` on "cuda": the solver's padded
    hierarchy goes to CudaKernels (the library's build stubbed out: no
    card here), the exact coarsest level unrelaxed; `--kind w --mu 2`
    and `--scheme fas` plan on the same levels."""
    from pde_multigrid_tpu_torch.__main__ import build_problem

    monkeypatch.setattr(build, "load", lambda: None)
    prob = build_problem("poisson3d", 1.5)
    geoms = TG.build_geometries((65,) * 3, prob.domain, wrap=False)
    for cyc, relaxed in (
            (T.CycleConfig("fmg", 2, 100, 100, coarsest="exact"),
             ["padded3d"] * 4 + [None]),
            (T.CycleConfig("w", 1, 2, 2, 2), ["padded3d"] * 6),
            (T.CycleConfig("fmg", 2, 2, 2, scheme="fas"), ["padded3d"] * 6)):
        gs = geoms[:5] if cyc.coarsest == "exact" else geoms
        k = TS._pick_kernels(prob, gs, cyc, torch.float32,
                             torch.device("cuda"))
        assert isinstance(k, D.CudaKernels)
        assert k.tiers == relaxed


# ----------------------------------------------------------- the solves


def _arrays(levels):
    return [{"v": np.asarray(l.v), "f": np.asarray(l.f),
             "aux": {k: np.asarray(a) for k, a in l.aux.items()}}
            for l in levels]


SOLVES = [
    (33, dict(kind="fmg", nu0=1, nu1=2, nu2=2)),
    (17, dict(kind="w", nu0=0, nu1=2, nu2=2, mu=2)),
    (17, dict(kind="fmg", nu0=1, nu1=2, nu2=2, scheme="fas")),
]


@pytest.mark.parametrize("n,cyc", SOLVES)
def test_float64_solves_match_jax_jnp(n, cyc):
    """The plain tier in float64 against JAX jnp on the same padded
    levels (JAX's own, carried over by levels_from_numpy): FMG at 33^3, a
    W-cycle (mu = 2) and FAS at 17^3, relaxed to the coarsest of three
    levels, the step then a V-cycle: the residual history and the
    logical solution."""
    js = J.MultigridSolver(J.Poisson(3, domain=DOM), n, J.SolverConfig(
        cycle=J.CycleConfig(**cyc), backend="jnp", dtype="float64",
        num_levels=3, max_cycles=2, tol=0.0))
    ts = T.MultigridSolver(T.Poisson(3, domain=DOM), n, T.SolverConfig(
        cycle=T.CycleConfig(**cyc), dtype="float64", num_levels=3,
        max_cycles=2, tol=0.0), device="cpu")
    assert not ts.geoms[0].wrap and not js.geoms[0].wrap
    assert [g.padded_shape for g in ts.geoms] == [
        g.padded_shape for g in js.geoms]
    jl = js.fresh_levels()
    tl = levels_from_numpy(ts.geoms, _arrays(jl), dtype=torch.float64)
    jr, tr = js.solve_to_tolerance(jl), ts.solve_to_tolerance(tl)
    np.testing.assert_allclose(tr.residual_history, jr.residual_history,
                               rtol=1e-9)
    _rel(to_logical(tr.v, ts.geoms[0]),
         np.asarray(JG.to_logical(jr.v, js.geoms[0])), 1e-10)


@pytest.mark.parametrize("n,cyc", SOLVES)
def test_cuda_plan_on_cpu_matches_plain_tier_and_jax(n, cyc):
    """The same schedules in float32 through CudaKernels on CPU tensors
    (every relaxed level on padded3d_relax's plain path; the transfers,
    residuals and FAS's injection the plain ops) against the plain tier,
    bitwise, and against JAX jnp from the same levels: the solution to
    1e-5 of max|v|, the residual history to 1e-4."""
    prob = T.Poisson(3, domain=DOM)
    js = J.MultigridSolver(J.Poisson(3, domain=DOM), n, J.SolverConfig(
        cycle=J.CycleConfig(**cyc), backend="jnp", dtype="float32",
        num_levels=3, max_cycles=2, tol=0.0))
    arrays = _arrays(js.fresh_levels())
    jr = js.solve_to_tolerance()
    results = []
    for tier in ("cuda", "plain"):
        ts = T.MultigridSolver(prob, n, T.SolverConfig(
            cycle=T.CycleConfig(**cyc), num_levels=3, max_cycles=2,
            tol=0.0), device="cpu")
        if tier == "cuda":
            kern = D.CudaKernels(prob, ts.geoms, torch.float32,
                                 cycle=ts.config.cycle)
            assert kern.tiers == ["padded3d"] * 3
            ts.program = CycleProgram(prob, ts.geoms, ts.config.cycle, kern)
        else:
            assert isinstance(ts.program.kernels, TorchKernels)
        results.append(ts.solve_to_tolerance(
            levels_from_numpy(ts.geoms, arrays)))
    a, b = results
    assert torch.equal(a.v, b.v)
    assert a.residual_history == b.residual_history
    _rel(to_logical(a.v, ts.geoms[0]),
         np.asarray(JG.to_logical(jr.v, js.geoms[0])), 1e-5)
    np.testing.assert_allclose(a.residual_history, jr.residual_history,
                               rtol=1e-4)


def test_cli_padded_3d_on_cpu():
    """`--device cpu --problem poisson3d --n 17 --domain 1.5`: the padded
    hierarchy, converged under 50 h^2 (h = 1.5 / 16)."""
    import io
    import json
    from contextlib import redirect_stdout

    from pde_multigrid_tpu_torch.__main__ import main as cli_main

    buf = io.StringIO()
    with redirect_stdout(buf):
        cli_main(["--device", "cpu", "--problem", "poisson3d", "--n", "17",
                  "--domain", "1.5", "--nu1", "4", "--nu2", "4"])
    out = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert not out["diverged"]
    assert out["error_linf"] < 50 * (1.5 / 16) ** 2
