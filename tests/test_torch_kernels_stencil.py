"""Port parity of the stencil-operator kernel module's plain version (what
`ops/cuda/stencilop.py`'s wrappers run for CPU tensors) against the JAX
package: the interpreted Pallas resident kernel
(`make_stencil_relax_resident`) and the jnp Galerkin tier
(`GalerkinKernels(pallas="off")`), on the Galerkin hierarchies' own
coefficients (1D, 2D and 3D, constant and per-point).  Then the kernels'
level description, the per-level plan of the varcoef2d 1025^2 row, and the
wrappers' refusals.

The kernels themselves build and run only on a GPU; `chip_smoke.py` holds
each one against this plain version there, bit for bit.  Here the
wrappers must take the plain path for CPU tensors and count no launch.

Tolerance against JAX, float32: at most 8 ulp of the largest value
(measured: up to 4 over 7 sweeps).  Both sides evaluate the same
per-point operations in the same order (the subtraction chain in offset
order, one division, the masked blend); XLA's CPU backend contracts the
products with the following subtractions into fused multiply-adds, inside
the Pallas interpreter and in the jnp tier alike, and nothing else
differs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pde_multigrid_tpu as J
from pde_multigrid_tpu.ops import galerkin as JGal
from pde_multigrid_tpu.ops.pallas import stencilop as JSO
import pde_multigrid_tpu_torch as T
from pde_multigrid_tpu_torch import grid as TG
from pde_multigrid_tpu_torch.cycles import CycleProgram
from pde_multigrid_tpu_torch.ops.cuda import stencilop as SO
from pde_multigrid_tpu_torch.ops.galerkin import (
    GalerkinKernels as TGalerkinKernels,
)
from pde_multigrid_tpu_torch.utils.convert import levels_from_numpy

ULPS = 8
GAL = dict(coarse_operator="galerkin")
# the 7-point Laplacian's offsets (Poisson.stencil_operator)
P3_OFFSETS = ((0, 0, 0), (-1, 0, 0), (1, 0, 0), (0, -1, 0), (0, 1, 0),
              (0, 0, -1), (0, 0, 1))


@pytest.fixture(autouse=True)
def _no_launches():
    """CPU tensors never launch a kernel: every counter stays at zero."""
    SO.reset_launches()
    yield
    assert not any(SO.launches.values())


def _hierarchies(jprob, tprob, n):
    """The JAX jnp-backend Galerkin solver and the port's CPU solver of
    one problem, two levels deep (the finest operator and one Galerkin
    level; each JAX level costs seconds of op compilation), and the JAX
    fresh levels (with each level's Galerkin coefficients) as the port's
    float32 levels."""
    cyc = dict(kind="v", nu0=0, nu1=2, nu2=2, **GAL)
    js = J.MultigridSolver(jprob, n, J.SolverConfig(
        cycle=J.CycleConfig(**cyc), backend="jnp", num_levels=2))
    ts = T.MultigridSolver(tprob, n, T.SolverConfig(cycle=T.CycleConfig(
        **cyc), num_levels=2), device="cpu")
    assert [g.padded_shape for g in ts.geoms] == [
        g.padded_shape for g in js.geoms]
    arrays = [{"v": np.asarray(l.v), "f": np.asarray(l.f),
               "aux": {k: np.asarray(a) for k, a in l.aux.items()}}
              for l in js.fresh_levels()]
    return js, ts, levels_from_numpy(ts.geoms, arrays)


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def _close(got, want):
    want = np.asarray(want)
    ulp = np.spacing(np.float32(np.abs(want).max()))
    err = np.abs(np.asarray(got) - want).max()
    print(f"max diff {err / ulp:.1f} ulp")
    np.testing.assert_allclose(got, want, rtol=0, atol=ULPS * ulp)


CASES = [
    ("varcoef2d", lambda m: m.VariableCoefficientPoisson(2), 33, (0, 1)),
    ("poisson3d", lambda m: m.Poisson(3), 9, (0, 1)),
    ("varcoef1d", lambda m: m.VariableCoefficientPoisson(1), 33, (0, 1)),
]


@pytest.mark.parametrize("name,make,n,ls", CASES, ids=[c[0] for c in CASES])
def test_plain_matches_pallas_resident_and_jnp_tier(name, make, n, ls):
    """The resident and slab wrappers' plain version on CPU tensors against
    the jnp Galerkin tier on the finest operator (K = 2d + 1, per point or
    constant) and the first Galerkin level (K = 3^d), 1 and 7 sweeps, and
    against the interpreted Pallas resident kernel on the Galerkin level,
    3 sweeps; float32."""
    js, ts, tl = _hierarchies(make(J), make(T), n)
    jlv = js.fresh_levels()
    offsets = js.program.kernels.offsets
    ref = JGal.GalerkinKernels(js.problem, js.geoms, offsets, pallas="off")
    for l in ls:
        g, jg, aux = ts.geoms[l], js.geoms[l], jlv[l].aux
        offs = ts.program.kernels.offsets[l]
        assert offs == offsets[l]
        v, f = _inputs(g.padded_shape, seed=n + l)
        c = tl[l].aux["stencil_coeffs"]
        for ns in (1, 3, 7):
            got = SO.stencil_resident(torch.tensor(v), torch.tensor(f), c,
                                      offs, g, ns).numpy()
            if g.ndim == 2:
                slab = SO.stencil_slab2d(torch.tensor(v), torch.tensor(f), c,
                                         offs, g, ns)
                assert np.array_equal(slab.numpy(), got)
            if ns == 3:
                if l != ls[-1]:
                    continue
                fn = JSO.make_stencil_relax_resident(
                    offsets[l], jg, jnp.float32, interpret=True)
                _close(got, fn(jnp.asarray(v), jnp.asarray(f),
                               aux["stencil_coeffs"], aux["m_red"],
                               aux["m_black"], ns))
                continue
            _close(got, ref.relax(l, jnp.asarray(v), jnp.asarray(f), aux, ns))


def test_slab_and_resident_plain_versions():
    """Both wrappers run the same plain version on CPU tensors: the slab's
    returns a new tensor and leaves v as it was, the resident's updates v
    in place; 0 sweeps leave v; the Galerkin tier's plain relax is the
    same function."""
    _, ts, tl = _hierarchies(J.VariableCoefficientPoisson(2),
                             T.VariableCoefficientPoisson(2), 17)
    g, offs = ts.geoms[1], ts.program.kernels.offsets[1]
    c = tl[1].aux["stencil_coeffs"]
    v, f = (torch.tensor(a) for a in _inputs(g.padded_shape, seed=3))
    v0 = v.clone()
    a = SO.stencil_slab2d(v, f, c, offs, g, 5)
    assert torch.equal(v, v0) and a is not v
    assert SO.stencil_slab2d(v, f, c, offs, g, 0) is v
    b = SO.stencil_resident(v, f, c, offs, g, 5)
    assert b is v and torch.equal(a, b)
    plain = ts.program.kernels.relax(1, v0.clone(), f, tl[1].aux, 5)
    assert torch.equal(plain, a)


def test_params_describe_the_level():
    """The kernels' view and interior of a level: 2D as (X, 1, Y), 1D as
    (1, 1, N), wrap storage's interior from index 1 to the last stored
    one, padded storage's the logical ring; offsets on the view's axes,
    the other-colour bit of each, the coefficient stride (0 when
    constant)."""
    offs2 = JGal.neighborhood_offsets(2)
    gw = TG.build_geometries((33, 33), ((0.0, 1.0),) * 2, 1, wrap=True)[0]
    p = SO.params(offs2, gw, False)
    assert (p.X, p.Y, p.Z) == (32, 1, 32) and p.wrap == 1
    assert list(p.lo) == [1, 0, 1] and list(p.hi) == [31, 0, 31]
    assert p.K == 9 and p.center == 4 and p.cstride == 9
    assert [p.off[3 * k:3 * k + 3] for k in range(9)] == [
        [a, 0, b] for a, b in offs2]
    assert p.odd == sum(1 << k for k, (a, b) in enumerate(offs2)
                        if (a + b) % 2)
    gp = TG.build_geometries((17,), ((0.0, 1.0),), 1)[0]
    p = SO.params(((0,), (-1,), (1,)), gp, True)
    assert (p.X, p.Y, p.Z) == (1, 1, 17) and p.wrap == 0
    assert list(p.lo) == [0, 0, 1] and list(p.hi) == [0, 0, 15]
    assert p.cstride == 0 and p.odd == 0b110
    g3 = TG.build_geometries((9,) * 3, ((0.0, 1.0),) * 3, 1)[0]
    p = SO.params(JGal.neighborhood_offsets(3), g3, False)
    assert (p.X, p.Y, p.Z) == (9, 9, 9) and list(p.hi) == [7, 7, 7]
    assert p.K == 27 and p.center == 13
    with pytest.raises(ValueError):
        SO.params(((0, 0), (2, 0)), gw, False)


def _row_levels():
    """The varcoef2d 1025^2 hierarchy in wrap storage and each level's
    offsets: the 5-point finest operator, then the 9-point Galerkin ones."""
    prob = T.VariableCoefficientPoisson(2)
    geoms = TG.build_geometries((1025, 1025), prob.domain, wrap=True)
    offs = [prob._offsets()] + [JGal.neighborhood_offsets(2)] * 9
    return geoms, offs


def test_plan_of_the_varcoef2d_row():
    """varcoef2d at 1025^2 in wrap storage, Galerkin: the slab kernel on
    1024^2 (K = 5, T = 3, 32 x 64 tiles), 512^2 (K = 9, T = 4, 32 x 32)
    and 256^2 (16 x 32: 32 x 32 tiles would leave SMs idle), which no leg
    holds; the resident kernel's leg below, its coefficients in registers:
    128^2 on 16 CTAs of 448 threads (two
    points of each colour a thread) and 64^2 on 16 of 320 (one), both with
    4 halo rows a side refreshed every 2 sweeps, 32^2-2^2 on one CTA of
    512, 128 and 32 threads; per FMG(2, 40, 40) step 256 slab
    launches (4 legs of 14, 8 and 12 of 10) and 196 resident legs.  3D
    and 1D levels beyond the resident kernel raise, naming their ROADMAP
    item; a 3D level the leg does not hold takes the general form,
    coefficients staged or not, as does a 1D level of 4096 slots a
    colour."""
    geoms, offs = _row_levels()
    plans = [SO.plan_stencil_relax(o, g) for o, g in zip(offs, geoms)]
    assert [p.kernel for p in plans] == (
        ["stencil_slab2d"] * 3 + ["stencil_resident"] * 7)
    assert [p.form for p in plans[:3]] == [SO.SlabForm(3, 32, 64),
                                           SO.SlabForm(4, 32, 32),
                                           SO.SlabForm(4, 16, 32)]
    assert [tuple(p.layout) for p in plans[3:]] == [
        (16, 448, 2, 2), (16, 320, 1, 2), (1, 512, 1, 0), (1, 128, 1, 0)] + [
        (1, 32, 1, 0)] * 3
    assert [p.ctas for p in plans] == [None] * 3 + [16, 16] + [1] * 5
    # the general form would hold 256^2 only without its coefficients
    assert SO.resident_ctas(geoms[2]) == 8
    assert not SO.resident_staged(geoms[2], 8, 9, False)
    # 128^2 on 16 CTAs: 8 rows and two ghost rows of 129 points, twice (a
    # barrier every half-sweep); 64^2: 4 rows and 4 halo rows a side as
    # two colours' halves of 33, twice, and two inboxes of both sides' rows
    assert SO.leg_smem_bytes(geoms[3], 16) == 8 * 10 * 129
    assert SO.leg_smem_bytes(geoms[4], 16, 2) == 4 * (
        4 * 12 + 32) * 33
    assert SO.slab_smem_bytes(9, False) == 4 * (2 * 49 * 49 * 11 + 49 * 49)
    assert SO.slab_smem_bytes(5, False) == 4 * (2 * 45 * 77 * 7 + 45 * 77)
    assert SO.slab_smem_bytes(5, False, double=False) == 4 * 45 * 77 * 8
    legs = [2 * 2 * (l + 1) for l in range(len(geoms))]
    launches = {}
    for n, p in zip(legs, plans):
        launches[p.kernel] = launches.get(p.kernel, 0) + n * p.launches(40)
    assert launches == {"stencil_slab2d": 256, "stencil_resident": 196}
    assert plans[0].launches(7) == 3 and plans[1].launches(7) == 2
    assert plans[3].launches(0) == 0
    g3 = TG.build_geometries((65,) * 3, ((0.0, 1.0),) * 3, 2, wrap=True)
    with pytest.raises(NotImplementedError, match="queue 2 item 36"):
        SO.plan_stencil_relax(JGal.neighborhood_offsets(3), g3[0])
    p3 = SO.plan_stencil_relax(JGal.neighborhood_offsets(3), g3[1])
    assert p3.kernel == "stencil_resident" and p3.ctas == 8
    assert p3.layout is None
    assert not SO.resident_staged(g3[1], 8, 27, False)
    p7 = SO.plan_stencil_relax(P3_OFFSETS, g3[1])
    assert p7.layout == SO.LegLayout(16, 512, 2, 0)
    g1 = TG.build_geometries((32769,), ((0.0, 1.0),), 1, wrap=True)[0]
    with pytest.raises(NotImplementedError, match="queue 2 item 36"):
        SO.plan_stencil_relax(((0,), (-1,), (1,)), g1)
    g1 = TG.build_geometries((8193,), ((0.0, 1.0),), 1, wrap=True)[0]
    p1 = SO.plan_stencil_relax(((0,), (-1,), (1,)), g1)
    assert p1.layout is None and p1.ctas == 1


def _leg_levels():
    """(name, geometry, K) of every level the leg serves on the varcoef2d
    row, and 1D, 3D and odd 2D levels the resident kernel serves."""
    geoms, offs = _row_levels()
    out = [(f"row{g.padded_shape[0]}", g, len(o))
           for g, o in zip(geoms, offs) if SO.leg_layout(g, len(o))]
    for shape, wrap, K in (((1025,), True, 3), ((2049,), True, 3),
                           ((513,), False, 2), ((65, 65), False, 9),
                           ((33, 33), False, 5), ((33,) * 3, True, 7),
                           ((17,) * 3, True, 27), ((9,) * 3, True, 27),
                           ((17,) * 3, False, 7), ((9,) * 3, False, 27)):
        dom = ((0.0, 1.0),) * len(shape)
        g = TG.build_geometries(shape, dom, 1, wrap=wrap)[0]
        out.append((f"{'x'.join(map(str, shape))}{'w' if wrap else ''}"
                    f"K{K}", g, K))
    return out


LEG_LEVELS = _leg_levels()


@pytest.mark.parametrize("name,g,K", LEG_LEVELS,
                         ids=[c[0] for c in LEG_LEVELS])
def test_leg_points_cover_each_owned_point_once(name, g, K):
    """Every form of the leg that holds the level (the plan's among them)
    updates each interior point of each colour exactly once, from the CTA
    that owns its row; its threads cover the slots in whole warps within
    the form's register budget, and a CTA's v (and its inboxes) stays
    within 227 KB."""
    aux = TG.base_aux(g, torch.float32, "cpu")
    want = [np.flatnonzero(aux[m].numpy().ravel()) for m in
            ("m_red", "m_black")]
    forms = SO.leg_layouts(g, K)
    assert SO.leg_layout(g, K) in forms
    X = g.padded_shape[0] if g.ndim > 1 else 1
    plane = int(np.prod(g.padded_shape)) // X
    for lay in forms:
        assert lay.threads % 32 == 0
        assert lay.threads <= SO.leg_max_threads(K, lay.P)
        assert lay.threads * lay.P >= SO.leg_slots(g, lay.ctas, lay.te)
        assert SO.leg_smem_bytes(g, lay.ctas, lay.te) <= SO.MAX_SMEM_BYTES
        pts = SO.leg_points(g, lay)
        assert len(pts) == lay.ctas
        rows = SO.leg_rows(g, lay.ctas)
        for c in (0, 1):
            got = np.concatenate([p[c][0][p[c][1]] for p in pts])
            assert len(np.unique(got)) == len(got), (lay, c)
            assert np.array_equal(np.sort(got), want[c]), (lay, c)
            for r, (flat, own) in enumerate(p[c] for p in pts):
                assert len(np.unique(flat)) == len(flat), (lay, c, r)
                x = flat // plane
                end = min((r + 1) * rows, X)
                assert ((x[own] >= r * rows) & (x[own] < end)).all()
                # halo rows: at most 2 te - 1 rows past the CTA's own
                d = np.minimum((r * rows - x) % X, (x - end + 1) % X)
                assert (d[~own] < max(2 * lay.te, 1)).all(), (lay, c, r)
                assert lay.te or own.all()


def test_leg_capacity_and_refusals():
    """256^2 at K = 9 on 16 CTAs of 16 rows: v fits (37 KB a CTA), but a
    colour's 2048 slots a CTA outrun 512 threads of two points each with
    their coefficients in registers, so no leg holds the level (nor on 8
    CTAs) and the plan leaves it to the slab.  512^2 fits no leg.  The
    leg refuses K = 27 on more than one point a thread, clusters on a 1D
    level or with a CTA owning no row, halo rows a CTA does not own or
    longer than the level, an odd te, P other than 1 or 2, and levels
    whose v exceeds a CTA."""
    geoms, offs = _row_levels()
    g256, g512 = geoms[2], geoms[1]
    assert SO.leg_smem_bytes(g256, 16) == 8 * 18 * 257
    assert SO.leg_smem_bytes(g256, 16) <= SO.MAX_SMEM_BYTES
    assert SO.leg_slots(g256, 16) == 16 * 128 > 2 * SO.leg_max_threads(9, 2)
    assert SO.leg_layouts(g256, 9) == [] and SO.leg_layout(g256, 9) is None
    assert SO.plan_stencil_relax(offs[2], g256).kernel == "stencil_slab2d"
    assert all(SO.leg_fits(g256, 9, c, P, te) is None
               for c in (8, 16) for P in (1, 2) for te in (0, 2))
    assert SO.leg_layout(g512, 9) is None and SO.leg_layout(geoms[0], 5) is (
        None)
    g3 = TG.build_geometries((17,) * 3, ((0.0, 1.0),) * 3, 1, wrap=True)[0]
    assert SO.leg_fits(g3, 27, 8, 1) == 256
    assert SO.leg_fits(g3, 27, 8, 2) is None
    g1 = TG.build_geometries((1025,), ((0.0, 1.0),), 1, wrap=True)[0]
    assert SO.leg_fits(g1, 3, 8, 1) is None
    assert SO.leg_fits(g1, 3, 1, 1, te=2) is None  # halo rows: a cluster
    assert SO.leg_fits(geoms[7], 9, 16, 1) is None  # 4^2: 16 CTAs, 4 rows
    assert SO.leg_fits(geoms[7], 9, 1, 3) is None  # P must be 1 or 2
    assert SO.leg_fits(geoms[4], 9, 16, 1, te=3) is None  # odd te
    assert SO.leg_fits(geoms[4], 9, 16, 1, te=4) is None  # 4 rows < 8
    assert SO.leg_fits(geoms[6], 9, 2, 1, te=2) is None  # 8 + 8 > 16 rows
    g4k = TG.build_geometries((4097,), ((0.0, 1.0),), 1, wrap=True)[0]
    assert SO.leg_layout(g4k, 3) is None  # 2048 slots of a colour
    g33 = TG.build_geometries((33,) * 3, ((0.0, 1.0),) * 3, 1)[0]
    assert SO.leg_layout(g33, 7) is None  # 3 rows a CTA: 1683 slots
    for g, offs_ in ((g4k, ((0,), (-1,), (1,))), (g33, P3_OFFSETS)):
        p = SO.plan_stencil_relax(offs_, g)
        assert p.kernel == "stencil_resident" and p.layout is None
    big = TG.build_geometries((257,) * 3, ((0.0, 1.0),) * 3, 1, wrap=True)[0]
    assert SO.leg_layout(big, 7) is None  # v exceeds a CTA on 16


SLAB_LEVELS = [(f"row{g.padded_shape[0]}K{len(o)}", g, len(o))
               for g, o in list(zip(*_row_levels()))[:4]] + [
    (f"{n}x{n}{'w' if w else ''}K{K}",
     TG.build_geometries((n, n), ((0.0, 1.0),) * 2, 1, wrap=w)[0], K)
    for n, w, K in ((65, False, 9), (129, False, 5), (97, True, 3),
                    (3, True, 9))]


@pytest.mark.parametrize("name,g,K", SLAB_LEVELS,
                         ids=[c[0] for c in SLAB_LEVELS])
def test_slab_walk_covers_every_tile_once(name, g, K):
    """The slab's persistent walk, in its K's form and in the level's
    (`slab_form`, its tiles' rows halved where they would leave SMs idle):
    one CTA an SM (of 132) takes every tile
    exactly once; the tiles' owned boxes cover the level once; each
    tile's slots update every point of its loaded region that is interior
    and off its rim once per colour (so every owned interior point), and
    its two buffers and the second copy of v fit 227 KB."""
    X, Y = g.padded_shape
    aux = TG.base_aux(g, torch.float32, "cpu")
    interior = aux["m_int"].numpy().astype(bool)
    forms = {SO.SLAB_FORMS[K], SO.slab_form(g, K)}
    for form in sorted(forms):
        assert SO.slab_fits(K, form)
        walk = SO.slab_walk(g, form)
        ntx, nty = SO.slab_tiles(g, form)
        tiles = sorted(t for w in walk for t in w)
        assert tiles == list(range(ntx * nty))
        assert len(walk) == min(ntx * nty, SO.H100_SMS)
        owned = np.zeros((X, Y), int)
        for t in tiles:
            ((gx0, gx1), (gy0, gy1)), ((ox, LX), (oy, LY)) = SO.slab_box(
                g, form, t)
            owned[gx0:gx1, gy0:gy1] += 1
            RX, S = SO.slab_region(form)
            assert LX <= RX and LY <= S
            # the updatable points: loaded, off the rim, interior
            xs = np.arange(ox + 1, min(ox + LX - 1, X))
            ys = np.arange(oy + 1, min(oy + LY - 1, Y))
            xx, yy = np.meshgrid(xs, ys, indexing="ij")
            h = 2 * form.T
            # the owned points lie 2T inside the loaded region (or at the
            # level's edge)
            assert gx0 - ox >= min(h, gx0) and gy0 - oy >= min(h, gy0)
            for c, pts in enumerate(SO.slab_points(g, form, t)):
                assert len(np.unique(pts)) == len(pts)
                on = interior[xx, yy] & ((xx + yy) % 2 == c)
                assert np.array_equal(np.sort(pts), (xx * Y + yy)[on])
        assert (owned == 1).all()
        assert SO.slab_smem_bytes(K, False, form) <= SO.MAX_SMEM_BYTES


def test_slab_refuses_forms_it_does_not_take():
    """The kernel does not take a form whose buffers exceed 227 KB (K = 9,
    T = 4 on 32 x 64 tiles) or whose tile rows outrun the threads' slots;
    every K's form, and its form on every level of the row, fits; a K the
    slab is not built for raises before any launch, on any device."""
    geoms, offs = _row_levels()
    for form in (SO.SlabForm(4, 32, 64), SO.SlabForm(1, 120, 120)):
        assert not SO.slab_fits(9, form)
    assert all(SO.slab_fits(K, form) for K, form in SO.SLAB_FORMS.items())
    assert all(SO.slab_fits(len(o), SO.slab_form(g, len(o)))
               for g, o in zip(geoms, offs))
    g = geoms[5]
    v = torch.zeros(g.padded_shape)
    offs7 = offs[5][:7]
    with pytest.raises(ValueError, match="built for K"):
        SO.stencil_slab2d(v, v, torch.zeros(*g.padded_shape, 7), offs7, g, 1)


def test_galerkin_tier_with_plans_on_cpu_is_the_plain_tier():
    """An FMG(2, 4, 4) step of varcoef2d 65^2 through the Galerkin tier
    with the card's plan (its wrappers take the plain version for CPU
    tensors) equals the plain tier's step bit for bit, and each level
    reads its own coefficients on every call."""
    s = T.MultigridSolver(T.VariableCoefficientPoisson(2), 65, T.SolverConfig(
        cycle=T.CycleConfig("fmg", 2, 4, 4, **GAL)), device="cpu")
    plain = s.solve(s.fresh_levels())
    k = s.program.kernels
    plans = [SO.plan_stencil_relax(o, g) for o, g in zip(k.offsets, s.geoms)]
    s.program = CycleProgram(
        s.problem, s.geoms, s.config.cycle,
        TGalerkinKernels(s.problem, s.geoms, k.offsets, plans=plans))
    tier = s.solve(s.fresh_levels())
    assert torch.equal(tier.v, plain.v)
    # another level's coefficients change the result: nothing is cached
    lv = s.fresh_levels()
    lv[1].aux = {**lv[1].aux,
                 "stencil_coeffs": 1.5 * lv[1].aux["stencil_coeffs"]}
    assert not torch.equal(s.solve(lv).v, plain.v)


def test_wrappers_reject_what_kernels_do_not_take():
    _, ts, tl = _hierarchies(J.VariableCoefficientPoisson(2),
                             T.VariableCoefficientPoisson(2), 17)
    g, offs = ts.geoms[1], ts.program.kernels.offsets[1]
    c = tl[1].aux["stencil_coeffs"]
    v, f = (torch.tensor(a) for a in _inputs(g.padded_shape, seed=5))
    with pytest.raises(TypeError, match="float32"):
        SO.stencil_resident(v.double(), f.double(), c.double(), offs, g, 1)
    with pytest.raises(ValueError, match="contiguous"):
        SO.stencil_resident(v.t(), f, c, offs, g, 1)
    with pytest.raises(ValueError, match="coefficients"):
        SO.stencil_resident(v, f, c[..., :5], offs, g, 1)
    with pytest.raises(ValueError):
        SO.stencil_resident(v, None, c, offs, g, 1)
    with pytest.raises(ValueError, match="no kernel for device"):
        SO.stencil_slab2d(v.to("meta"), f.to("meta"), c.to("meta"), offs, g,
                          1)
    g3 = TG.build_geometries((9,) * 3, ((0.0, 1.0),) * 3, 1)[0]
    with pytest.raises(ValueError, match="2D"):
        SO.stencil_slab2d(torch.zeros(9, 9, 9), torch.zeros(9, 9, 9),
                          torch.zeros(1, 1, 1, 7), P3_OFFSETS, g3, 1)
