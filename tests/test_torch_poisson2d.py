"""Port parity of the 2D Poisson slice on the CUDA tier's plan: the model's
split forms, the plain versions of rows 1, 3 and 16 in their Poisson forms
(what the wrappers run for CPU tensors) against the JAX package's Pallas
kernels in interpret mode, the plan of both 4097^2 hierarchies against
JAX's `plan_relax` / `plan_split2d_raw`, the kernels' layouts, plain
emulations of the kernels' schedules (the dense leg's bands, the slab's
tiles, the colour slab chunk's two-sided tiles), and whole solves against
JAX's jnp tier.

Wrap storage is 2D Poisson's default (zero boundary: [0, 1]^2); padded
storage takes a nonzero boundary ([0, 1.5]^2, sin(1.5 pi) = -1).  The
kernels build and run only on a GPU; `chip_smoke.py` (phases
kernels_poisson2d, poisson2d) holds each against its plain version there,
bit for bit.  Here the wrappers take the plain path for CPU tensors and
count no launch.

Tolerances.  The model's forms in float64: 1e-12 relative (the same
operations in the same order).  The plain versions against the
interpreted Pallas kernels in float32: 2 ulp of the largest value (XLA's
CPU backend contracts the update's products into the following sums).
The emulations against the plain versions: bitwise.  Whole float64 solves
against JAX jnp: the residual history to 1e-9 relative, the logical
solution to 1e-10 of max|v|.  The CUDA tier's plan on CPU tensors against
the plain tier in float32: bitwise in wrap storage (the same blend form),
1e-5 of max|v| in padded storage (the split tier's select form and
residual on halves round apart by an ulp)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pde_multigrid_tpu as J
from pde_multigrid_tpu import grid as JG
from pde_multigrid_tpu.ops.pallas import relax as JR
import pde_multigrid_tpu_torch as T
from pde_multigrid_tpu_torch import grid as TG
from pde_multigrid_tpu_torch.cycles import CycleProgram, TorchKernels
from pde_multigrid_tpu_torch.grid import to_logical
from pde_multigrid_tpu_torch.ops import split2d as S2
from pde_multigrid_tpu_torch.ops.cuda import dispatch as D
from pde_multigrid_tpu_torch.ops.cuda import relax2d as R2
from pde_multigrid_tpu_torch.ops.cuda import resident as RS
from pde_multigrid_tpu_torch.ops.cuda import slab2d as SL
from pde_multigrid_tpu_torch.utils.convert import levels_from_numpy
from test_torch_kernels_hjb import _check_slab_layout, _tiles

F32 = jnp.dtype("float32")
ULPS = 2
JAX_PAD = dict(pad_last_to=128, pad_sublane_to=8)
WRAP_DOM = ((0.0, 1.0),) * 2
PAD_DOM = ((0.0, 1.5),) * 2


@pytest.fixture(autouse=True)
def _no_launches():
    """CPU tensors never launch a kernel: every counter stays at zero."""
    for mod in (R2, RS, SL):
        mod.reset_launches()
    yield
    for mod in (R2, RS, SL):
        assert not any(mod.launches.values())


def _dom(wrap):
    return WRAP_DOM if wrap else PAD_DOM


def _geoms(n, wrap, levels=1):
    """(JAX geometry on the TPU padding, the port's unpadded one)."""
    jg = JG.build_geometries((n, n), _dom(wrap), levels, wrap=wrap,
                             **JAX_PAD)
    tg = TG.build_geometries((n, n), _dom(wrap), levels, wrap=wrap)
    return jg, tg


def _level(n, wrap, seed, dtype=np.float32):
    """JAX and port geometries of the finest level and (v, f) on the JAX
    padded shape: N(0, 1) on the stored region, zero in the padding; in
    wrap storage v is zero on stored row and column 0, the boundary both
    ends share (JAX's slab kernel reads a zero row past the last stored
    one where the plain roll reads stored row 0: the two agree on every
    level a solver holds)."""
    jg, tg = (g[0] for g in _geoms(n, wrap))
    rng = np.random.default_rng(seed)
    v = np.zeros(jg.padded_shape, dtype)
    f = np.zeros(jg.padded_shape, dtype)
    sx, sy = tg.padded_shape
    v[:sx, :sy] = rng.standard_normal((sx, sy))
    f[:sx, :sy] = rng.standard_normal((sx, sy))
    if wrap:
        v[0] = v[:, 0] = 0.0
    return jg, tg, v, f


def _close(got, want, ulps=ULPS):
    ulp = np.spacing(np.float32(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=ulps * ulp)


def _rel(got, want, rel):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-300))


# ------------------------------------------------------------ the model


def _nbr_np(other, q1):
    """The opposite colour's neighbour on numpy halves, as
    split2d._nbr_factory gathers it."""

    def nbr(ax, off):
        if ax == 0:
            return np.roll(other, -off, axis=0)
        if off == +1:
            return np.where(q1, np.roll(other, -1, axis=1), other)
        return np.where(q1, other, np.roll(other, 1, axis=1))

    return nbr


@pytest.mark.parametrize("wrap", [True, False])
def test_model_forms_match_jax_float64(wrap):
    """kernel_update (dense, f and f-less), split_update2d (each colour,
    f and f-less) and split_operator2d (each colour) against JAX's in
    float64 to 1e-12 relative, on a 33^2 level of either storage."""
    n = 33
    jg = JG.build_geometries((n, n), _dom(wrap), 1, wrap=wrap)[0]
    tg = TG.build_geometries((n, n), _dom(wrap), 1, wrap=wrap)[0]
    assert jg.padded_shape == tg.padded_shape
    jp, tp = J.Poisson(2, domain=_dom(wrap)), T.Poisson(2, domain=_dom(wrap))
    rng = np.random.default_rng(7 + wrap)
    shape = tg.padded_shape
    v, f = rng.standard_normal(shape), rng.standard_normal(shape)
    for fv in (f, None):
        want = jp.kernel_update(jnp.asarray(v), None if fv is None else
                                jnp.asarray(fv), {}, jg)
        got = tp.kernel_update(torch.tensor(v), None if fv is None else
                               torch.tensor(fv), {}, tg)
        _rel(got.numpy(), np.asarray(want), 1e-12)
    if wrap:
        return  # the split forms serve padded levels
    r, b = (x.numpy() for x in R2.split_colors_2d(torch.tensor(v)))
    fr, fb = (x.numpy() for x in R2.split_colors_2d(torch.tensor(f)))
    q1 = S2.q1_rows(shape[0], "cpu").numpy()
    cr, cb, _ = S2.color_coords(tg, torch.float64)
    for u, w, fu, q, coords in ((r, b, fr, q1, cr), (b, r, fb, ~q1, cb)):
        jn = _nbr_np(w, q)
        tn = S2._nbr_factory(torch.tensor(w), torch.tensor(q))
        for fv in (fu, None):
            want = jp.split_update2d(
                lambda a, o: jnp.asarray(jn(a, o)),
                None if fv is None else jnp.asarray(fv), {}, jg)
            got = tp.split_update2d(tn, None if fv is None else
                                    torch.tensor(fv), {}, tg)
            _rel(got.numpy(), np.asarray(want), 1e-12)
        want = jp.split_operator2d(jnp.asarray(u),
                                   lambda a, o: jnp.asarray(jn(a, o)),
                                   None, jg)
        got = tp.split_operator2d(torch.tensor(u), tn, coords, tg)
        _rel(got.numpy(), np.asarray(want), 1e-12)
    assert tp.split_update2d_f_optional and tp.kernel_update_f_optional
    assert getattr(tp, "split2d_x_offsets", None) is None


# ---------------------------------------------- plain versions vs Pallas


@pytest.mark.parametrize("n,wrap", [(33, True), (33, False)])
def test_resident_plain_matches_pallas(n, wrap):
    """Row 1's Poisson form (resident_relax's plain version, in place)
    against make_resident_relax interpreted, 7 sweeps with f and 1
    without: on 32^2 wrap (the logical 33^2) and 33^2 padded."""
    jg, tg, v, f = _level(n, wrap, seed=n + wrap)
    fn = JR.make_resident_relax(J.Poisson(2, domain=_dom(wrap)), jg, F32,
                                interpret=True)
    sx, sy = tg.padded_shape
    prob = T.Poisson(2, domain=_dom(wrap))
    for f_zero, ns in ((False, 7), (True, 1)):
        want = np.asarray(fn(jnp.asarray(v), jnp.asarray(f), ns,
                             f_zero=f_zero))[:sx, :sy]
        got = RS.resident_relax(
            torch.tensor(v[:sx, :sy]),
            None if f_zero else torch.tensor(f[:sx, :sy]), ns, prob, tg)
        _close(got.numpy(), want)


def test_slab_plain_matches_pallas():
    """Row 3's Poisson form (slab_relax's plain version) against
    make_slab_relax interpreted on 128^2 wrap (the logical 129^2,
    lane-aligned; B = 32 slab rows, T = 4 sweeps a call: 5 sweeps take a
    call of 4 and one of 1); slab_relax leaves v as it was."""
    ns = 5
    n = 129
    jg, tg, v, f = _level(n, True, seed=11)
    fn = JR.make_slab_relax(J.Poisson(2), jg, F32, 32, 4, interpret=True)
    vt, ft = torch.tensor(v), torch.tensor(f)
    want = np.asarray(fn(jnp.asarray(v), jnp.asarray(f), ns))
    got = SL.slab_relax(vt, ft, ns, T.Poisson(2), tg)
    assert got is not vt and torch.equal(vt, torch.tensor(v))
    _close(got.numpy(), want)


def test_colour_slab_plain_matches_pallas(monkeypatch):
    """Row 16's Poisson form (relax_halves2d: one-rank chunks of CHUNK_T
    sweeps on halves, the remainder last) against the raw
    make_split_color_slab_2d plan_split2d_raw gives 65^2 padded once its
    SPLIT2D_MIN_Y2 lets it split (tests/test_split_persist.py), halves in
    and out through JAX's converters, 5 sweeps with f (a chunk of 4 and
    the remainder; the f-less chunk is held to the plain chain in
    test_chunk_tiles_match_plain)."""
    monkeypatch.setattr(JR, "SPLIT2D_MIN_Y2", 16)
    n = 65
    jg, tg, v, f = _level(n, False, seed=13)
    raw, split_pad, merge = JR.plan_split2d_raw(
        J.Poisson(2, domain=PAD_DOM), jg, F32, interpret=True)
    prob = T.Poisson(2, domain=PAD_DOM)
    jfs = split_pad(jnp.asarray(f))
    r, b = R2.to_halves(torch.tensor(v[:n, :n]))
    fr, fb = R2.to_halves(torch.tensor(f[:n, :n]))
    for ns, with_f in ((5, True),):
        want = np.asarray(merge(*raw(*split_pad(jnp.asarray(v)),
                                     jfs if with_f else (), ns)))[:n, :n]
        out = R2.relax_halves2d(r.clone(), b.clone(),
                                *((fr, fb) if with_f else (None, None)), ns,
                                prob, tg)
        got = R2.from_halves(*out, torch.empty(n, n)).numpy()
        _close(got, want)


# ---------------------------------------------------------------- plan

_JAX_TIER = {"make_slab_relax": "_relax_slab",
             "make_resident_relax": "_relax_resident",
             "make_split_color_slab_2d": "_relax_split"}


@pytest.mark.parametrize("wrap", [True, False])
def test_plan_matches_jax_4097(wrap):
    """Every level of the 4097^2 hierarchy takes the kernel JAX runs on
    it: the persistent split tier where plan_split2d_raw plans it (JAX's
    PallasKernels.relax takes it before plan_relax's kernel: at 513^2
    padded plan_relax alone would give make_resident_relax, whose VMEM
    budget Poisson's coefficient-free update meets), else plan_relax's:
    wrap 4096^2 ... 1024^2 the slab, 512^2 ... 2^2 the dense leg, except
    512^2, which no cluster of the leg holds (the capacity gate: the slab
    takes it); padded 4097^2 ... 513^2 the split tier, 257^2 ... 3^2 the
    leg.  With mixed the levels relax in float32 (no defect plan covers
    a 2D level)."""
    jgs, tgs = _geoms(4097, wrap, None)
    prob = T.Poisson(2, domain=_dom(wrap))
    jp = J.Poisson(2, domain=_dom(wrap))
    for mixed in (False, True):
        k = D.CudaKernels(prob, tgs, torch.float32, mixed=mixed)
        assert all(d is None for d in k._defect)
        got = [fn.__name__ for fn in k._relax]
        persist = [JR.plan_split2d_raw(jp, jg, F32, interpret=True)
                   is not None for jg in jgs]
        want = ["_relax_split" if p else _JAX_TIER[
            JR.plan_relax(jp, jg, F32, interpret=True)
            .__qualname__.split(".")[0]] for p, jg in zip(persist, jgs)]
        gated = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
        assert k._split == persist
        if wrap:
            assert [g.padded_shape[0] for g in tgs] == [
                2 ** k_ for k_ in range(12, 0, -1)]
            assert want == ["_relax_slab"] * 3 + ["_relax_resident"] * 9
            assert gated == [3] and got[3] == "_relax_slab"
            assert RS.poisson_leg_layout(tgs[3]) is None
        else:
            assert want == ["_relax_split"] * 4 + ["_relax_resident"] * 8
            assert gated == [] and k._split == [True] * 4 + [False] * 8


def test_cuda_tier_refusals():
    """What the Poisson forms do not take raises: a Lyapunov problem on
    the Poisson constants, the sharded colour slab, a dense leg on a level
    no cluster holds; float64 keeps the plain tier's refusal."""
    _, tg = (g[0] for g in _geoms(17, False))
    with pytest.raises(TypeError, match="Poisson"):
        R2.poisson_params(T.Lyapunov2D(), tg)
    with pytest.raises(TypeError, match="Lyapunov2D"):
        R2.lyap_params(T.Poisson(2), tg)
    r, b = R2.split_colors_2d(torch.zeros(17, 17))
    out = (torch.empty_like(r), torch.empty_like(b))
    with pytest.raises(NotImplementedError, match="queue 1 item 17"):
        R2.color_slab2d_shard(r, b, None, None, 0, 1, T.Poisson(2), tg, 17,
                              out)
    big = TG.build_geometries((513, 513), WRAP_DOM, 1, wrap=True)[0]
    with pytest.raises(ValueError, match="slab kernel's level"):
        RS.resident_relax(torch.zeros(512, 512), torch.zeros(512, 512), 1,
                          T.Poisson(2), big)
    with pytest.raises(NotImplementedError):
        D.CudaKernels(T.Poisson(2), TG.build_geometries(
            (17, 17), WRAP_DOM, wrap=True), torch.float64)


# ------------------------------------------------------------- layouts


def _bands(lay):
    """(xo, xo_end, xs, xe) of each CTA of the dense leg on the logical
    level, as csrc/resident.cu computes them."""
    out = []
    for r in range(lay.nctas):
        xo = r * lay.B
        xo_end = min(xo + lay.B, lay.X)
        out.append((xo, xo_end, max(0, xo - lay.H),
                    min(lay.X, xo_end + lay.H)))
    return out


def _check_leg_layout(lay, X, Y):
    """The leg holds the logical X x Y level on at most 16 CTAs within a
    CTA's threads and shared memory, bands of 2T halo rows on both sides,
    and the threads' (column, segment) items update each interior point of
    each colour exactly once within the owned rows."""
    assert (lay.X, lay.Y) == (X, Y)
    assert 1 <= lay.nctas <= RS.HJB_MAX_CTAS
    assert lay.threads <= RS.HJB_MAX_THREADS
    assert lay.smem_bytes <= RS.MAX_SMEM_BYTES and lay.S % 2 == 0
    assert lay.NC >= Y - 2 and lay.L in RS.HJB_ROWS
    count = np.zeros((2, X, Y), dtype=np.int64)
    for xo, xo_end, xs, xe in _bands(lay):
        for seg in range(lay.G):
            seg0 = xs + seg * lay.L
            seg1 = min(seg0 + lay.L, xe)
            for x in range(max(seg0, xs + 1, xo), min(seg1, xe - 1, xo_end)):
                count[(x + np.arange(1, Y - 1)) % 2, x, np.arange(1, Y - 1)] \
                    += 1
    want = np.zeros((X, Y), dtype=np.int64)
    want[1:-1, 1:-1] = 1
    colour = np.add.outer(np.arange(X), np.arange(Y)) % 2
    for c in range(2):
        np.testing.assert_array_equal(count[c], want * (colour == c))


@pytest.mark.parametrize("wrap", [True, False])
def test_layouts_on_every_level(wrap):
    """The layout of every level of the 4097^2 hierarchy in the form the
    plan gives it: the dense leg's on its levels (the logical level: a
    wrap level's stored extents plus one, wrap set; 16 CTAs at 256^2 /
    257^2, 15 at 128^2 / 129^2, one below, one warp on the 3^2-logical
    level), covering every interior point once; the slab's on the wrap
    levels 4096^2 ... 512^2 (T = 4 sweeps a launch on 32 x 64 tiles,
    a leg a launch on 512^2's 16 x 8 tiles, the whole check on 512^2);
    the chunk's two-sided tiles on the split levels (owned tiles covering
    every slot once, a 2t halo on each cut side)."""
    _, tgs = _geoms(4097, wrap, None)
    k = D.CudaKernels(T.Poisson(2, domain=_dom(wrap)), tgs, torch.float32)
    w = int(wrap)
    legs, slabs = [], []
    for g, fn in zip(tgs, k._relax):
        X, Y = (n + w for n in g.padded_shape)
        if fn == k._relax_resident:
            lay = RS.poisson_leg_layout(g)
            assert lay.wrap == w
            _check_leg_layout(lay, X, Y)
            legs.append(lay.nctas)
        elif fn == k._relax_slab:
            lay = SL.slab_layout(g)
            assert (lay.X, lay.Y, lay.wrap, lay.T) == (X, Y, w, SL.SLAB_T)
            slabs.append((lay.ntx, lay.nty, lay.BX, lay.BY, lay.leg))
            if lay.leg:
                _check_slab_layout(lay)
        else:
            X, Y2 = g.padded_shape[0], S2.half_width(g)
            RX, RJ, BX, BJ, threads = R2.slab_tile(X, Y2, R2.CHUNK_T, 2)
            h = 2 * R2.CHUNK_T
            assert RX * RJ <= R2.SLAB_POINTS[threads]
            assert RX - BX == 2 * h and (RJ - BJ == 2 * h or BJ >= Y2)
            owned = np.zeros((X, Y2), dtype=np.int64)
            for x0 in range(0, X, BX):
                for j0 in range(0, Y2, BJ):
                    owned[x0:x0 + BX, j0:j0 + BJ] += 1
            np.testing.assert_array_equal(owned, 1)
    if wrap:
        assert legs == [16, 15] + [1] * 6
        assert slabs == [(128, 64, 32, 64, 0), (64, 32, 32, 64, 0),
                         (32, 16, 32, 64, 0), (16, 8, 32, 64, 1)]
    else:
        assert legs == [16, 15] + [1] * 6 and slabs == []


# ---------------------------------------------- emulated kernel schedules


def _logical(a, wrap):
    """The logical level of a stored one: wrap storage appends stored row
    and column 0 as the last row and column (the boundary both ends
    share), as the kernels load it."""
    if not wrap:
        return a
    a = torch.cat([a, a[:1]], 0)
    return torch.cat([a, a[:, :1]], 1)


def _colour_masks(X, Y, dtype):
    """(m_red, m_black) on the logical X x Y level: the interior, x + y
    even or odd."""
    x = torch.arange(X)[:, None]
    y = torch.arange(Y)[None, :]
    inner = (x >= 1) & (x <= X - 2) & (y >= 1) & (y <= Y - 2)
    par = (x + y) % 2
    return ((inner & (par == 0)).to(dtype), (inner & (par == 1)).to(dtype))


def _sweeps(prob, geom, sv, sf, mr, mb, n):
    for _ in range(n):
        sv = sv + mr * (prob.kernel_update(sv, sf, {}, geom) - sv)
        sv = sv + mb * (prob.kernel_update(sv, sf, {}, geom) - sv)
    return sv


def _band_schedule(v, f, nsweeps, prob, geom, lay):
    """The dense leg's schedule in plain PyTorch on the logical level:
    chunks of T sweeps (one chunk on one CTA); each CTA's band, its owned
    rows with its halo rows, relaxed on its own by the plain update with
    its first and last loaded rows held; after each chunk the owned rows
    form the level the next chunk's bands load from (the halo refresh).
    The last band's +x neighbour row in wrap storage is the logical level's
    last row, stored row 0, loaded as the leg starts and never written.
    Returns the stored level, a new tensor."""
    wrap = bool(lay.wrap)
    state, fl = _logical(v, wrap), _logical(f, wrap)
    m_red, m_black = _colour_masks(lay.X, lay.Y, v.dtype)
    T_ = lay.T or max(nsweeps, 1)
    done = 0
    while done < nsweeps:
        tc = min(T_, nsweeps - done)
        new = state.clone()
        for xo, xo_end, xs, xe in _bands(lay):
            keep = torch.ones((xe - xs, 1), dtype=v.dtype)
            keep[0] = keep[-1] = 0
            sv = _sweeps(prob, geom, state[xs:xe].clone(), fl[xs:xe],
                         m_red[xs:xe] * keep, m_black[xs:xe] * keep, tc)
            new[xo:xo_end] = sv[xo - xs:xo_end - xs]
        state, done = new, done + tc
    sx, sy = v.shape
    return state[:sx, :sy].contiguous()


@pytest.mark.parametrize("T_", [2, 4])
@pytest.mark.parametrize("wrap", [True, False])
def test_band_schedule_matches_plain(wrap, T_):
    """The dense leg's banded T-sweep schedule on a cluster (bands with
    their recomputed 2T halo rows both sides, refreshed every T sweeps;
    in wrap storage the last band's +x neighbour is stored row 0) equals
    resident_relax_plain bit for bit at 1, T - 1, T, T + 1 and 30 sweeps,
    on 65^2-logical levels in an 8-CTA layout and in the plan's layout of
    129^2 (15 CTAs), the boundary held."""
    prob = T.Poisson(2, domain=_dom(wrap))
    for n, forced in ((65, True), (129, False)):
        _, tg, v, f = _level(n, wrap, seed=n + 3 * T_ + wrap)
        sx, sy = tg.padded_shape
        vt, ft = torch.tensor(v[:sx, :sy]), torch.tensor(f[:sx, :sy])
        w = int(wrap)
        lay = (RS._segments(sx + w, sy + w, 8, T_, w) if forced
               else RS.poisson_leg_layout(tg))
        assert lay is not None and lay.nctas > 1 and lay.wrap == w
        for ns in sorted({1, T_ - 1, T_, T_ + 1, 30} - {0}):
            want = RS.resident_relax_plain(vt.clone(), ft, ns, prob, tg)
            got = _band_schedule(vt, ft, ns, prob, tg, lay)
            assert torch.equal(got, want), (n, T_, ns, lay.as_dict())
        edge = torch.ones_like(vt, dtype=torch.bool)
        edge[1:sx - 1 + w, 1:sy - 1 + w] = False
        assert torch.equal(want[edge], vt[edge])


def _tile_schedule(v, f, nsweeps, prob, geom, lay):
    """The slab kernel's schedule in plain PyTorch on the logical level:
    every tile loads its region (owned points and halo) from the level and
    relaxes it on its own with its edge held; every T sweeps (a leg) its
    halo is refreshed from its neighbours' owned points, which is what the
    outboxes' words carry (`_check_slab_layout` holds the words to their
    owners); at most T sweeps a launch otherwise, each launch loading from
    the level the one before wrote.  Returns the stored level."""
    wrap = bool(lay.wrap)
    state, fl = _logical(v, wrap), _logical(f, wrap)
    m_red, m_black = _colour_masks(lay.X, lay.Y, v.dtype)
    tiles = _tiles(lay)
    T_ = lay.T if (lay.leg and lay.ctas > 1) or not lay.leg else max(
        nsweeps, 1)
    regions = [state[xs:xe, ys:ye].clone()
               for _, _, _, _, xs, xe, ys, ye in tiles]
    done = 0
    while done < nsweeps:
        tc = min(T_, nsweeps - done)
        for c, (_, _, _, _, xs, xe, ys, ye) in enumerate(tiles):
            keep = torch.zeros((xe - xs, ye - ys), dtype=v.dtype)
            keep[1:-1, 1:-1] = 1
            regions[c] = _sweeps(prob, geom, regions[c], fl[xs:xe, ys:ye],
                                 m_red[xs:xe, ys:ye] * keep,
                                 m_black[xs:xe, ys:ye] * keep, tc)
        new = state.clone()
        for (xo, xo_end, yo, yo_end, xs, _, ys, _), sv in zip(tiles,
                                                              regions):
            new[xo:xo_end, yo:yo_end] = sv[xo - xs:xo_end - xs,
                                           yo - ys:yo_end - ys]
        state, done = new, done + tc
        regions = [state[xs:xe, ys:ye].clone()
                   for _, _, _, _, xs, xe, ys, ye in tiles]
    sx, sy = v.shape
    return state[:sx, :sy].contiguous()


@pytest.mark.parametrize("wrap", [True, False])
def test_tile_schedule_matches_plain(wrap):
    """The slab kernel's tile schedule (tiles with their 2T halos, a leg
    refreshing them every T sweeps, or at most T sweeps a launch) equals
    slab_relax_plain bit for bit at 1, T - 1, T, T + 1 and 30 sweeps on
    65^2-logical levels, in 8 x 16 tiles as a leg and as launches at T =
    2 and 4, the wrap level's last row and column its stored row and
    column 0; the small leg's layout passes the HJB layout check."""
    prob = T.Poisson(2, domain=_dom(wrap))
    n, w = 65, int(wrap)
    _, tg, v, f = _level(n, wrap, seed=21 + wrap)
    sx, sy = tg.padded_shape
    vt, ft = torch.tensor(v[:sx, :sy]), torch.tensor(f[:sx, :sy])
    for T_ in (2, 4):
        lays = [SL._slab_layout(sx + w, sy + w, 8, 16, T_, leg, None, w)
                for leg in (True, False)]
        assert all(lay is not None and lay.ctas > 1 and lay.wrap == w
                   for lay in lays)
        _check_slab_layout(lays[0])
        for ns in sorted({1, T_ - 1, T_, T_ + 1, 30} - {0}):
            want = SL.slab_relax_plain(vt, ft, ns, prob, tg)
            for lay in lays:
                got = _tile_schedule(vt, ft, ns, prob, tg, lay)
                assert torch.equal(got, want), (T_, ns, lay.as_dict())


def _chunk_tiles(x_loc, Y2, t, tiles, g, prob, r, b, fr, fb):
    """The colour slab chunk's Poisson form in plain PyTorch, tile by tile
    as csrc/color_slab2d_shard.cu runs it: each tile loads RX x RJ points
    of both halves from (RX - BX) / 2 rows and (RJ - BJ) / 2 slots before
    its owned origin, zeros before row 0, past the last row and outside
    the slots (and a zero guard row and column around the tile); t sweeps
    of split_update2d's value where the global point is interior (the
    select form), its neighbours read inside the tile; the owned points
    out."""
    RX, RJ, BX, BJ, _ = tiles
    HX, HJ = (RX - BX) // 2, (RJ - BJ) // 2
    ro, bo = torch.zeros_like(r), torch.zeros_like(b)
    lay = S2.rows_layout(g, 0, x_loc, r.dtype, r.device)
    q1 = lay["q1"]
    m_r, m_b = (m > 0 for m in lay["masks"])

    def take(a, x0, j0, fill=0.0):
        out = torch.full((RX + 2, RJ + 2), fill, dtype=a.dtype)
        xa, xb = max(x0, 0), min(x0 + RX, x_loc)
        ja, jb = max(j0, 0), min(j0 + RJ, Y2)
        if xa < xb and ja < jb:
            out[1 + xa - x0:1 + xb - x0, 1 + ja - j0:1 + jb - j0] = \
                a[xa:xb, ja:jb]
        return out

    for x0 in range(0, x_loc, BX):
        for j0 in range(0, Y2, BJ):
            lx0, lj0 = x0 - HX, j0 - HJ
            tr, tb = take(r, lx0, lj0), take(b, lx0, lj0)
            tfr = None if fr is None else take(fr, lx0, lj0)
            tfb = None if fb is None else take(fb, lx0, lj0)
            tq = take(q1.expand(x_loc, Y2), lx0, lj0, False).bool()
            tmr = take(m_r, lx0, lj0, False).bool()
            tmb = take(m_b, lx0, lj0, False).bool()
            for _ in range(t):
                # the guard ring reads as 0 through the rolls and is never
                # updated (no interior point there)
                upd = prob.split_update2d(S2._nbr_factory(tb, tq), tfr, {},
                                          g)
                tr = torch.where(tmr, upd, tr)
                upd = prob.split_update2d(S2._nbr_factory(tr, ~tq), tfb, {},
                                          g)
                tb = torch.where(tmb, upd, tb)
            bx, bj = min(BX, x_loc - x0), min(BJ, Y2 - j0)
            sl = (slice(1 + HX, 1 + HX + bx), slice(1 + HJ, 1 + HJ + bj))
            ro[x0:x0 + bx, j0:j0 + bj] = tr[sl]
            bo[x0:x0 + bx, j0:j0 + bj] = tb[sl]
    return ro, bo


@pytest.mark.parametrize("n", [65, 129])
def test_chunk_tiles_match_plain(n):
    """The chunk's two-sided tiles (a 2t halo on -x as well as +x and on
    both j sides; rows -1 and X and slots -1 and Y2 read as 0, which only
    boundary points and inert slots read) equal color_slab2d_shard_plain
    (the one-rank chunk) bit for bit at t = 1, 3, 4, with and without f,
    in slab_tile's tiles and in small tiles that cut the rows and the
    slots; the plain chunk is the whole-level half-sweep chain
    (half_sweep2d_plain, which serves Poisson unchanged) bit for bit."""
    prob = T.Poisson(2, domain=PAD_DOM)
    _, tg, v, f = _level(n, False, seed=n)
    r, b = R2.split_colors_2d(torch.tensor(v[:n, :n]))
    fr, fb = R2.split_colors_2d(torch.tensor(f[:n, :n]))
    Y2 = r.shape[1]
    for t in (1, 3, 4):
        h = 2 * t
        for tiles in (R2.slab_tile(n, Y2, t, 2),
                      (8 + 2 * h, 6 + 2 * h, 8, 6, 512)):
            for fs in ((fr, fb), (None, None)):
                want = R2.color_slab2d_shard_plain(r, b, *fs, 0, t, prob,
                                                   tg, n)
                cr, cb = r.clone(), b.clone()
                for _ in range(t):
                    R2.half_sweep2d_plain(cr, cb, fs[0], R2.RED, prob, tg)
                    R2.half_sweep2d_plain(cb, cr, fs[1], R2.BLACK, prob, tg)
                assert torch.equal(cr, want[0]) and torch.equal(cb, want[1])
                got = _chunk_tiles(n, Y2, t, tiles, tg, prob, r, b, *fs)
                assert torch.equal(got[0], want[0]), (n, t, tiles)
                assert torch.equal(got[1], want[1]), (n, t, tiles)


# ----------------------------------------------------------- the solves


def _pair(wrap, cyc, **cfg):
    """JAX jnp-backend and port CPU solvers of one float64 schedule at
    65^2."""
    dom = _dom(wrap)
    js = J.MultigridSolver(J.Poisson(2, domain=dom), 65, J.SolverConfig(
        cycle=J.CycleConfig(**cyc), backend="jnp", dtype="float64", **cfg))
    ts = T.MultigridSolver(T.Poisson(2, domain=dom), 65, T.SolverConfig(
        cycle=T.CycleConfig(**cyc), dtype="float64", **cfg), device="cpu")
    assert ts.geoms[0].wrap == wrap == js.geoms[0].wrap
    assert [g.padded_shape for g in ts.geoms] == [
        g.padded_shape for g in js.geoms]
    return js, ts


@pytest.mark.parametrize("wrap,cyc,cfg", [
    (True, dict(kind="fmg", nu0=1, nu1=2, nu2=2), {}),
    (True, dict(kind="fmg", nu0=1, nu1=2, nu2=2, coarsest="exact"),
     dict(max_cycles=1, num_levels=None)),
    (True, dict(kind="w", nu0=0, nu1=2, nu2=2, mu=2), {}),
    (False, dict(kind="fmg", nu0=1, nu1=2, nu2=2), {}),
    (False, dict(kind="w", nu0=0, nu1=2, nu2=2, mu=2), {}),
])
def test_solves_match_jax_jnp(wrap, cyc, cfg):
    """FMG, V and W (mu = 2) solves at 65^2 in both storages, and FMG with
    the exact coarsest level (fast diagonalization on the wrap hierarchy),
    in float64 on three levels (65^2 ... 17^2 relaxed: JAX's compile time
    grows with the depth, and W-cycles unroll; the exact case on its own
    depth, 65^2 and the 33^2 solve): the FMG step then a V-cycle, or two
    W-cycles, from JAX's own initial levels carried into the port
    (levels_from_numpy: the unpadded shapes of either storage, the port's
    masks bit for bit, and back by levels_to_numpy unchanged); the
    residual history and the logical solution against JAX jnp.  The fast
    diagonalization's contractions are float32 in both packages (XLA's
    dot and torch's einsum sum in other orders), so the exact case holds
    the history to 1e-4 and the solution to 1e-5 of max|v|
    (tests/test_torch_solver.py's bounds; a second cycle's residual, 4e-8,
    would sit at that float32 floor)."""
    from pde_multigrid_tpu_torch.utils.convert import levels_to_numpy

    js, ts = _pair(wrap, cyc, tol=0.0, **{"max_cycles": 2, "num_levels": 3,
                                         **cfg})
    arrays = [{"v": np.asarray(l.v), "f": np.asarray(l.f),
               "aux": {k: np.asarray(a) for k, a in l.aux.items()}}
              for l in js.fresh_levels()]
    levels = levels_from_numpy(ts.geoms, arrays, dtype=torch.float64)
    for x, y, own in zip(levels_to_numpy(levels), arrays,
                         ts.fresh_levels()):
        for k in ("v", "f"):
            np.testing.assert_array_equal(x[k], y[k])
        for k in ("m_int", "m_log"):
            np.testing.assert_array_equal(own.aux[k].numpy(), x["aux"][k])
    jr, tr = js.solve_to_tolerance(), ts.solve_to_tolerance(levels)
    exact = cyc.get("coarsest") == "exact"
    np.testing.assert_allclose(tr.residual_history, jr.residual_history,
                               rtol=1e-4 if exact else 1e-9)
    _rel(to_logical(tr.v, ts.geoms[0]),
         np.asarray(JG.to_logical(jr.v, js.geoms[0])),
         1e-5 if exact else 1e-10)


@pytest.mark.parametrize("kind,mu", [("fmg", 1), ("w", 2)])
@pytest.mark.parametrize("wrap", [True, False])
def test_cuda_plan_on_cpu_matches_plain_tier(monkeypatch, wrap, kind, mu):
    """An FMG step and a W-cycle (mu = 2) through the CUDA tier's plan on
    CPU tensors (its wrappers run the plain versions; with SPLIT2D_MIN_Y2
    lowered the padded 65^2 and 33^2 levels take the persistent halves,
    whose visits a W-cycle orders as no V-cycle does) against the plain
    tier in float32: wrap bitwise, padded within 1e-5 of max|v|; the
    halves' conversions within their per-visit budget."""
    monkeypatch.setattr(D, "SPLIT2D_MIN_Y2", 16)
    prob = T.Poisson(2, domain=_dom(wrap))
    geoms = TG.build_geometries((65, 65), prob.domain, wrap=wrap)
    cyc = T.CycleConfig(kind, 2, 3, 3, mu)
    state = [prob.init_level(g) for g in geoms]
    arrays = [{"v": s.v.numpy(), "f": s.f.numpy(),
               "aux": {k: a.numpy() for k, a in s.aux.items()}}
              for s in state]
    kern = D.CudaKernels(prob, geoms, torch.float32, cycle=cyc)
    assert kern._split == ([False] * 6 if wrap else [True] * 2 + [False] * 4)
    tier = CycleProgram(prob, geoms, cyc, kern)
    plain = CycleProgram(prob, geoms, cyc, TorchKernels(prob, geoms))
    a = plain.solve_step(levels_from_numpy(geoms, arrays))
    b = tier.solve_step(levels_from_numpy(geoms, arrays))
    if wrap:
        assert torch.equal(b[0].v, a[0].v)
    else:
        _rel(b[0].v.numpy(), a[0].v.numpy(), 1e-5)
        conv = kern.conversions
        assert conv["split_v"] >= 1 and conv["split_f"] >= 1
        assert conv["merge"] >= 1
