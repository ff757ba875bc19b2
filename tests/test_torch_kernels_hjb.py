"""Port parity of the HJB kernel modules' plain versions (what the wrappers
run for CPU tensors) against the JAX package's Pallas kernels in interpret
mode, on the padded TPU geometry tests/test_hjb.py builds them on (33^2,
pad_last_to=128, pad_sublane_to=8), compared on the logical arrays: the
port pads nothing.  Then the keep mask over the 513^2 hierarchy and the
CUDA tier's HJB plan.

The kernels themselves build and run only on a GPU; `chip_smoke.py` holds
each one against its plain version there, bit for bit, with the pinned
points unchanged.  Here the wrappers must take the plain path for CPU
tensors, count no launch, and reject what the kernels do not take.

Tolerance for the sweeps: at most 4 ulp of the largest value (measured:
at most 2 for the slab form, 3 for the resident form at 65^2 over 7
sweeps).  Both sides
evaluate the same per-point operations in the same order; XLA's CPU
backend, which runs the interpreted Pallas kernels, contracts the update's
products with the following sums into fused multiply-adds (c1 * nb1 + f,
c2 * m2 + base), and nothing else differs.  The pinned ball and the
boundary ring are compared bit for bit: no side writes them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pde_multigrid_tpu import HJBMinTime as JHJB
from pde_multigrid_tpu.grid import Hierarchy as JHierarchy
from pde_multigrid_tpu.ops.pallas import relax as JR
from pde_multigrid_tpu_torch import HJBMinTime, Lyapunov2D
from pde_multigrid_tpu_torch import grid as TG
from pde_multigrid_tpu_torch.ops.cuda import resident as RS
from pde_multigrid_tpu_torch.ops.cuda import slab2d as SL
from pde_multigrid_tpu_torch.ops.cuda.dispatch import CudaKernels

F32 = jnp.dtype("float32")
ULPS = 4
DOM = ((-1.0, 1.0), (-1.0, 1.0))


@pytest.fixture(autouse=True)
def _no_launches():
    """CPU tensors never launch a kernel: every counter stays at zero."""
    SL.reset_launches()
    RS.reset_launches()
    yield
    assert not any(SL.launches.values()) and not any(RS.launches.values())


def _level(n, seed):
    """The JAX padded geometry and level, the port's unpadded geometry,
    float32 (v, f) on the padded shape as tests/test_hjb.py makes them
    (v: the initial level plus 0.01 N(0, 1) on the interior; f: 1 + 0.1
    N(0, 1)), and the logical mask of the points no sweep may write (the
    ring and the pinned ball)."""
    h = JHierarchy.build(JHJB(), n, pad_last_to=128, pad_sublane_to=8)
    lvl, jg = h.levels[0], h.geoms[0]
    tg = TG.build_geometries((n, n), DOM, 1)[0]
    rng = np.random.default_rng(seed)
    m_int = np.asarray(lvl.aux["m_int"])
    v = np.asarray(lvl.v) + (
        0.01 * rng.standard_normal(jg.padded_shape)).astype(np.float32) * m_int
    f = (rng.standard_normal(jg.padded_shape) * 0.1 + 1.0).astype(np.float32)
    fixed = (np.asarray(lvl.aux["m_log"]) - m_int)[:n, :n] > 0
    return jg, tg, v.astype(np.float32), f, fixed


def _close(got, want):
    ulp = np.spacing(np.float32(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=ULPS * ulp)


@pytest.mark.parametrize("ns", [1, 4, 5])
def test_slab_plain_matches_pallas(ns):
    """slab_relax (plain) against make_slab_relax interpreted (B = 8 slab
    rows, T = 4 sweeps per call: 5 sweeps take a call of 4 and one of 1),
    with the pinned ball and the ring untouched by both, bit for bit."""
    n = 33
    jg, tg, v, f, fixed = _level(n, seed=ns)
    fn = JR.make_slab_relax(JHJB(), jg, F32, 8, 4, interpret=True)
    want = np.asarray(fn(jnp.asarray(v), jnp.asarray(f), ns))[:n, :n]
    vt = torch.tensor(v[:n, :n])
    got = SL.slab_relax(vt, torch.tensor(f[:n, :n]), ns, HJBMinTime(), tg)
    assert got is not vt and torch.equal(vt, torch.tensor(v[:n, :n]))
    _close(got.numpy(), want)
    np.testing.assert_array_equal(want[fixed], v[:n, :n][fixed])
    np.testing.assert_array_equal(got.numpy()[fixed], v[:n, :n][fixed])


@pytest.mark.parametrize("n", [33, 65])
def test_resident_hjb_plain_matches_pallas(n):
    """resident_relax's HJB plain version (in place) against
    make_resident_relax interpreted, 1 and 7 sweeps, with the pinned ball
    and the ring untouched by both, bit for bit."""
    jg, tg, v, f, fixed = _level(n, seed=n)
    fn = JR.make_resident_relax(JHJB(), jg, F32, interpret=True)
    for ns in (1, 7):
        want = np.asarray(fn(jnp.asarray(v), jnp.asarray(f), ns))[:n, :n]
        got = RS.resident_relax(torch.tensor(v[:n, :n]),
                                torch.tensor(f[:n, :n]), ns, HJBMinTime(), tg)
        _close(got.numpy(), want)
        np.testing.assert_array_equal(want[fixed], v[:n, :n][fixed])
        np.testing.assert_array_equal(got.numpy()[fixed], v[:n, :n][fixed])


def test_slab_and_resident_plain_versions_agree():
    """Both plain versions are the Pallas form on the same masks and
    fields: bit for bit equal on the same level, for any sweep count."""
    _, tg, v, f, _ = _level(33, seed=3)
    vt, ft = torch.tensor(v[:33, :33]), torch.tensor(f[:33, :33])
    for ns in (1, 6):
        a = SL.slab_relax(vt, ft, ns, HJBMinTime(), tg)
        b = RS.resident_relax(vt.clone(), ft, ns, HJBMinTime(), tg)
        assert torch.equal(a, b)
    assert torch.equal(SL.slab_relax(vt, ft, 0, HJBMinTime(), tg), vt)


def test_keep_mask_is_the_aux_mask_exclusion():
    """On all nine levels of 513^2, kernel_keep_mask times the geometric
    masks is init_level's masks exactly, and the kernels' update mask
    (resident.hjb_fields) is its m_int; the four coefficient columns are
    row 0 of kernel_precompute's fields, equal on every row."""
    prob = HJBMinTime()
    geoms = TG.build_geometries((513, 513), prob.domain)
    assert len(geoms) == 9
    for g in geoms:
        lvl = prob.init_level(g)
        base = TG.base_aux(g)
        keep = prob.kernel_keep_mask(g.coords(), g, torch.float32)
        for k in ("m_int", "m_red", "m_black"):
            assert torch.equal(base[k] * keep, lvl.aux[k])
        m_red, m_black, pre = RS._plain_fields(prob, g, torch.float32,
                                               torch.device("cpu"))
        assert torch.equal(m_red, lvl.aux["m_red"])
        assert torch.equal(m_black, lvl.aux["m_black"])
        params, (mask, *cols) = RS.hjb_fields(prob, g, torch.device("cpu"))
        assert mask.dtype == torch.uint8
        assert torch.equal(mask.bool(), lvl.aux["m_int"] > 0)
        for c, k in zip(cols, ("c1", "s1", "inv_in", "inv_act")):
            assert torch.equal(pre[k], c.expand_as(pre[k]))
        assert params.c2 == np.float32(1.0 / g.spacing[1])


def test_cuda_plan_hjb():
    """HJBMinTime at 513^2 (FAS, coarsest relax, every level relaxed): the
    slab kernel on L0, which the resident kernel cannot hold, the HJB
    resident kernel on L1-L8 (a cluster of up to 16 CTAs on 257^2 and
    129^2, one CTA from 65^2 down, one warp on 3^2); 4 legs of one slab
    launch each (a whole leg a launch) and 176 resident legs per
    FMG(2, 30, 30) step.  The thesis scheme raises."""
    prob = HJBMinTime()
    geoms = TG.build_geometries((513, 513), prob.domain)
    k = CudaKernels(prob, geoms, torch.float32)
    assert [f.__name__ for f in k._relax] == (
        ["_relax_slab"] + ["_relax_resident"] * 8)
    lays = [RS.hjb_leg_layout(g) for g in geoms]
    assert lays[0] is None
    assert [lay.nctas > 1 for lay in lays[1:]] == [True] * 2 + [False] * 6
    assert [lay.threads == 32 for lay in lays[1:]] == [False] * 7 + [True]
    assert not RS.fits(geoms[0])
    assert SL.slab_launches(30, geoms[0]) == 1
    assert SL.slab_layout(geoms[0]).leg == 1
    nlev, nu0 = len(geoms), 2
    legs = [2 * nu0 * (l + 1) for l in range(nlev)]
    assert legs[0] == 4 and sum(legs[1:]) == 176
    with pytest.raises(NotImplementedError, match="queue 2 item 30"):
        CudaKernels(HJBMinTime(scheme="tesi"), geoms, torch.float32)
    with pytest.raises(NotImplementedError):
        CudaKernels(prob, geoms, torch.float64)


def test_wrappers_hjb_reject_what_kernels_do_not_take():
    _, tg, v, f, _ = _level(17, seed=9)
    prob = HJBMinTime()
    vt, ft = torch.tensor(v[:17, :17]), torch.tensor(f[:17, :17])
    with pytest.raises(TypeError, match="HJBMinTime"):
        SL.slab_relax(vt, ft, 1, Lyapunov2D(), tg)
    with pytest.raises(ValueError):
        SL.slab_relax(vt, None, 1, prob, tg)
    with pytest.raises(ValueError):
        SL.slab_relax(vt[:16].contiguous(), ft[:16].contiguous(), 1, prob, tg)
    with pytest.raises(TypeError, match="float32"):
        SL.slab_relax(vt.double(), ft.double(), 1, prob, tg)
    with pytest.raises(ValueError, match="no kernel for device"):
        SL.slab_relax(vt.to("meta"), ft.to("meta"), 1, prob, tg)
    with pytest.raises(NotImplementedError, match="queue 2 item 30"):
        SL.slab_relax(vt, ft, 1, HJBMinTime(scheme="tesi"), tg)
    with pytest.raises(ValueError, match="takes f"):
        RS.resident_relax(vt, None, 1, prob, tg)
    with pytest.raises(NotImplementedError, match="queue 2 item 30"):
        RS.resident_relax(vt, ft, 1, HJBMinTime(scheme="tesi"), tg)


# ------------------------------------------- the leg kernel's layout


HJB_LEVELS = (257, 129, 65, 33, 17, 9, 5, 3)


def _bands(lay):
    """(xo, xo_end, xs, xe) of each CTA: owned and loaded rows, as
    csrc/resident.cu computes them."""
    out = []
    for r in range(lay.nctas):
        xo = r * lay.B
        xo_end = min(xo + lay.B, lay.X)
        out.append((xo, xo_end, max(0, xo - lay.H), min(lay.X, xo_end + lay.H)))
    return out


@pytest.mark.parametrize("n", HJB_LEVELS)
def test_hjb_leg_layout_covers_each_level(n):
    """On every level of the HJB 513^2 hierarchy the layout holds the
    level on at most 16 CTAs of at most 227 KB and 512 threads; a
    cluster's bands carry 2T halo rows on both sides (the update reads
    both x neighbours) and own at least 2T rows, one CTA none; and the
    threads' (column, segment) items, as the kernel derives them, update
    each interior point of each colour exactly once within the owned
    rows."""
    g = TG.build_geometries((n, n), DOM)[0]
    lay = RS.hjb_leg_layout(g)
    assert lay is not None
    X, Y = g.padded_shape
    assert 1 <= lay.nctas <= 16 and lay.threads <= 512
    assert lay.smem_bytes <= 232448 and lay.S % 2 == 0
    assert lay.NC >= Y - 2 and lay.NC % 32 == 0 and lay.L in RS.HJB_ROWS
    if lay.nctas == 1:
        assert lay.H == 0 and lay.B == X
    else:
        assert lay.H == 2 * lay.T and lay.T >= 1 and lay.B >= lay.H
    count = np.zeros((2, X, Y), dtype=np.int64)
    for r, (xo, xo_end, xs, xe) in enumerate(_bands(lay)):
        if lay.nctas > 1:
            assert xs == max(0, xo - 2 * lay.T)
            assert xe == min(X, xo_end + 2 * lay.T)
        for seg in range(lay.G):
            seg0 = xs + seg * lay.L
            seg1 = min(seg0 + lay.L, xe)
            for x in range(max(seg0, xs + 1, xo), min(seg1, xe - 1, xo_end)):
                for y in range(1, Y - 1):
                    count[(x + y) % 2, x, y] += 1
    want = np.zeros((X, Y), dtype=np.int64)
    want[1:-1, 1:-1] = 1
    for c in range(2):
        colour = (np.add.outer(np.arange(X), np.arange(Y)) % 2) == c
        np.testing.assert_array_equal(count[c], want * colour)


def test_hjb_leg_layout_refuses_513():
    """513^2, the slab kernel's level, fits no layout (its bands need
    more rows than a thread's registers hold, or more threads)."""
    geoms = TG.build_geometries((513, 513), HJBMinTime().domain)
    assert RS.hjb_leg_layout(geoms[0]) is None
    assert [RS.hjb_leg_layout(g) is not None for g in geoms] == (
        [False] + [True] * 8)


def _band_schedule(v, f, nsweeps, problem, geom, lay):
    """The leg kernel's schedule in plain PyTorch: chunks of T sweeps (one
    chunk on one CTA); each CTA's band, its owned rows with the halo rows
    the layout gives it, relaxed on its own by the plain update, its first
    and last loaded rows held (the kernel never updates them); after each
    chunk the owned rows form the level the next chunk's bands load from
    (the halo refresh).  Returns a new tensor."""
    m_red, m_black, pre = RS._plain_fields(problem, geom, v.dtype, v.device)
    T = lay.T or max(nsweeps, 1)
    state, done = v.clone(), 0
    while done < nsweeps:
        tc = min(T, nsweeps - done)
        new = state.clone()
        for xo, xo_end, xs, xe in _bands(lay):
            keep = torch.ones((xe - xs, 1), dtype=v.dtype)
            keep[0] = keep[-1] = 0
            sv, sf = state[xs:xe].clone(), f[xs:xe]
            spre = {k: t[xs:xe] for k, t in pre.items()}
            mr, mb = m_red[xs:xe] * keep, m_black[xs:xe] * keep
            for _ in range(tc):
                sv = sv + mr * (problem.kernel_update(sv, sf, spre, geom) - sv)
                sv = sv + mb * (problem.kernel_update(sv, sf, spre, geom) - sv)
            new[xo:xo_end] = sv[xo - xs:xo_end - xs]
        state, done = new, done + tc
    return state


@pytest.mark.parametrize("T", [2, 4])
@pytest.mark.parametrize("n", [65, 129])
def test_hjb_banded_schedule_matches_plain(n, T):
    """The cluster's banded T-sweep schedule (bands with their recomputed
    2T halo rows, refreshed every T sweeps) equals resident_relax_plain
    bit for bit at 1, T - 1, T, T + 1 and 30 sweeps, on levels with the
    pinned ball, which stays as it was; the layout's own T among them."""
    g = TG.build_geometries((n, n), DOM)[0]
    lay = RS._segments(n, n, 8, T)
    assert lay is not None and lay.nctas == 8 and lay.H == 2 * T
    _, tg, v, f, fixed = _level(n, seed=n + T)
    vt, ft = torch.tensor(v[:n, :n]), torch.tensor(f[:n, :n])
    prob = HJBMinTime()
    default = RS.hjb_leg_layout(g)
    for ns in sorted({1, T - 1, T, T + 1, 30} - {0}):
        want = RS.resident_relax_plain(vt.clone(), ft, ns, prob, g)
        for lay_ in (lay, default):
            got = _band_schedule(vt, ft, ns, prob, g, lay_)
            assert torch.equal(got, want), (n, T, ns, lay_.as_dict())
        assert torch.equal(want[torch.tensor(fixed)], vt[torch.tensor(fixed)])


# ------------------------------------------- the slab kernel's layout


def _tiles(lay):
    """Each CTA's (xo, xo_end, yo, yo_end, xs, xe, ys, ye): owned and
    loaded points, CTA tx * nty + ty, as csrc/slab2d.cu's `tile_of`."""
    def owned(n, nt, B):  # steps of B, the last tile to the end
        return [(i * B, n if i + 1 == nt else (i + 1) * B)
                for i in range(nt)]

    out = []
    for xo, xo_end in owned(lay.X, lay.ntx, lay.BX):
        for yo, yo_end in owned(lay.Y, lay.nty, lay.BY):
            out.append((xo, xo_end, yo, yo_end, max(0, xo - lay.H),
                        min(lay.X, xo_end + lay.H), max(0, yo - lay.H),
                        min(lay.Y, yo_end + lay.H)))
    return out


def _published(lay, cta):
    """[((x, y), word)] of the owned strips a CTA publishes, as
    csrc/slab2d.cu's `build_table` lists them: top, bottom (H rows by its
    owned columns), left, right (its owned rows by H columns), each where
    the tile has a neighbour on that side; the word within its outbox."""
    H, FW = lay.H, lay.face_words()
    WX = lay.X - (lay.ntx - 1) * lay.BX
    WY = lay.Y - (lay.nty - 1) * lay.BY
    xo, xo_end, yo, yo_end = _tiles(lay)[cta][:4]
    tx, ty = divmod(cta, lay.nty)
    OX, OY = xo_end - xo, yo_end - yo
    out = []
    for s, has in enumerate((tx > 0, tx + 1 < lay.ntx, ty > 0,
                             ty + 1 < lay.nty)):
        if not has:
            continue
        for i in range(H * OY if s < 2 else OX * H):
            if s < 2:
                k, c = divmod(i, OY)
                x = (xo if s == 0 else xo_end - H) + k
                y, word = yo + c, s * H * WY + k * WY + c
            else:
                k, c = divmod(i, H)
                x = xo + k
                y = (yo if s == 2 else yo_end - H) + c
                word = 2 * H * WY + (s - 2) * WX * H + i
            assert 0 <= word < FW
            out.append(((x, y), word))
    return out


def _halo(lay, cta):
    """[((x, y), word)] of a CTA's halo points (loaded, not owned), as
    csrc/slab2d.cu's `build_table` lists them, the word counted from the
    start of the outboxes at one parity (CTA c's at 2 c FW)."""
    H, FW = lay.H, lay.face_words()
    WX = lay.X - (lay.ntx - 1) * lay.BX
    WY = lay.Y - (lay.nty - 1) * lay.BY
    xo, xo_end, yo, yo_end, xs, xe, ys, ye = _tiles(lay)[cta]
    tx, ty = divmod(cta, lay.nty)
    LY, OX = ye - ys, xo_end - xo
    out = []
    for s, n in enumerate(((xo - xs) * LY, (xe - xo_end) * LY,
                           OX * (yo - ys), OX * (ye - yo_end))):
        for i in range(n):
            if s < 2:
                k, c = divmod(i, LY)
                x, y = (xs if s == 0 else xo_end) + k, ys + c
                sty = min(y // lay.BY, lay.nty - 1)
                src = (tx + (-1 if s == 0 else 1)) * lay.nty + sty
                r = x - (xo - H) if s == 0 else x - xo_end
                off = (H * WY if s == 0 else 0) + r * WY + (y - sty * lay.BY)
            else:
                w = yo - ys if s == 2 else ye - yo_end
                k, c = divmod(i, w)
                x, y = xo + k, (ys if s == 2 else yo_end) + c
                src = tx * lay.nty + ty + (-1 if s == 2 else 1)
                c = y - (yo - H) if s == 2 else y - yo_end
                off = 2 * H * WY + (WX * H if s == 2 else 0) + k * H + c
            assert 0 <= off < FW
            out.append(((x, y), src * 2 * FW + off))
    return out


def _check_slab_layout(lay):
    """The tiles own every point once, each of at least H rows and
    columns where it has a neighbour; every tile's halo words are
    published by the tile that owns the point, at the same point; and the
    threads' (segment, column) items, as the kernel derives them, update
    each point strictly inside every tile's loaded region exactly once."""
    X, Y = lay.X, lay.Y
    assert lay.threads == lay.G * lay.NC <= SL.MAX_THREADS
    assert lay.smem_bytes == (4 * lay.rows * lay.S + 8 * lay.table_entries()
                              ) <= SL.MAX_SMEM_BYTES
    assert lay.NC % 32 == 0 and lay.S == lay.NC + 2 and lay.S % 2 == 0
    assert lay.L in SL.SLAB_ROWS and lay.H == 2 * lay.T
    owned = np.zeros((X, Y), dtype=np.int64)
    FW = lay.face_words()
    words = {}
    for c, (xo, xo_end, yo, yo_end, *_) in enumerate(_tiles(lay)):
        owned[xo:xo_end, yo:yo_end] += 1
        if lay.ntx > 1:
            assert xo_end - xo >= lay.H
        if lay.nty > 1:
            assert yo_end - yo >= lay.H
        for (x, y), w in _published(lay, c):
            assert xo <= x < xo_end and yo <= y < yo_end
            assert words.setdefault(c * 2 * FW + w, (x, y)) == (x, y)
    np.testing.assert_array_equal(owned, 1)
    for c, (xo, xo_end, yo, yo_end, xs, xe, ys, ye) in enumerate(_tiles(lay)):
        halo = _halo(lay, c)
        assert len(halo) == (xe - xs) * (ye - ys) - (xo_end - xo) * (
            yo_end - yo)
        if lay.table_entries():  # the refresh table holds both lists
            assert len(_published(lay, c)) <= FW
            assert FW + len(halo) <= lay.table_entries()
        for (x, y), w in halo:
            assert xs <= x < xe and ys <= y < ye
            assert not (xo <= x < xo_end and yo <= y < yo_end)
            assert words[w] == (x, y)
        count = np.zeros((xe - xs, ye - ys), dtype=np.int64)
        assert xe - xs <= lay.G * lay.L and ye - ys - 2 <= lay.NC
        for seg in range(lay.G):
            seg0 = xs + seg * lay.L
            rows = range(max(seg0, xs + 1), min(seg0 + lay.L, xe - 1))
            for col in range(lay.NC):
                y = ys + 1 + col
                if y <= ye - 2:
                    for x in rows:
                        count[x - xs, y - ys] += 1
        want = np.zeros_like(count)
        want[1:-1, 1:-1] = 1
        np.testing.assert_array_equal(count, want)


@pytest.mark.parametrize("n", [513, 257, 1025])
def test_slab_layout_covers_each_level(n):
    """513^2, the plan's level: one leg a launch on 16 x 8 tiles of 32 x 64
    points, 128 CTAs that an H100's 132 SMs hold co-resident, each within
    a CTA's threads and shared memory; every owned point once, every halo
    word from its owner.  257^2 (chip_smoke's second level) a leg too;
    1025^2, whose smallest leg tiles no CTA holds, T sweeps a launch."""
    g = TG.build_geometries((n, n), HJBMinTime().domain, 1)[0]
    lay = SL.slab_layout(g)
    assert lay is not None and lay.T == SL.SLAB_T
    assert lay.leg == (n < 1025)
    if lay.leg:
        assert lay.ctas <= SL.LEG_CTAS
    if n == 513:
        assert (lay.ntx, lay.nty, lay.BX, lay.BY) == (16, 8, 32, 64)
    _check_slab_layout(lay)
    assert SL.slab_launches(30, g) == (1 if lay.leg else 8)


def test_slab_layout_refuses_what_it_cannot_hold():
    """No layout off 2D levels (a wrap level's is its logical level's, for
    2D Poisson); a leg on more CTAs than the grid holds co-resident, tiles
    owning fewer than 2T points beside a neighbour, or a CTA short of
    threads are refused; the wrapper raises on a level without a layout,
    and on HJB over a wrap level."""
    wrap_lay = SL.slab_layout(TG.build_geometries((17, 17), DOM, 1,
                                                  wrap=True)[0])
    assert (wrap_lay.X, wrap_lay.Y, wrap_lay.wrap) == (17, 17, 1)
    assert SL.slab_layout(TG.build_geometries((17,) * 3, DOM + DOM[:1],
                                              1)[0]) is None
    assert SL._slab_layout(1025, 1025, 32, 64, 4, True) is None  # 512 CTAs
    assert SL._slab_layout(1025, 1025, 32, 64, 4, False) is not None
    assert SL._slab_layout(129, 129, 8, 16, 8, True) is None  # BX < 2T
    assert SL._slab_layout(1025, 1025, 64, 128, 4, True) is None  # threads
    assert SL._slab_layout(513, 513, 32, 64, 8, True, 6) is None
    tg = TG.build_geometries((17, 17), DOM, 1, wrap=True)[0]
    vt = torch.zeros(tg.padded_shape)
    with pytest.raises(ValueError):
        SL.slab_relax(vt, vt, 1, HJBMinTime(), tg)


def _tile_schedule(v, f, nsweeps, problem, geom, lay):
    """The kernel's schedule in plain PyTorch: every CTA loads its tile
    with its halo from v and relaxes the whole loaded region on its own
    by the plain update, its edge held (the kernel never updates it);
    every T sweeps (a leg) each CTA publishes its owned strips into its
    outbox at the refresh's parity, as (epoch, value) words, and takes
    its halo from its neighbours' outboxes, each word of the refresh's
    epoch; at most T sweeps a launch, each launch loading from the
    level the one before wrote.  Returns the level the owned points
    form."""
    m_red, m_black, pre = RS._plain_fields(problem, geom, v.dtype, v.device)
    tiles = _tiles(lay)
    FW = lay.face_words()

    def flat(c, items):
        """(flat indices in CTA c's loaded region, words) of `items`."""
        _, _, _, _, xs, _, ys, ye = tiles[c]
        return (torch.tensor([(x - xs) * (ye - ys) + y - ys
                              for (x, y), _ in items], dtype=torch.int64),
                torch.tensor([w for _, w in items], dtype=torch.int64))

    pub = [flat(c, _published(lay, c)) for c in range(lay.ctas)]
    halo = [flat(c, _halo(lay, c)) for c in range(lay.ctas)]
    box_val = torch.zeros(2 * lay.ctas * FW, dtype=v.dtype)
    box_ep = torch.zeros(2 * lay.ctas * FW, dtype=torch.int64)

    def owned_level(regions):
        out = torch.empty_like(v)
        for (xo, xo_end, yo, yo_end, xs, _, ys, _), sv in zip(tiles,
                                                              regions):
            out[xo:xo_end, yo:yo_end] = sv[xo - xs:xo_end - xs,
                                           yo - ys:yo_end - ys]
        return out

    def load(level):
        return [level[xs:xe, ys:ye].clone()
                for _, _, _, _, xs, xe, ys, ye in tiles]

    regions = load(v)
    exchange = lay.leg and lay.ctas > 1
    T = lay.T if (exchange or not lay.leg) else max(nsweeps, 1)
    done, ch = 0, 0
    while done < nsweeps:
        tc = min(T, nsweeps - done)
        for c, (_, _, _, _, xs, xe, ys, ye) in enumerate(tiles):
            keep = torch.zeros((xe - xs, ye - ys), dtype=v.dtype)
            keep[1:-1, 1:-1] = 1
            sf = f[xs:xe, ys:ye]
            spre = {k: t[xs:xe, ys:ye] for k, t in pre.items()}
            mr, mb = m_red[xs:xe, ys:ye] * keep, m_black[xs:xe, ys:ye] * keep
            sv = regions[c]
            for _ in range(tc):
                sv = sv + mr * (problem.kernel_update(sv, sf, spre, geom) - sv)
                sv = sv + mb * (problem.kernel_update(sv, sf, spre, geom) - sv)
            regions[c] = sv
        done += tc
        if done < nsweeps and exchange:
            k = ch & 1
            for c, (at, w) in enumerate(pub):
                box_val[(c * 2 + k) * FW + w] = regions[c].reshape(-1)[at]
                box_ep[(c * 2 + k) * FW + w] = ch + 1
            for c, (at, w) in enumerate(halo):
                assert bool((box_ep[k * FW + w] == ch + 1).all())
                regions[c].view(-1)[at] = box_val[k * FW + w]
        elif done < nsweeps:
            regions = load(owned_level(regions))
        ch += 1
    return owned_level(regions)


@pytest.mark.parametrize("T", [2, 4])
@pytest.mark.parametrize("n", [65, 129])
def test_slab_tile_schedule_matches_plain(n, T):
    """The slab kernel's tile schedule (tiles with their 2T halos,
    refreshed every T sweeps through the outboxes' words) equals
    slab_relax_plain bit for bit at 1, T - 1, T, T + 1 and 30 sweeps, on
    levels with the pinned ball, which stays as it was, and the ring: in
    small tiles of 8 x 16 points as a leg and as launches of at most T
    sweeps, and in the level's own layout."""
    g = TG.build_geometries((n, n), DOM)[0]
    small = SL._slab_layout(n, n, 8, 16, T, True)
    chain = SL._slab_layout(n, n, 8, 16, T, False)
    assert small is not None and small.ctas > 1 and small.H == 2 * T
    _check_slab_layout(small)
    _, tg, v, f, fixed = _level(n, seed=n + 3 * T)
    vt, ft = torch.tensor(v[:n, :n]), torch.tensor(f[:n, :n])
    prob = HJBMinTime()
    fx = torch.tensor(fixed)
    for ns in sorted({1, T - 1, T, T + 1, 30} - {0}):
        want = SL.slab_relax_plain(vt, ft, ns, prob, g)
        for lay in (small, chain, SL.slab_layout(g)):
            got = _tile_schedule(vt, ft, ns, prob, g, lay)
            assert torch.equal(got, want), (n, T, ns, lay.as_dict())
        assert torch.equal(want[fx], vt[fx])
