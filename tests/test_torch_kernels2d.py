"""Port parity of the 2D Lyapunov kernel modules' plain versions (what the
wrappers run for CPU tensors) against the JAX package's Pallas kernels in
interpret mode, on padded TPU geometries (pad_last_to=128,
pad_sublane_to=8, as tests/test_pallas.py runs them), compared on the
logical arrays: the port pads nothing.

The kernels themselves build and run only on a GPU; `chip_smoke.py` holds
each one against its plain version there, bit for bit.  Here the wrappers
must take the plain path for CPU tensors, count no launch, and reject what
the kernels do not take.

Tolerance for the sweeps: at most 3 ulp of the largest value the sweeps
read.  Both sides evaluate the same per-point operations in the same
order; XLA's CPU backend, which runs the interpreted Pallas kernels,
contracts the update's products with the following sums into fused
multiply-adds (up to two roundings per point and half-sweep in the
resident form), and nothing else differs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pde_multigrid_tpu import Lyapunov2D as JLyapunov2D
from pde_multigrid_tpu.grid import Hierarchy as JHierarchy
from pde_multigrid_tpu.ops.pallas import relax as JR
from pde_multigrid_tpu_torch import Lyapunov2D, Poisson
from pde_multigrid_tpu_torch import grid as TG
from pde_multigrid_tpu_torch.ops.cuda import relax2d as R2
from pde_multigrid_tpu_torch.ops.cuda import resident as RS
from pde_multigrid_tpu_torch.ops.cuda.dispatch import CudaKernels

F32 = jnp.dtype("float32")
ULPS = 3


@pytest.fixture(autouse=True)
def _no_launches():
    """CPU tensors never launch a kernel: every counter stays at zero."""
    R2.reset_launches()
    RS.reset_launches()
    yield
    assert not any(R2.launches.values()) and not any(RS.launches.values())


def _level(n, seed):
    """The JAX padded geometry, the port's unpadded one, and float32
    (v, f) on the padded shape: random on the logical region, zero in
    the padding (as the solvers keep it)."""
    jg = JHierarchy.build(JLyapunov2D(), n, pad_last_to=128,
                          pad_sublane_to=8).geoms[0]
    tg = TG.build_geometries((n, n), Lyapunov2D().domain, 1)[0]
    rng = np.random.default_rng(seed)
    v = np.zeros(jg.padded_shape, np.float32)
    f = np.zeros(jg.padded_shape, np.float32)
    v[:n, :n] = rng.standard_normal((n, n))
    f[:n, :n] = rng.standard_normal((n, n))
    return jg, tg, v, f


def _close(got, want):
    ulp = np.spacing(np.float32(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=ULPS * ulp)


# ------------------------------------------------------------ converters


@pytest.mark.parametrize("n", [33, 65])
def test_split_merge2d_match_pallas_converters(n):
    """split2d / merge2d (plain) against the Pallas pick-matrix converters
    and the XLA split_colors_2d in interpret mode: exact permutations.
    The port's halves are ceil(n/2) wide; the slot y = n of odd rows is
    inert (0), as the zero padding makes it on the TPU layout."""
    jg, tg, v, _ = _level(n, seed=n)
    X, Y = jg.padded_shape
    Y2p = -(-(Y // 2) // 128) * 128
    sc, p0, p1 = JR._pallas_split_2d(X, Y, Y2p, F32, interpret=True)
    jr, jb = (np.asarray(a) for a in sc(jnp.asarray(v), p0, p1))
    xr, xb = JR.split_colors_2d(jnp.asarray(v), JR._qx_mask(X))
    np.testing.assert_array_equal(jr[:, : Y // 2], np.asarray(xr))
    np.testing.assert_array_equal(jb[:, : Y // 2], np.asarray(xb))
    r, b = R2.to_halves(torch.tensor(v[:n, :n]))
    Y2 = (n + 1) // 2
    assert r.shape == b.shape == (n, Y2)
    np.testing.assert_array_equal(r.numpy(), jr[:n, :Y2])
    np.testing.assert_array_equal(b.numpy(), jb[:n, :Y2])
    back = R2.from_halves(r, b, torch.empty(n, n))
    np.testing.assert_array_equal(back.numpy(), v[:n, :n])
    mc, u0, u1 = JR._pallas_merge_2d(X, Y, Y2p, F32, interpret=True)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(mc(jnp.asarray(jr), jnp.asarray(jb), u0,
                                    u1))[:n, :n])


# ------------------------------------------------------------ half-sweeps


def _merge_quads(X, Y, skew):
    """csrc/relax2d.cu's merge2d_kernel on an (X, Y) level whose output
    starts `skew` bytes past a 16-byte boundary, in numpy: (flat index
    written, row x, column y) of the points it writes, in pieces in the
    kernel's order: the head (points before the first 16-byte-aligned
    quad), point e of every quad (each quad finding its row by one
    division, running on into the next row where it crosses one), the
    tail."""
    n = X * Y
    head = min((16 - skew) % 16 // 4, n)
    nquads = (n - head) // 4
    edge = np.array(list(range(head)) + list(range(head + 4 * nquads, n)),
                    dtype=np.int64)
    yield edge, edge // Y, edge % Y
    i = head + 4 * np.arange(nquads, dtype=np.int64)
    assert ((skew + 4 * i) % 16 == 0).all()  # every quad's store aligned
    x = i // Y
    y = i - x * Y
    for e in range(4):
        yield i + e, x, y
        y = y + 1
        x = np.where(y == Y, x + 1, x)
        y = np.where(y == Y, 0, y)


@pytest.mark.parametrize("shape", [(4097, 4097), (2049, 2049), (1025, 1025),
                                   (513, 513), (65, 131), (33, 10), (7, 3),
                                   (1, 5)])
def test_merge2d_layout_writes_every_point_once(shape):
    """merge2d's flat quads, at every offset of the dense output from a
    16-byte boundary (so each dense row starts at every offset mod 4):
    every dense point written exactly once, at its own (x, y), from the
    half slot `merge_colors_2d` takes it from, which holds that point (so
    no inert slot, y = Y of an odd row, is read)."""
    X, Y = shape
    Y2 = (Y + 1) // 2
    rng = np.random.default_rng(X + Y)
    r = rng.standard_normal((X, Y2)).astype(np.float32)
    b = rng.standard_normal((X, Y2)).astype(np.float32)
    want = R2.merge_colors_2d(torch.tensor(r), torch.tensor(b),
                              Y).numpy().reshape(-1)
    r, b = r.reshape(-1), b.reshape(-1)
    for skew in (0, 4, 8, 12):
        count = np.zeros(X * Y, dtype=np.int32)
        for idx, x, y in _merge_quads(X, Y, skew):
            count[idx] += 1  # a piece writes each point once at most
            np.testing.assert_array_equal(x * Y + y, idx)
            red = ((x ^ y) & 1) == 0
            j = y >> 1
            np.testing.assert_array_equal(
                np.where(red, r[x * Y2 + j], b[x * Y2 + j]), want[idx])
            # red sits at y = 2 j + q, black at 2 j + 1 - q (q = x % 2)
            q = x & 1
            np.testing.assert_array_equal(
                np.where(red, 2 * j + q, 2 * j + 1 - q), y)
        np.testing.assert_array_equal(count, 1)


@pytest.mark.parametrize("f_zero", [False, True])
@pytest.mark.parametrize("n", [33, 65])
def test_half_sweep2d_matches_pallas(n, f_zero):
    """Red-black sweeps on halves (split, relax_halves2d: chunks of
    CHUNK_T = 4 sweeps with a remainder chunk, merge) against
    make_split_color_slab_2d in interpret mode (T = 4 sweeps per call
    behind its one-sided halo), dense in and out and in the raw form the
    persistent tier runs (halves in and out, JAX's converters), with and
    without f; 1, 4, 5 and 9 sweeps cover one chunk, a remainder alone
    and remainder chunks."""
    jg, tg, v, f = _level(n, seed=2 * n + f_zero)
    fn = JR.make_split_color_slab_2d(JLyapunov2D(), jg, F32, 8,
                                     sweeps_per_call=4, interpret=True)
    raw = JR.make_split_color_slab_2d(JLyapunov2D(), jg, F32, 8,
                                      sweeps_per_call=4, interpret=True,
                                      raw=True)
    X, Y = jg.padded_shape
    split_pad, merge = JR.make_color_converters_2d(
        X, Y, -(-(Y // 2) // 128) * 128, F32, interpret=True)
    jfs = () if f_zero else split_pad(jnp.asarray(f))
    for ns in (1, 4, 5, 9):
        want = np.asarray(fn(jnp.asarray(v), jnp.asarray(f), ns,
                             f_zero=f_zero))[:n, :n]
        want_raw = np.asarray(merge(*raw(*split_pad(jnp.asarray(v)), jfs,
                                         ns)))[:n, :n]
        r, b = R2.to_halves(torch.tensor(v[:n, :n]))
        fr, fb = (None, None) if f_zero else R2.to_halves(
            torch.tensor(f[:n, :n]))
        out = R2.relax_halves2d(r, b, fr, fb, ns, Lyapunov2D(), tg)
        assert (out[0] is r) == (-(-ns // R2.CHUNK_T) % 2 == 0)
        got = R2.from_halves(*out, torch.empty(n, n)).numpy()
        _close(got, want)
        _close(got, want_raw)


def test_half_sweep2d_colors_masks_and_boundary_column():
    """A red half-sweep writes exactly the red interior points (y = 2j + q,
    never a boundary point or the inert slot) and leaves the rest
    bitwise; black likewise.  The Dirichlet column y = n - 1 reaches the
    halves: every point at y = n - 2 reads it as its S neighbor."""
    n = 17
    _, tg, v, f = _level(n, seed=5)
    prob = Lyapunov2D()
    aux = TG.base_aux(tg)
    r, b = R2.to_halves(torch.tensor(v[:n, :n]))
    fr, fb = R2.to_halves(torch.tensor(f[:n, :n]))
    r0, b0 = r.clone(), b.clone()
    R2.half_sweep2d_plain(r, b, fr, R2.RED, prob, tg)
    assert torch.equal(b, b0)
    changed = R2.from_halves(r, b, torch.empty(n, n)) != torch.tensor(
        v[:n, :n])
    assert torch.equal(changed, aux["m_red"] > 0)
    R2.half_sweep2d_plain(b, r, fb, R2.BLACK, prob, tg)
    changed = R2.from_halves(r, b, torch.empty(n, n)) != torch.tensor(
        v[:n, :n])
    assert torch.equal(changed, aux["m_int"] > 0)
    # the S neighbor of y = n - 2 is the boundary column
    v2 = v[:n, :n].copy()
    v2[:, n - 1] += 1.0
    outs = []
    for dense in (v[:n, :n], v2):
        r, b = R2.to_halves(torch.tensor(dense))
        r, b = R2.relax_halves2d(r, b, fr, fb, 1, prob, tg)
        outs.append(R2.from_halves(r, b, torch.empty(n, n)))
    diff = (outs[0] != outs[1])[1 : n - 1, n - 2]
    assert bool(diff.all())


def _bits(a):
    return a.contiguous().view(torch.int32)


@pytest.mark.parametrize("n", [17, 33, 65])
def test_fless_chunk_is_the_fless_chain(n):
    """The chunk's f-less form (fr = fb = None: no RHS read, no f a_f
    term) on a level's halves is bitwise the f-less half-sweep chain
    (half_sweep2d_plain with fu None) at t = 1, 3, 4; the form with f on
    f = 0 gives the same values (its -0 + +0 may differ in the sign
    bit, which is why the f-less form adds no zero term)."""
    _, tg, v, _ = _level(n, seed=40 + n)
    prob = Lyapunov2D()
    r0, b0 = R2.to_halves(torch.tensor(v[:n, :n]))
    zr, zb = torch.zeros_like(r0), torch.zeros_like(b0)
    for t in (1, 3, 4):
        cr, cb = r0.clone(), b0.clone()
        for _ in range(t):
            R2.half_sweep2d_plain(cr, cb, None, R2.RED, prob, tg)
            R2.half_sweep2d_plain(cb, cr, None, R2.BLACK, prob, tg)
        out = (torch.empty_like(r0), torch.empty_like(b0))
        R2.color_slab2d_shard(r0, b0, None, None, 0, t, prob, tg, n, out,
                              one_rank=True)
        assert torch.equal(_bits(out[0]), _bits(cr))
        assert torch.equal(_bits(out[1]), _bits(cb))
        withf = (torch.empty_like(r0), torch.empty_like(b0))
        R2.color_slab2d_shard(r0, b0, zr, zb, 0, t, prob, tg, n, withf,
                              one_rank=True)
        assert torch.equal(withf[0], out[0]) and torch.equal(withf[1],
                                                             out[1])
    with pytest.raises(ValueError, match="both RHS halves"):
        R2.color_slab2d_shard(r0, b0, zr, None, 0, 1, prob, tg, n, out,
                              one_rank=True)


@pytest.mark.parametrize("with_f", [False, True])
def test_relax_halves2d_chunks_and_pairs(monkeypatch, with_f):
    """relax_halves2d is JAX's sweeps_per_call = CHUNK_T form: one
    one-rank chunk per CHUNK_T sweeps and a remainder chunk, each from
    one pair of halves into the other; with a spare pair the result lies
    in whichever pair the last chunk wrote (the spare after an odd count
    of chunks), bitwise the half-sweep chain either way; no sweep, no
    chunk."""
    n = 33
    _, tg, v, f = _level(n, seed=77 + with_f)
    prob = Lyapunov2D()
    calls = []
    chunk = R2.color_slab2d_shard

    def spy(*a, **k):
        calls.append((a[5], a[8], k.get("one_rank"), a[2] is None))
        return chunk(*a, **k)

    monkeypatch.setattr(R2, "color_slab2d_shard", spy)
    assert R2.CHUNK_T == 4
    r0, b0 = R2.to_halves(torch.tensor(v[:n, :n]))
    fr, fb = R2.to_halves(torch.tensor(f[:n, :n])) if with_f else (None,
                                                                    None)
    for ns, ts in ((0, []), (1, [1]), (4, [4]), (5, [4, 1]), (9, [4, 4, 1]),
                   (12, [4, 4, 4])):
        calls.clear()
        cr, cb = r0.clone(), b0.clone()
        for _ in range(ns):
            R2.half_sweep2d_plain(cr, cb, fr, R2.RED, prob, tg)
            R2.half_sweep2d_plain(cb, cr, fb, R2.BLACK, prob, tg)
        pair = (r0.clone(), b0.clone())
        spare = (torch.empty_like(r0), torch.empty_like(b0))
        out = R2.relax_halves2d(*pair, fr, fb, ns, prob, tg, spare=spare)
        assert [c[0] for c in calls] == ts
        assert all(c[1:] == (n, True, not with_f) for c in calls)
        if len(ts) % 2:
            assert out is spare
        else:
            assert out[0] is pair[0] and out[1] is pair[1]
        assert torch.equal(_bits(out[0]), _bits(cr))
        assert torch.equal(_bits(out[1]), _bits(cb))


# --------------------------------------------------------------- resident


@pytest.mark.parametrize("f_zero", [False, True])
@pytest.mark.parametrize("n", [33, 65])
def test_resident_matches_pallas(n, f_zero):
    """All sweeps of a leg on the dense level against make_resident_relax
    in interpret mode, with and without f."""
    jg, tg, v, f = _level(n, seed=3 * n + f_zero)
    fn = JR.make_resident_relax(JLyapunov2D(), jg, F32, interpret=True)
    for ns in (1, 7):
        want = np.asarray(fn(jnp.asarray(v), jnp.asarray(f), ns,
                             f_zero=f_zero))[:n, :n]
        got = RS.resident_relax(torch.tensor(v[:n, :n]),
                                None if f_zero else torch.tensor(f[:n, :n]),
                                ns, Lyapunov2D(), tg)
        _close(got.numpy(), want)


def test_resident_sizes():
    """The kernel holds a level in x bands on the largest cluster of at
    most 16 CTAs whose bands (8 rows or more, with 8 halo rows) fit a
    CTA's 4096 points (relax2d.leg_layout): 16, 15 and 9 CTAs at 257^2,
    129^2 and 65^2, fewer on smaller levels, one CTA on levels no cluster
    fits; 513^2 does not fit (the split tier serves it), nor a wrap or a
    3D level."""
    dom = Lyapunov2D().domain
    want = {257: (25, 17, 16), 129: (17, 9, 15), 65: (16, 8, 9)}
    for n, ok in ((65, True), (129, True), (257, True), (513, False)):
        g = TG.build_geometries((n, n), dom, 1)[0]
        assert RS.fits(g) is ok
        assert RS.layout(g) == want.get(n)
    for n in (3, 5, 9, 17, 33):
        g = TG.build_geometries((n, n), dom, 1)[0]
        RX, BX, nctas = RS.layout(g)
        Y2 = (n + 1) // 2
        assert RX * Y2 <= R2.LEG_POINTS
        if nctas == 1:
            assert RX == BX == n
        else:
            assert BX >= 2 * R2.LEG_T and RX == BX + 2 * R2.LEG_T
            assert (nctas - 1) * BX < n <= nctas * BX
    assert RS.layout(TG.build_geometries((3, 3), dom, 1)[0]) == (3, 3, 1)
    assert RS.layout(TG.build_geometries((33, 33), dom, 1)[0]) == (17, 9, 4)
    wrap = TG.build_geometries((17, 17), ((0.0, 1.0),) * 2, wrap=True)[0]
    cube = TG.build_geometries((9, 9, 9), ((0.0, 1.0),) * 3, 1)[0]
    assert RS.layout(wrap) is None and RS.layout(cube) is None


def test_resident_refuses_what_no_cluster_holds():
    """A dense level no cluster holds (513^2) is refused before any
    sweep, on either device, and so is a level of the wrong shape."""
    prob = Lyapunov2D()
    g = TG.build_geometries((513, 513), prob.domain, 1)[0]
    v = torch.zeros(513, 513)
    with pytest.raises(ValueError, match="does not fit"):
        RS.resident_relax(v, None, 1, prob, g)
    with pytest.raises(ValueError, match="does not fit"):
        RS.resident_relax(v, torch.zeros_like(v), 3, prob, g)
    small = TG.build_geometries((65, 65), prob.domain, 1)[0]
    with pytest.raises(ValueError):
        RS.resident_relax(torch.zeros(65, 64), None, 1, prob, small)


# --------------------------------------------------------------- wrappers


def test_wrappers_2d_reject_what_kernels_do_not_take():
    _, tg, v, f = _level(17, seed=9)
    prob = Lyapunov2D()
    vt = torch.tensor(v[:17, :17])
    with pytest.raises(TypeError, match="float32"):
        R2.to_halves(vt.double())
    with pytest.raises(ValueError, match="contiguous"):
        R2.to_halves(vt.t())
    with pytest.raises(ValueError):
        R2.to_halves(torch.zeros(2, 3, 4))
    with pytest.raises(ValueError, match="no kernel for device"):
        R2.to_halves(torch.zeros(4, 4, device="meta"))
    r, b = R2.to_halves(vt)
    with pytest.raises(ValueError):
        R2.from_halves(r, b, torch.empty(17, 19))
    with pytest.raises(ValueError):
        R2.relax_halves2d(r[:, :3], b, None, None, 1, prob, tg)
    with pytest.raises(TypeError, match="Lyapunov2D"):
        R2.lyap_params(Poisson(2), tg)
    with pytest.raises(ValueError):
        RS.resident_relax(vt[:16].contiguous(), None, 1, prob, tg)
    wrap = TG.build_geometries((17, 17), ((0.0, 1.0),) * 2, wrap=True)[0]
    with pytest.raises(ValueError):
        R2.lyap_params(prob, wrap)


# ------------------------------------------------------------------- plan


def test_cuda_dispatch_plan_2d():
    """The 4097^2 exact-coarsest hierarchy: 4097^2 ... 513^2 take the
    persistent split tier, 257^2 ... 65^2 the resident kernel, 33^2 the
    dense coarse solve.  With mixed the levels relax in float32 (no defect
    plan covers a 2D level).  2D Poisson is planned: its padded split
    levels take the same persistent tier, in row 16's Poisson form."""
    prob = Lyapunov2D()
    geoms = TG.build_geometries((4097, 4097), prob.domain, 8)
    assert [g.shape[0] for g in geoms] == [
        4097, 2049, 1025, 513, 257, 129, 65, 33]
    for mixed in (False, True):
        k = CudaKernels(prob, geoms, torch.float32, range(7), mixed=mixed)
        assert k._split == [True] * 4 + [False] * 4
        assert [fn is not None for fn in k._relax] == [True] * 7 + [False]
        assert all(d is None for d in k._defect)
        # the split levels by JAX's sweeps_per_call = T form (row 16 by
        # the colour slab's one-rank chunk, CHUNK_T sweeps a launch), the
        # small ones by row 1's clustered leg
        assert k._relax[:4] == [k._relax_split] * 4
        assert k._relax[4:7] == [k._relax_resident] * 3
    assert [R2.slab_tile(g.shape[0], (g.shape[1] + 1) // 2, R2.CHUNK_T)[4]
            for g in geoms[:4]] == [1024, 1024, 1024, 512]
    assert [RS.layout(g)[2] for g in geoms[4:7]] == [16, 15, 9]
    pk = CudaKernels(Poisson(2, ((0.0, 1.5),) * 2), TG.build_geometries(
        (4097, 4097), ((0.0, 1.5),) * 2, 8), torch.float32, range(7))
    assert pk._split == k._split
    assert pk._relax[:4] == [pk._relax_split] * 4
    assert pk._relax[4:7] == [pk._relax_resident] * 3
    with pytest.raises(NotImplementedError):
        CudaKernels(prob, geoms, torch.float64, range(7))
    # a level neither tier serves: too wide for the resident kernel and
    # below the split gate
    odd = TG.build_geometries((1025, 257), prob.domain, 1)
    with pytest.raises(NotImplementedError):
        CudaKernels(prob, odd, torch.float32)
