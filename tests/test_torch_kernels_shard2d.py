"""Port parity of the per-shard 2D color slab of the sharded Lyapunov
solve: `ops/cuda/relax2d.py` `color_slab2d_shard_plain` (what the wrappers
`color_slab2d_shard`, in its ext and one-rank forms, and
`color_slab2d_leg` run for CPU tensors) against the JAX package's
`make_split_color_slab_2d_shard` in interpret mode, and against the port's
own whole-level half-sweeps on shards whose first global row is odd (which
JAX's 8-row alignment never makes); the one-rank forms against the chunked
schedule; the kernel's tiles and leg layouts; the wrappers on CPU tensors
and their refusals.

JAX's kernel takes lane-padded halves (Y2p = 128 slots for 129 points)
and an 8-row-rounded halo; the port's halves are ceil(Y/2) = 65 wide, so
the two compare on the logical slots [:, :65] of the owned rows.  The
shards are those of a padded 129^2 level built by JAX with
`pad_axis0_to` chosen so that x_loc % 8 == 0 (136, 144 and 160 rows over
1, 2 and 4 ranks).

Tolerance against JAX: 3 ulp of the largest value the sweeps read, as
tests/test_torch_kernels2d.py holds half_sweep2d: XLA's CPU backend, which
runs the interpreted kernel, contracts the update's products into fused
multiply-adds.  Against the port's whole-level sweeps: bitwise (the same
operations in the same order).  On the card, with --fmad=false, the CUDA
kernel equals the plain version bit for bit (`chip_smoke.py`)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pde_multigrid_tpu import Lyapunov2D as JLyapunov2D
from pde_multigrid_tpu.grid import Hierarchy as JHierarchy
from pde_multigrid_tpu.ops.pallas import relax as JR
from pde_multigrid_tpu_torch import Lyapunov2D
from pde_multigrid_tpu_torch import grid as TG
from pde_multigrid_tpu_torch.ops import split2d
from pde_multigrid_tpu_torch.ops.cuda import relax2d as R2

F32 = jnp.dtype("float32")
ULPS = 3
N = 129


@pytest.fixture(autouse=True)
def _no_launches():
    """CPU tensors never launch a kernel: every counter stays at zero."""
    R2.reset_launches()
    yield
    assert not any(R2.launches.values())


def _close(got, want):
    ulp = np.spacing(np.float32(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=ULPS * ulp)


def _geoms(pad):
    """JAX's padded 129^2 geometry (axis 0 padded to `pad`, lanes to 128)
    and the port's with the same rows (its columns unpadded)."""
    jg = JHierarchy.build(JLyapunov2D(), N, pad_axis0_to=pad,
                          pad_last_to=128).geoms[0]
    tg = TG.build_geometries((N, N), Lyapunov2D().domain,
                             pad_axis0_to=pad)[0]
    assert jg.padded_shape[0] == tg.padded_shape[0]
    return jg, tg


@pytest.mark.parametrize("pad,ranks", [(8, 1), (16, 2), (32, 4)])
@pytest.mark.parametrize("t,T", [(1, 1), (2, 2), (4, 4), (3, 4)],
                         ids=["t1", "t2", "t4", "rem3of4"])
def test_color_slab2d_shard_plain_matches_pallas(pad, ranks, t, T):
    """color_slab2d_shard_plain against the interpreted
    make_split_color_slab_2d_shard on shards 0, 1 and n - 1: the four
    ext halves random on all x_loc + round_up(2T, 8) rows (the halo JAX's
    engine sends, halo.py:176-178), g0 = i x_loc (the one-sided stencil
    has no low halo); t = T sweeps and a remainder chunk t < T on the T
    halo; the owned rows' logical slots within 3 ulp."""
    jg, tg = _geoms(pad)
    X = jg.padded_shape[0]
    x_loc = X // ranks
    assert x_loc % 8 == 0
    Y2p, Y2 = jg.padded_shape[1] // 2, split2d.half_width(tg)
    XE = x_loc + -(-2 * T // 8) * 8
    chunk = JR.make_split_color_slab_2d_shard(JLyapunov2D(), jg, F32, t, T,
                                              x_loc, interpret=True)
    assert chunk.halo_lo == 0 and chunk.XE == XE
    for i in sorted({0, 1, ranks - 1}):
        rng = np.random.default_rng(1000 * pad + 10 * t + T + i)
        ins = [rng.standard_normal((XE, Y2p)).astype(np.float32)
               for _ in range(4)]
        g0 = i * x_loc
        want = [np.asarray(a) for a in chunk(*map(jnp.asarray, ins), g0)]
        got = R2.color_slab2d_shard_plain(
            *(torch.tensor(a[:, :Y2]) for a in ins), g0, t, Lyapunov2D(), tg,
            x_loc)
        for g, w in zip(got, want):
            assert g.shape == (x_loc, Y2)
            _close(g.numpy(), w[:, :Y2])
        # the wrapper's other forms on CPU tensors (their plain path) on
        # the last shard, which reaches the level's last row: the one-rank
        # form without the ext rows, and on one rank the whole-leg form
        if i != ranks - 1:
            continue
        own = [torch.tensor(a[:x_loc, :Y2]) for a in ins]
        forms = {"one_rank": lambda o: R2.color_slab2d_shard(
            *own, g0, t, Lyapunov2D(), tg, x_loc, o, one_rank=True)}
        if ranks == 1:
            forms["leg"] = lambda o: R2.color_slab2d_leg(
                *own, t, Lyapunov2D(), tg, o)
        for name, form in forms.items():
            out = form(tuple(torch.empty(x_loc, Y2) for _ in range(2)))
            for g, w in zip(out, want):
                _close(g.numpy(), w[:, :Y2])


def _whole(n, pad, seed):
    """A port geometry of n^2 with its rows padded to a multiple of
    `pad`, and random float32 halves of v and f in the global colour
    convention (the split of dense arrays)."""
    g = TG.build_geometries((n, n), Lyapunov2D().domain,
                            pad_axis0_to=pad)[0]
    X = g.padded_shape[0]
    rng = np.random.default_rng(seed)
    v, f = (torch.tensor(rng.standard_normal((X, n)).astype(np.float32))
            for _ in range(2))
    return g, R2.split_colors_2d(v), R2.split_colors_2d(f)


@pytest.mark.parametrize("n,pad,x_loc", [(65, 1, 13), (65, 2, 33),
                                         (33, 4, 9), (129, 4, 33)])
@pytest.mark.parametrize("t", [1, 2, 3])
def test_shard_chunk_equals_whole_level_sweeps(n, pad, x_loc, t):
    """On every shard of a level (odd first rows among them: 13, 39, 33,
    9, 27, 99), the chunk on the global halves' rows [g0, g0 + x_loc + 2t)
    (taken modulo X, as the ring wraps) equals t sweeps of the whole-level
    half-sweeps (relax_halves2d, half_sweep2d_plain) on the owned rows,
    bit for bit; the wrapper on CPU tensors writes the same into its
    output halves."""
    g, (r, b), (fr, fb) = _whole(n, pad, 7 * n + pad + t)
    X = g.padded_shape[0]
    assert X % x_loc == 0
    wr, wb = r.clone(), b.clone()
    wr, wb = R2.relax_halves2d(wr, wb, fr, fb, t, Lyapunov2D(), g)
    for g0 in range(0, X, x_loc):
        idx = (g0 + torch.arange(x_loc + 2 * t)) % X
        ins = [a[idx] for a in (r, b, fr, fb)]
        got = R2.color_slab2d_shard_plain(*ins, g0, t, Lyapunov2D(), g,
                                          x_loc)
        assert torch.equal(got[0], wr[g0:g0 + x_loc]), g0
        assert torch.equal(got[1], wb[g0:g0 + x_loc]), g0
        out = tuple(torch.full((x_loc, r.shape[1]), float("nan"))
                    for _ in range(2))
        R2.color_slab2d_shard(*ins, g0, t, Lyapunov2D(), g, x_loc, out)
        assert all(torch.equal(o, w) for o, w in zip(out, got))


def _one_rank_chunked(r, b, fr, fb, ns, g, T=4):
    """The one-rank engine's chunked schedule before the one-rank form:
    chunks of T sweeps (and a remainder) on ext halves whose 2t halo rows
    are the level's first rows (the one-rank ring wraps), the owned rows
    kept between chunks."""
    X = g.padded_shape[0]
    for t in [T] * (ns // T) + [ns % T] * (ns % T > 0):
        idx = torch.arange(X + 2 * t) % X
        out = tuple(torch.empty_like(r) for _ in range(2))
        R2.color_slab2d_shard(*(a[idx] for a in (r, b, fr, fb)), 0, t,
                              Lyapunov2D(), g, X, out)
        r, b = out
    return r, b


@pytest.mark.parametrize("n", [9, 65, 129])
@pytest.mark.parametrize("ns", [1, 3, 7])
def test_one_rank_forms_equal_the_chunked_schedule(n, ns):
    """On a one-rank level (9^2: one CTA's leg; 65^2: a 9-CTA cluster's;
    129^2: a 15-CTA cluster's), a leg of ns sweeps by the one-rank form
    (rows past x_loc read as 0, no ext rows) in chunks of T = 4, and by
    the whole-leg form in one call, gives owned rows bitwise those of the
    chunked T = 4 schedule on ext halves with the ring's halo; the
    wrappers on CPU tensors (their plain path)."""
    g, (r, b), (fr, fb) = _whole(n, 1, 31 * n + ns)
    X = g.padded_shape[0]
    want = _one_rank_chunked(r, b, fr, fb, ns, g)
    cr, cb = r, b
    for t in [4] * (ns // 4) + [ns % 4] * (ns % 4 > 0):
        out = tuple(torch.empty_like(r) for _ in range(2))
        R2.color_slab2d_shard(cr, cb, fr, fb, 0, t, Lyapunov2D(), g, X, out,
                              one_rank=True)
        cr, cb = out
    leg = R2.color_slab2d_leg(r, b, fr, fb, ns, Lyapunov2D(), g,
                              tuple(torch.empty_like(r) for _ in range(2)))
    for got in ((cr, cb), leg):
        assert all(torch.equal(a, w) for a, w in zip(got, want))


@pytest.mark.parametrize("n,pad,want", [
    (65, 1, (16, 8, 9)), (65, 4, (16, 8, 9)), (9, 1, (9, 9, 1)),
    (129, 1, (17, 9, 15)),
    (129, 8, (17, 9, 16)), (257, 1, (25, 17, 16)), (257, 8, (25, 17, 16)),
    (513, 1, None), (4097, 1, None)])
def test_leg_layout(n, pad, want):
    """The whole-leg form's layout (RX, BX, nctas): bands of BX rows plus
    2 LEG_T halo rows on the largest cluster of at most LEG_MAX_CTAS = 16
    CTAs whose bands are at least 2 LEG_T rows and hold LEG_POINTS points
    (16 at 257^2 and at 129^2 on 136 rows, 15 at 129^2, 9 at 65^2), the
    rows spread evenly and every row owned once; one CTA where no cluster
    fits and the level's points fit kThreads x kLegPts = 4096 (9^2);
    513^2 and up do not fit on chip."""
    g = TG.build_geometries((n, n), Lyapunov2D().domain,
                            pad_axis0_to=pad)[0]
    lay = R2.leg_layout(g)
    assert lay == want
    if lay is None:
        return
    RX, BX, nctas = lay
    X, Y2 = g.padded_shape[0], split2d.half_width(g)
    assert RX * Y2 <= R2.LEG_POINTS and nctas <= R2.LEG_MAX_CTAS
    assert (nctas - 1) * BX < X <= nctas * BX
    assert RX == (X if nctas == 1 else BX + 2 * R2.LEG_T)


@pytest.mark.parametrize("x_loc,Y2,t,want", [
    (4097, 2049, 4, (64, 64, 56, 56, 1024)),
    (4097, 2049, 1, (62, 64, 60, 62, 1024)),
    (2049, 1025, 4, (58, 64, 50, 56, 1024)),
    (1025, 513, 4, (48, 64, 40, 56, 1024)),
    (513, 257, 4, (28, 64, 20, 56, 512)),
    (65, 33, 2, (12, 33, 8, 33, 512))])
def test_slab_tile(x_loc, Y2, t, want):
    """The chunk kernel's tiles and form (RX, RJ, BX, BJ, threads): 64
    slots (owned 64 - 2t) where a row is wider, else whole rows; at most
    SLAB_POINTS[threads] // RJ rows (owned RX - 2t), fewer where the
    level would leave the 132 CTAs of a wave idle (at least 8 owned), the
    tiles filling whole waves: 4097^2 at t = 4 2738 tiles (21 waves),
    2049^2 779 (6), 1025^2 260 (2), 513^2 130 (1); 1024-thread CTAs of 4
    points where 512-thread tiles of 10 take more than one wave."""
    got = R2.slab_tile(x_loc, Y2, t)
    assert got == want
    RX, RJ, BX, BJ, threads = got
    points = R2.SLAB_POINTS[threads]
    assert RX * RJ <= points and RX == BX + 2 * t
    # as many waves of 132 CTAs as the largest tiles would take
    ntj = -(-Y2 // BJ)
    widest = -(-x_loc // (points // RJ - 2 * t)) * ntj
    waves = -(-widest // R2.SLAB_CTAS)
    assert -(-(-(-x_loc // BX) * ntj) // R2.SLAB_CTAS) == waves


def test_rows_layout_is_the_level_layout():
    """split2d.rows_layout at g0 = 0 over the whole level is the cached
    level layout; at an odd g0 its colours, masks and coordinates are the
    level layout's rows from g0."""
    g = TG.build_geometries((65, 65), Lyapunov2D().domain,
                            pad_axis0_to=4)[0]
    whole = split2d.rows_layout(g, 0, g.padded_shape[0], torch.float32,
                                "cpu")
    part = split2d.rows_layout(g, 13, 20, torch.float32, "cpu")
    assert torch.equal(whole["q1"], split2d.q1_rows(g.padded_shape[0],
                                                    "cpu"))
    for key in ("masks", "y"):
        for w, p in zip(whole[key], part[key]):
            assert torch.equal(p, w[13:33])
    for w, p in zip(whole["coords"], part["coords"]):
        assert torch.equal(p[0], w[0][13:33]) and torch.equal(p[1],
                                                              w[1][13:33])


def test_wrapper_refusals():
    """The wrapper takes (XE, Y2) ext halves with XE >= x_loc + 2t and
    (x_loc, Y2) outputs apart from every input; anything else raises
    before any work.  Lyapunov only (on CUDA tensors; the plain version
    is the problem's own split form)."""
    g, (r, b), (fr, fb) = _whole(33, 4, 1)
    x_loc, t = 9, 2
    ins = [a[:x_loc + 2 * t].contiguous() for a in (r, b, fr, fb)]
    out = (torch.empty(x_loc, 17), torch.empty(x_loc, 17))
    prob = Lyapunov2D()
    with pytest.raises(ValueError, match="rows or more"):
        R2.color_slab2d_shard(*ins, 0, 3, prob, g, x_loc, out)
    with pytest.raises(ValueError, match="rows or more"):
        R2.color_slab2d_shard(*ins, 0, 0, prob, g, x_loc, out)
    with pytest.raises(ValueError, match="ext halves"):
        R2.color_slab2d_shard(ins[0][:, :16].contiguous(), *ins[1:], 0, t,
                              prob, g, x_loc, out)
    with pytest.raises(ValueError, match="output halves"):
        R2.color_slab2d_shard(*ins, 0, t, prob, g, x_loc,
                              (torch.empty(8, 17), out[1]))
    with pytest.raises(ValueError, match="overlap"):
        R2.color_slab2d_shard(*ins, 0, t, prob, g, x_loc,
                              (ins[0][:x_loc], out[1]))
    with pytest.raises(ValueError, match="overlap"):
        R2.color_slab2d_shard(*ins, 0, t, prob, g, x_loc, (out[0], out[0]))
    with pytest.raises(TypeError, match="float32"):
        R2.color_slab2d_shard(*(a.double() for a in ins), 0, t, prob, g,
                              x_loc, out)
    # the one-rank form only on a shard that reaches the level's last row
    with pytest.raises(ValueError, match="last row"):
        R2.color_slab2d_shard(*ins, 0, t, prob, g, x_loc, out, one_rank=True)
    # sweeps whose 2t halo leaves no owned row in a tile
    with pytest.raises(ValueError, match="tile"):
        R2.color_slab2d_shard(*ins, 27, 151, prob, g, x_loc, out,
                              one_rank=True)
    # the whole-leg form: whole halves of a level that fits on chip
    whole = (r, b, fr, fb)
    lo = tuple(torch.empty_like(r) for _ in range(2))
    with pytest.raises(ValueError, match="halves"):
        R2.color_slab2d_leg(*ins, 3, prob, g, lo)
    with pytest.raises(ValueError, match="sweeps"):
        R2.color_slab2d_leg(*whole, 0, prob, g, lo)
    with pytest.raises(ValueError, match="overlap"):
        R2.color_slab2d_leg(*whole, 3, prob, g, (r, lo[1]))
    g5, (r5, b5), (fr5, fb5) = _whole(513, 1, 2)
    with pytest.raises(ValueError, match="does not fit on chip"):
        R2.color_slab2d_leg(r5, b5, fr5, fb5, 1, prob, g5,
                            tuple(torch.empty_like(r5) for _ in range(2)))
