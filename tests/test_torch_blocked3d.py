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


# ------------------------------------- the kernel's plane-stream schedule


def _stream(hv, T_, prob, tg, lay):
    """csrc/blocked3d.cu's schedule at T = 2 .. 4 in plain PyTorch on
    whole halves: per CTA (z tile, j tile, band), the ring of 2T + 3 planes of r, b, fr, fb
    on the tile with its 2T halo (j and z through the wrapped tables, x
    planes from 2T before the band), plane k + 1 issued at step k and
    landing at its end, half-sweep h updating its colour in place on plane
    k - 1 - h over the points h + 1 or more from the tile's faces (planes
    h + 1 .. NP - 2 - h), and the planes whose last colour is done written
    out at the next step.  Every ring read checks that its slot holds the
    plane it wants and is not being loaded.  Returns (ro, bo, writes per
    point)."""
    r, b, fr, fb = hv
    X, Y2, Z = r.shape
    H, R_ = 2 * T_, 2 * T_ + 3
    BJ, BZ = lay.BJ, lay.BZ
    LJ, LZ = BJ + 2 * H, BZ + 2 * H
    outs = (torch.full_like(r, float("nan")), torch.full_like(b, float("nan")))
    hits = torch.zeros(2, X, Y2, Z, dtype=torch.int32)
    for tz in range(lay.tz):
        for tj in range(lay.tj):
            j0, z0 = tj * BJ, tz * BZ
            gj = torch.arange(j0 - H, j0 - H + LJ) % Y2
            gz = torch.arange(z0 - H, z0 - H + LZ) % Z
            for bd in range(lay.bands):
                x0 = bd * lay.B
                nown = min(lay.B, X - x0)
                NP = nown + 2 * H
                ring = {}
                flying = [None]

                def load(i):
                    gx = (x0 - H + i) % X
                    for a, arr in enumerate(hv):
                        ring[a, i % R_] = (i, arr[gx][gj][:, gz].clone())

                def get(a, i):
                    assert i % R_ != flying[0]
                    plane, t = ring[a, i % R_]
                    assert plane == i, (a, plane, i)
                    return t

                def store(a, i):
                    if not H <= i < H + nown:
                        return
                    nj, nz = min(BJ, Y2 - j0), min(BZ, Z - z0)
                    x = x0 + i - H
                    outs[a][x, j0:j0 + nj, z0:z0 + nz] = get(a, i)[
                        H:H + nj, H:H + nz]
                    hits[a, x, j0:j0 + nj, z0:z0 + nz] += 1

                load(0)
                for k in range(NP):
                    store(0, k - H)
                    store(1, k - 1 - H)
                    flying[0] = (k + 1) % R_ if k + 1 < NP else None
                    for h in range(H):
                        pl, color = k - 1 - h, h % 2
                        if not h + 1 <= pl <= NP - 2 - h:
                            continue
                        u = get(color, pl)
                        w = get(1 - color, pl)
                        wm, wp = get(1 - color, pl - 1), get(1 - color, pl + 1)
                        fu = get(2 + color, pl)
                        x = (x0 - H + pl) % X
                        sj, sz = slice(h + 1, LJ - 1 - h), slice(h + 1,
                                                                  LZ - 1 - h)
                        j, z = gj[sj][:, None], gz[sz][None, :]
                        q1 = (x + z) % 2 == 1
                        up = (color == 0) == q1  # red: j+1 where q = 1
                        jn = torch.where(up, w[h + 2:LJ - h, sz],
                                         w[h:LJ - 2 - h, sz])
                        p0 = wm[sj, sz] + wp[sj, sz]
                        p1 = w[sj, sz] + jn
                        p2 = w[sj, h:LZ - 2 - h] + w[sj, h + 2:LZ - h]
                        upd = prob.split_update((p0, p1, p2), fu[sj, sz], tg)
                        jz_ok = (j >= 1) | (q1 if color == 0 else ~q1)
                        m = ((x >= 1) & (z >= 1) & jz_ok).to(u.dtype)
                        old = u[sj, sz]
                        u[sj, sz] = old + m * (upd - old)
                    if k + 1 < NP:
                        flying[0] = None
                        load(k + 1)
                store(1, NP - 1 - H)
    return (*outs, hits)


def _stream1(hv, prob, tg, lay):
    """csrc/blocked3d.cu's T = 1 form in plain PyTorch on whole halves:
    per CTA (z tile, j tile, band), the planes from 2 before the band to 2
    after it one a step; at step k red on plane k - 1 over the points 1 or
    more from the tile's faces, from black's old planes k - 2 and k (a
    thread's registers) and black's plane k - 1 in the shared buffer
    (k - 1) % 2; then black on plane k - 2 over the owned points, from
    red's new planes k - 3 and k - 1 (registers) and red's plane k - 2 in
    the buffer (k - 2) % 2; plane k - 2 written out; black's plane k and
    red's plane k - 1 put into buffers k % 2 and (k - 1) % 2.  Every
    buffer read checks that it holds the plane it wants.  Returns (ro, bo,
    writes per point)."""
    r, b, fr, fb = hv
    X, Y2, Z = r.shape
    BJ, BZ = lay.BJ, lay.BZ
    LJ, LZ = BJ + 4, BZ + 4
    outs = (torch.full_like(r, float("nan")), torch.full_like(b, float("nan")))
    hits = torch.zeros(2, X, Y2, Z, dtype=torch.int32)
    for tz in range(lay.tz):
        for tj in range(lay.tj):
            j0, z0 = tj * BJ, tz * BZ
            gj = torch.arange(j0 - 2, j0 - 2 + LJ) % Y2
            gz = torch.arange(z0 - 2, z0 - 2 + LZ) % Z
            nj, nz = min(BJ, Y2 - j0), min(BZ, Z - z0)
            for bd in range(lay.bands):
                x0 = bd * lay.B
                NP = min(lay.B, X - x0) + 4

                def plane(arr, i):
                    return arr[(x0 - 2 + i) % X][gj][:, gz]

                def pairs(w, x, color, k0):
                    """The j and z pair sums of w's tile over the points
                    k0 or more from the faces, and their j, z, odd x + z."""
                    sj, sz = slice(k0, LJ - k0), slice(k0, LZ - k0)
                    j, z = gj[sj][:, None], gz[sz][None, :]
                    q1 = (x + z) % 2 == 1
                    up = (color == 0) == q1
                    jn = torch.where(up, w[k0 + 1:LJ - k0 + 1, sz],
                                     w[k0 - 1:LJ - k0 - 1, sz])
                    p1 = w[sj, sz] + jn
                    p2 = w[sj, k0 - 1:LZ - k0 - 1] + w[sj, k0 + 1:LZ - k0 + 1]
                    return sj, sz, q1, j, z, p1, p2

                sb, sr, rn = {}, {}, {}
                for k in range(NP):
                    rnew = plane(r, k - 1).clone()
                    if 1 <= k - 1 <= NP - 2:  # red on plane k - 1
                        assert sb[(k - 1) % 2][0] == k - 1
                        w = sb[(k - 1) % 2][1]
                        x = (x0 + k - 3) % X
                        sj, sz, q1, j, z, p1, p2 = pairs(w, x, 0, 1)
                        p0 = (plane(b, k - 2) + plane(b, k))[sj, sz]
                        upd = prob.split_update(
                            (p0, p1, p2), plane(fr, k - 1)[sj, sz], tg)
                        m = ((x >= 1) & (z >= 1) & ((j >= 1) | q1)).to(
                            r.dtype)
                        old = rnew[sj, sz]
                        rnew[sj, sz] = old + m * (upd - old)
                    if 2 <= k - 2 <= NP - 3:  # black on plane k - 2
                        assert sr[(k - 2) % 2][0] == k - 2
                        w = sr[(k - 2) % 2][1]
                        x = (x0 + k - 4) % X
                        sj, sz, q1, j, z, p1, p2 = pairs(w, x, 1, 2)
                        p0 = (rn[k - 3] + rnew)[sj, sz]
                        upd = prob.split_update(
                            (p0, p1, p2), plane(fb, k - 2)[sj, sz], tg)
                        m = ((x >= 1) & (z >= 1) & ((j >= 1) | ~q1)).to(
                            r.dtype)
                        old = plane(b, k - 2)[sj, sz]
                        bnew = old + m * (upd - old)
                        xo = x0 + k - 4
                        outs[1][xo, j0:j0 + nj, z0:z0 + nz] = bnew[:nj, :nz]
                        outs[0][xo, j0:j0 + nj, z0:z0 + nz] = rn[k - 2][
                            2:2 + nj, 2:2 + nz]
                        hits[:, xo, j0:j0 + nj, z0:z0 + nz] += 1
                    sb[k % 2] = (k, plane(b, k))
                    sr[(k - 1) % 2] = (k - 1, rnew)
                    rn[k - 1] = rnew
    return (*outs, hits)


def _small_tile_layout(X, Y2, Z, T_, BJ, BZ, B):
    """A Blocked3DLayout with another tile and band than the kernel's
    (for the schedule alone: the kernel takes TILE[T] only)."""
    tj, tz, bands = -(-Y2 // BJ), -(-Z // BZ), -(-X // B)
    return BL.Blocked3DLayout(X, Y2, Z, T_, BJ, BZ, B, tj, tz, bands,
                              BL.THREADS, 0)


@pytest.mark.parametrize("shape,tile", [
    ((9, 9, 9), None),       # halves (8, 4, 8): the tile wraps, a plane a band
    ((11, 13, 15), None),    # (10, 6, 14): odd extents
    ((33, 33, 33), None),    # (32, 16, 32)
    ((33, 33, 33), (4, 8, 5)),  # 4 x 4 tiles, 7 bands, the last of 2
    ((17, 21, 27), (4, 8, 3)),  # (16, 10, 26): partial tiles in j and z
])
@pytest.mark.parametrize("T_", [1, 2, 3, 4])
def test_plane_stream_schedule_is_row9_chain_bitwise(shape, tile, T_):
    """The kernel's schedule (`_stream1` at T = 1, `_stream` above, in the
    layout `blocked3d.layout` gives, or with a smaller tile and band)
    equals row 9's plain
    half-sweep chain over T sweeps bit for bit, each owned point of each
    colour written once."""
    tg = TG.build_geometries(shape, DOM, 1, wrap=True)
    rng = np.random.default_rng(2200 + T_)
    ps = tg[0].padded_shape
    v = (rng.standard_normal(ps) * TG.wrap_interior(ps)).astype(np.float32)
    f = rng.standard_normal(ps).astype(np.float32)
    hv = _halves(v, f)
    lay = (BL.layout(*hv[0].shape, T_) if tile is None
           else _small_tile_layout(*hv[0].shape, T_, *tile))
    if T_ == 1:
        ro, bo, hits = _stream1(hv, TPoisson(3), tg[0], lay)
    else:
        ro, bo, hits = _stream(hv, T_, TPoisson(3), tg[0], lay)
    want = R.relax_halves_plain(hv[0].clone(), hv[1].clone(), *hv[2:], T_,
                                TPoisson(3), tg[0])
    assert bool((hits == 1).all())
    assert torch.equal(ro, want[0]) and torch.equal(bo, want[1])


def test_layout_of_the_planned_levels():
    """256^3 and 512^3 halves: T's tile, the bands filling 132 SMs in one
    wave (two CTAs an SM at T <= 2), the shared memory the kernel
    computes (the ring of 2T + 3 planes of four arrays and the tables)
    within 227 KB, twice within an SM's 228 KB at T <= 2."""
    want = {(256, 1): (8, 4, 8, 32), (512, 1): (16, 8, 2, 256),
            (256, 2): (8, 8, 4, 64), (256, 4): (16, 8, 1, 256)}
    for (n, T_), (tj, tz, bands, B) in want.items():
        lay = BL.layout(n, n // 2, n, T_)
        assert (lay.BJ, lay.BZ) == BL.TILE[T_]
        assert (lay.tj, lay.tz, lay.bands, lay.B) == (tj, tz, bands, B)
        assert tj * tz * bands <= BL.NUM_SMS * BL.CTAS_PER_SM[T_]
        LJ, LZ = lay.BJ + 4 * T_, lay.BZ + 4 * T_
        assert lay.smem_bytes == (16 * LJ * LZ if T_ == 1 else 16 * (
            2 * T_ + 3) * LJ * LZ + 4 * (LJ + LZ))
        assert lay.smem_bytes * BL.CTAS_PER_SM[T_] <= 228 * 1024 - 2048
    with pytest.raises(ValueError, match="no layout"):
        BL.layout(8, 4, 8, 5)


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
