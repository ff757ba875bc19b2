"""Port parity of the reduced-system (black-only) 2D kernel,
`ops/cuda/reduced2d.py` (row 18), against the JAX package: its plain
version (what the wrapper runs for CPU tensors) against
`make_split_reduced_slab_2d` in interpret mode and, in float64, against
the jnp tier's dense red-black sweeps; the chunk length T against JAX's
block ladder; the plan with the opt-in on and off against JAX's
`plan_relax` / `plan_split2d_raw`; a Lyapunov FMG slice through the CUDA
tier's plan against JAX's interpreted Pallas solve with the opt-in on;
and the wrapper's refusals.

The kernel itself builds and runs only on a GPU; `chip_smoke.py` holds it
against this plain version there, bit for bit, and against row 16's
half-sweep chain within JAX's test tolerance.

Tolerances, and why:
  * plain vs the interpreted Pallas kernel (float32): 2 ulp of the
    largest value.  Both evaluate the same products in the same order;
    XLA's CPU backend contracts a product into the following sum (one
    rounding fewer) and nothing else differs;
  * float64 vs the jnp tier's `relax_rbgs`: 1e-12 relative (the chunk
    reassociates the two half-sweeps' products: an ulp of float64 a
    sweep);
  * float32 vs the port's row-16 chain: JAX's own test tolerance of the
    kernel against dense sweeps, rtol 2e-5 / atol 2e-6
    (tests/test_pallas.py:791-815);
  * the FMG slice: the logical solution within 1e-5 of max|v| and
    error_linf to 1e-4 relative (the same reduced arithmetic on both
    sides; the converters and the float32 dense coarse solve sum in
    other orders).
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pde_multigrid_tpu as J
from pde_multigrid_tpu import grid as JG
from pde_multigrid_tpu.ops import stencil as JST
from pde_multigrid_tpu.ops.pallas import relax as JR
import pde_multigrid_tpu_torch as T
from pde_multigrid_tpu_torch import grid as TG
from pde_multigrid_tpu_torch.cycles import CycleProgram
from pde_multigrid_tpu_torch.ops import split2d as TS
from pde_multigrid_tpu_torch.ops.cuda import dispatch as D
from pde_multigrid_tpu_torch.ops.cuda import reduced2d as RD
from pde_multigrid_tpu_torch.ops.cuda import relax2d as R2

F32 = jnp.dtype("float32")
DOM = ((0.0, 1.0), (0.0, 1.0))
JAX_PAD = dict(pad_last_to=128, pad_sublane_to=8)  # the Pallas tier's


@pytest.fixture(autouse=True)
def _no_launches():
    """CPU tensors never launch a kernel: every counter stays at zero."""
    RD.reset_launches()
    R2.reset_launches()
    yield
    assert not any(RD.launches.values()) and not any(R2.launches.values())


def _level(n, seed, dtype=np.float32):
    """JAX's padded geometry and level, the port's geometry, and (v, f) on
    the padded shape: random on the logical region, zero in the padding."""
    jh = JG.Hierarchy.build(J.Lyapunov2D(), n, dtype=jnp.dtype(dtype),
                            **JAX_PAD)
    tg = TG.build_geometries((n, n), DOM, 1)[0]
    rng = np.random.default_rng(seed)
    v = np.zeros(jh.geoms[0].padded_shape, dtype)
    f = np.zeros_like(v)
    v[:n, :n] = rng.standard_normal((n, n))
    f[:n, :n] = rng.standard_normal((n, n))
    return jh, tg, v, f


def _port(v, f, n, ns, T_, tg, f_zero=False, dtype=torch.float32):
    """One leg of `ns` sweeps in chunks of T_ through the wrapper on CPU
    tensors (split, chunks, merge): the logical dense result."""
    vt = torch.tensor(v[:n, :n], dtype=dtype)
    ft = None if f_zero else torch.tensor(f[:n, :n], dtype=dtype)
    if dtype == torch.float32:
        return RD.reduced_relax(vt, ft, ns, T_, T.Lyapunov2D(), tg,
                                f_zero).numpy()
    # float64: the wrapper takes float32 only; the plain version any dtype
    r, b = R2.split_colors_2d(vt)
    fr, fb = (None, None) if f_zero else R2.split_colors_2d(ft)
    n_full, rem = divmod(ns, T_)
    for t in [T_] * n_full + [rem] * (rem > 0):
        r, b = RD.reduced_slab2d_plain(r, b, fr, fb, t, T.Lyapunov2D(), tg)
    return R2.merge_colors_2d(r, b, n).numpy()


def _close_ulps(got, want, ulps=2):
    ulp = np.spacing(np.float32(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=ulps * ulp)


# ------------------------------------------------ the interpreted kernel


@pytest.fixture(scope="module")
def level33():
    return _level(33, seed=1833)


@pytest.mark.parametrize("B,T_", [(8, 1), (8, 2), (16, 4)])
def test_plain_matches_pallas_reduced(level33, B, T_):
    """The plain version against make_split_reduced_slab_2d(interpret) at
    33^2 (odd Y: the inert slot; X not a multiple of 8), nu = 1, 2, 5
    (a chunk alone, chunks, chunks with a remainder), with f."""
    jh, tg, v, f = level33
    fn = JR.make_split_reduced_slab_2d(J.Lyapunov2D(), jh.geoms[0], F32, B,
                                       sweeps_per_call=T_, interpret=True)
    for ns in (1, 2, 5):
        want = np.asarray(fn(jnp.asarray(v), jnp.asarray(f), ns))[:33, :33]
        _close_ulps(_port(v, f, 33, ns, T_, tg), want)


@pytest.mark.parametrize("n,B,T_", [(33, 8, 2), (65, 16, 4)])
def test_plain_matches_pallas_reduced_f_zero(n, B, T_):
    """The f-less chunk (RHS terms dropped from Cf and the red rebuild)
    against the interpreted kernel's f_zero path, nu = 1 and 5; at 65^2
    also with f."""
    jh, tg, v, f = _level(n, seed=n + T_)
    fn = JR.make_split_reduced_slab_2d(J.Lyapunov2D(), jh.geoms[0], F32, B,
                                       sweeps_per_call=T_, interpret=True)
    assert fn.supports_f_zero
    for ns in (1, 5):
        want = np.asarray(fn(jnp.asarray(v), jnp.asarray(f), ns,
                             f_zero=True))[:n, :n]
        _close_ulps(_port(v, f, n, ns, T_, tg, f_zero=True), want)
    if n == 65:
        want = np.asarray(fn(jnp.asarray(v), jnp.asarray(f), 5))[:n, :n]
        _close_ulps(_port(v, f, n, 5, T_, tg), want)


# ------------------------------------- dense sweeps: float64 and row 16


@pytest.mark.parametrize("f_zero", [False, True])
def test_plain_matches_relax_rbgs_float64(f_zero):
    """In float64 a chunk of T sweeps equals T dense masked red-black
    sweeps of the jnp tier (relax_rbgs), to 1e-12 relative, at T = 1, 3
    and 4 over 7 sweeps."""
    n = 33
    jh, tg, v, f = _level(n, seed=64 + f_zero, dtype=np.float64)
    lvl, g = jh.levels[0], jh.geoms[0]
    prob = J.Lyapunov2D()
    ff = np.zeros_like(f) if f_zero else f
    want = np.asarray(JST.relax_rbgs(
        lambda vv, fv: prob.relax_update(vv, fv, g, lvl.aux),
        jnp.asarray(v), jnp.asarray(ff), lvl.aux["m_red"],
        lvl.aux["m_black"], 7))[:n, :n]
    for T_ in (1, 3, 4):
        got = _port(v, f, n, 7, T_, tg, f_zero, dtype=torch.float64)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("T_", [1, 3, 8])
def test_chunk_within_jax_tolerance_of_row16(T_):
    """A chunk against row 16's half-sweep chain (relax_halves2d's plain
    path) over the same sweeps, on halves of 65^2, with and without f:
    within rtol 2e-5 / atol 2e-6."""
    n = 65
    _, tg, v, f = _level(n, seed=80 + T_)
    prob = T.Lyapunov2D()
    r, b = R2.split_colors_2d(torch.tensor(v[:n, :n]))
    fr, fb = R2.split_colors_2d(torch.tensor(f[:n, :n]))
    for hf in ((fr, fb), (None, None)):
        out = (torch.empty_like(r), torch.empty_like(b))
        RD.reduced_chunk(r, b, *hf, T_, prob, tg, out)
        cr, cb = r.clone(), b.clone()
        cr, cb = R2.relax_halves2d(cr, cb, *hf, T_, prob, tg)
        for got, want in zip(out, (cr, cb)):
            np.testing.assert_allclose(got.numpy(), want.numpy(),
                                       rtol=2e-5, atol=2e-6)


def test_masked_points_held_and_inert_slot():
    """Boundary and inert slots come out bitwise as they went in (the mask
    fold m*upd + (1 - m)*v0), and every interior point changes."""
    n = 17
    _, tg, v, f = _level(n, seed=5)
    prob = T.Lyapunov2D()
    r, b = R2.split_colors_2d(torch.tensor(v[:n, :n]))
    fr, fb = R2.split_colors_2d(torch.tensor(f[:n, :n]))
    r2, b2 = RD.reduced_slab2d_plain(r, b, fr, fb, 3, prob, tg)
    m_r, m_b = (m > 0 for m in TS.interior_masks_halves(tg, torch.float32))
    assert torch.equal(r2[~m_r], r[~m_r]) and torch.equal(b2[~m_b], b[~m_b])
    assert bool((r2[m_r] != r[m_r]).all()) and bool(
        (b2[m_b] != b[m_b]).all())


# -------------------------------------------- the kernel's tile schedule

_FIELDS = ("c_xx", "c_xy", "c_yy", "c_f", "m_b", "c_bk", "r_e", "r_s",
           "r_f", "m_r", "c_rk")


def _tiles(r, b, fr, fb, T_, prob, tg, lay):
    """csrc/reduced2d.cu's schedule in plain PyTorch on whole halves: per
    tile, the LX x 64 region from its first owned row and slot (zero past X
    and Y2), every point's fields (`reduced_fields` there, 0 past the
    level), sweep s (from 0) on the rows < LX - 2(s+1) and slots < 64 -
    (s+1) into a buffer holding NaN elsewhere (so a read of anything the
    kernel does not write shows), the last on the owned points with their
    red.  Returns (ro, bo, writes per point)."""
    fd = RD.reduced_fields(r, b, fr, fb, prob, tg)
    X, Y2 = r.shape
    LX, LJ = lay.threads // 32 * lay.IX, RD.REGION_J
    ro = torch.full_like(r, float("nan"))
    bo = torch.full_like(b, float("nan"))
    hits = torch.zeros(X, Y2, dtype=torch.int32)

    def region(a, x0, j0):
        out = torch.zeros(LX, LJ, dtype=a.dtype)
        ex, ej = max(0, min(LX, X - x0)), max(0, min(LJ, Y2 - j0))
        out[:ex, :ej] = a[x0:x0 + ex, j0:j0 + ej]
        return out

    for tx in range(lay.tx):
        for tj in range(lay.tj):
            x0, j0 = tx * lay.BX, tj * lay.BJ
            f = {k: None if fd[k] is None else region(fd[k], x0, j0)
                 for k in _FIELDS}
            q1 = ((x0 + torch.arange(LX)) % 2 == 1)[:, None]

            def update(cur, nx, nj):
                """The fields on the first nx rows and nj slots, and the
                black update there from cur."""
                fl = {k: None if v is None else v[:nx, :nj]
                      for k, v in f.items()}
                bxy = torch.where(q1[:nx], cur[1:nx + 1, :nj],
                                  cur[1:nx + 1, 1:nj + 1])
                return fl, RD.black_update(fl, cur[2:nx + 2, :nj], bxy,
                                           cur[:nx, 1:nj + 1])

            cur = region(b, x0, j0)
            for s_ in range(T_ - 1):
                nx, nj = LX - 2 * (s_ + 1), LJ - (s_ + 1)
                nxt = torch.full_like(cur, float("nan"))
                nxt[:nx, :nj] = update(cur, nx, nj)[1]
                cur = nxt
            ox, oj = min(lay.BX, X - x0), min(lay.BJ, Y2 - j0)
            fl, nb = update(cur, ox, oj)
            bo[x0:x0 + ox, j0:j0 + oj] = nb
            bS = torch.where(q1[:ox], cur[:ox, 1:oj + 1], cur[:ox, :oj])
            ro[x0:x0 + ox, j0:j0 + oj] = RD.red_rebuild(
                fl, cur[1:ox + 1, :oj], bS)
            hits[x0:x0 + ox, j0:j0 + oj] += 1
    return ro, bo, hits


@pytest.mark.parametrize("n,form", [(129, None), (65, None),
                                    (129, (16, 3)), (129, (32, 2))])
@pytest.mark.parametrize("T_", [1, 7, 8, 9, 15, 16])
def test_tile_schedule_is_plain_bitwise(n, form, T_):
    """The kernel's schedule (`_tiles`, in the layout `reduced2d.layout`
    gives, or in another of the kernel's forms) equals
    reduced_slab2d_plain bit for bit, with f and f-less, at 1, T - 1, T,
    T + 1 around both T of the 4097^2 plan (8 and 16), on levels cut into
    several tiles (the last row and column of tiles partial, the halo past
    the level's last row and slot), every owned point written once and no
    sweep reading a point no sweep wrote."""
    _, tg, v, f = _level(n, seed=2100 + n + T_)
    prob = T.Lyapunov2D()
    r, b = R2.split_colors_2d(torch.tensor(v[:n, :n]))
    fr, fb = R2.split_colors_2d(torch.tensor(f[:n, :n]))
    lay = (RD.layout(*r.shape, T_) if form is None
           else RD.make_layout(*r.shape, T_, *form))
    assert lay.tj * lay.tx > 1 or n == 65  # 65^2: one tile past the level
    for hf in ((fr, fb), (None, None)):
        ro, bo, hits = _tiles(r, b, *hf, T_, prob, tg, lay)
        want = RD.reduced_slab2d_plain(r, b, *hf, T_, prob, tg)
        assert bool((hits == 1).all())
        assert torch.equal(ro, want[0]) and torch.equal(bo, want[1])


def test_layout_of_the_planned_levels():
    """The 4097^2 plan's layouts: 16 warps on a 48-row region at the legs'
    remainder T = 4, 32 warps on 96 rows at T = 8 and on 64 rows at T =
    16, by 64 slots; the owned tile LX - 2T by 64 - T; tiles covering the
    level; the shared memory the kernel computes, within 227 KB, twice
    within an SM's 228 KB for the 48-row region."""
    want = {(4097, 2049, 8): (1024, 3, 80, 56, 37, 52),
            (2049, 1025, 8): (1024, 3, 80, 56, 19, 26),
            (1025, 513, 16): (1024, 2, 32, 48, 11, 33),
            (513, 257, 16): (1024, 2, 32, 48, 6, 17),
            (4097, 2049, 4): (512, 3, 40, 60, 35, 103)}
    for (X, Y2, T_), (threads, IX, BX, BJ, tj, tx) in want.items():
        lay = RD.layout(X, Y2, T_)
        assert (lay.threads, lay.IX, lay.BX, lay.BJ, lay.tj, lay.tx) == (
            threads, IX, BX, BJ, tj, tx)
        assert (tj - 1) * BJ < Y2 <= tj * BJ and (tx - 1) * BX < X <= tx * BX
        LX = threads // 32 * IX
        assert BX == LX - 2 * T_
        assert lay.smem_bytes == RD.smem_bytes(LX) <= 227 * 1024
    assert 2 * (RD.smem_bytes(48) + 1024) <= 228 * 1024
    for T_ in range(1, RD.MAX_T + 1):
        lay = RD.layout(4097, 2049, T_)
        assert lay.BX >= 32 and lay.BJ == 64 - T_
        assert (lay.threads // 32, lay.IX) in ((16, 3), (32, 3), (32, 2))
    with pytest.raises(ValueError, match="no layout"):
        RD.layout(65, 33, 17)


# ------------------------------------------------------------------ plan


def _jax_4097():
    return JG.build_geometries((4097, 4097), DOM, 8, **JAX_PAD)


def test_chunk_sweeps_is_jax_ladder():
    """T of each split level of the 4097^2 hierarchy from JAX's
    split2d_plan on its padded shape (one-sided offsets, the interior rows
    covered): 8 at 4097^2 and 2049^2, 16 at 1025^2 and 513^2."""
    tgs = TG.build_geometries((4097, 4097), DOM, 8)
    want = []
    for jg, tg in zip(_jax_4097()[:4], tgs[:4]):
        plan = JR.split2d_plan(jg.padded_shape, (1,),
                               x_cover=jg.shape[0] - 1)
        want.append(plan[1])
        assert RD.chunk_sweeps(tg) == plan[1]
    assert want == [8, 8, 16, 16]


_JAX_2D = {
    "make_split_reduced_slab_2d": "reduced",
    "make_split_color_slab_2d": "split",
    "make_resident_relax": "resident",
}


@pytest.mark.parametrize("reduced", [False, True])
def test_plan_pins_match_jax(monkeypatch, reduced):
    """With the opt-in off and on, every relaxed level of the 4097^2
    hierarchy takes the tier JAX's plan_relax gives it (reduced, color
    split, resident), with JAX's T on the reduced levels, and the
    persistent halves exactly where plan_split2d_raw plans them."""
    monkeypatch.setattr(JR, "SPLIT2D_REDUCED", reduced)
    monkeypatch.setattr(D, "SPLIT2D_REDUCED", reduced)
    jgs = _jax_4097()
    tgs = TG.build_geometries((4097, 4097), DOM, 8)
    k = D.CudaKernels(T.Lyapunov2D(), tgs, torch.float32, range(7))
    want, persist = [], []
    for jg in jgs[:7]:
        fn = JR.plan_relax(J.Lyapunov2D(), jg, F32, interpret=True)
        want.append(_JAX_2D[fn.__qualname__.split(".")[0]])
        persist.append(JR.plan_split2d_raw(J.Lyapunov2D(), jg, F32,
                                           interpret=True) is not None)
    got = ["reduced" if t else "split" if s else "resident"
           for t, s in zip(k._reduced_t[:7], k._split[:7])]
    assert got == want
    assert k._split[:7] == persist
    assert want[:4] == (["reduced"] if reduced else ["split"]) * 4
    assert k._reduced_t == ([8, 8, 16, 16] if reduced else [None] * 4) + [
        None] * 4


def test_opt_in_leaves_hjb_untouched(monkeypatch):
    """Only a problem naming reduced2d_fields with one-sided offsets is
    eligible (relax.py:4052-4056): with the opt-in on, the HJB 513^2 plan
    is the one without it, in both packages."""
    tgs = TG.build_geometries((513, 513), ((-1.0, 1.0),) * 2, 4)
    plans = []
    for on in (False, True):
        monkeypatch.setattr(D, "SPLIT2D_REDUCED", on)
        monkeypatch.setattr(JR, "SPLIT2D_REDUCED", on)
        k = D.CudaKernels(T.HJBMinTime(), tgs, torch.float32, range(3))
        assert k._reduced_t == [None] * 4
        jg = JG.build_geometries((513, 513), ((-1.0, 1.0),) * 2, 4,
                                 **JAX_PAD)[0]
        fn = JR.plan_relax(J.HJBMinTime(), jg, F32, interpret=True)
        plans.append(([getattr(f, "__func__", f) for f in k._relax],
                      fn.__qualname__.split(".")[0]))
    assert plans[0] == plans[1]


def test_switch_read_at_import():
    """dispatch.SPLIT2D_REDUCED is PDE_MG_SPLIT2D_REDUCED == "1", read at
    import as JAX reads it (relax.py:3756-3758), default off."""
    code = ("from pde_multigrid_tpu_torch.ops.cuda import dispatch;"
            "print(dispatch.SPLIT2D_REDUCED)")
    outs = []
    for val in (None, "1"):
        env = {k: x for k, x in os.environ.items()
               if k != "PDE_MG_SPLIT2D_REDUCED"}
        if val is not None:
            env["PDE_MG_SPLIT2D_REDUCED"] = val
        outs.append(subprocess.run([sys.executable, "-c", code], env=env,
                                   capture_output=True, text=True,
                                   check=True).stdout.strip())
    assert outs == ["False", "True"]


# ----------------------------------------------------------------- slice


def test_fmg_slice_matches_jax_pallas(monkeypatch):
    """Lyapunov FMG(1, 2, 2) at 65^2 with the exact coarsest level (33^2)
    and the opt-in on, the split gate lowered so that 65^2 is a reduced
    level: the CUDA tier's plan on CPU tensors (row 18's plain version,
    the split2d / merge2d plain versions per leg) against JAX's Pallas
    tier in interpret mode (make_split_reduced_slab_2d on 65^2: its
    resident budget lowered below the level, as its split gate is)."""
    monkeypatch.setattr(D, "SPLIT2D_MIN_Y2", 16)
    monkeypatch.setattr(D, "SPLIT2D_REDUCED", True)
    monkeypatch.setattr(JR, "SPLIT2D_MIN_Y2", 16)
    monkeypatch.setattr(JR, "SPLIT2D_REDUCED", True)
    monkeypatch.setattr(JR, "RESIDENT_VMEM_BUDGET", 0)
    cyc = dict(kind="fmg", nu0=1, nu1=2, nu2=2, coarsest="exact")
    js = J.MultigridSolver(J.Lyapunov2D(), 65, J.SolverConfig(
        cycle=J.CycleConfig(**cyc), backend="pallas", **JAX_PAD))
    planned = [fn.__qualname__.split(".")[0] if fn else None
               for fn in js.program.kernels._relax_fns]
    assert planned[0] == "make_split_reduced_slab_2d"
    ts = T.MultigridSolver(T.Lyapunov2D(), 65, T.SolverConfig(
        cycle=T.CycleConfig(**cyc)), device="cpu")
    assert [g.shape for g in ts.geoms] == [g.shape for g in js.geoms]
    k = D.CudaKernels(ts.problem, ts.geoms, torch.float32,
                      range(len(ts.geoms) - 1))
    assert k._reduced_t[0] == RD.chunk_sweeps(ts.geoms[0])
    ts.program = CycleProgram(ts.problem, ts.geoms, ts.config.cycle, k)
    calls = []
    plain = RD.reduced_slab2d_plain

    def counted(*args, **kw):
        calls.append(args[4])
        return plain(*args, **kw)

    monkeypatch.setattr(RD, "reduced_slab2d_plain", counted)
    jr, tr = js.solve(), ts.solve()
    assert calls == [2] * 2  # one chunk of 2 per leg, two legs on 65^2
    a = TG.to_logical(np.asarray(jr.v), js.geoms[0])
    b = TG.to_logical(tr.v, ts.geoms[0])
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-5 * np.abs(a).max())
    np.testing.assert_allclose(tr.error_linf, jr.error_linf, rtol=1e-4)


# -------------------------------------------------------------- refusals


def test_wrapper_refuses_what_the_kernel_does_not_take():
    n = 17
    _, tg, v, f = _level(n, seed=9)
    prob = T.Lyapunov2D()
    r, b = R2.split_colors_2d(torch.tensor(v[:n, :n]))
    fr, fb = R2.split_colors_2d(torch.tensor(f[:n, :n]))
    out = (torch.empty_like(r), torch.empty_like(b))
    for bad_t in (0, RD.MAX_T + 1):
        with pytest.raises(ValueError, match="sweeps"):
            RD.reduced_chunk(r, b, fr, fb, bad_t, prob, tg, out)
    with pytest.raises(ValueError, match="both RHS halves"):
        RD.reduced_chunk(r, b, fr, None, 2, prob, tg, out)
    with pytest.raises(ValueError, match="overlap"):
        RD.reduced_chunk(r, b, fr, fb, 2, prob, tg, (r, out[1]))
    with pytest.raises(ValueError, match="overlap"):
        RD.reduced_chunk(r, b, fr, fb, 2, prob, tg, (out[0], out[0]))
    with pytest.raises(ValueError):
        RD.reduced_chunk(r[:, :4], b, fr, fb, 2, prob, tg, out)
    with pytest.raises(TypeError, match="float32"):
        RD.reduced_chunk(r.double(), b.double(), None, None, 2, prob, tg,
                         tuple(o.double() for o in out))
    rt = torch.empty(r.shape[1], r.shape[0]).t()
    with pytest.raises(ValueError, match="contiguous"):
        RD.reduced_chunk(rt, b, None, None, 2, prob, tg, out)
    with pytest.raises(ValueError, match="no kernel for device"):
        RD.reduced_chunk(*(torch.empty(r.shape, device="meta")
                           for _ in range(2)), None, None, 2, prob, tg,
                         tuple(torch.empty(r.shape, device="meta")
                               for _ in range(2)))
    with pytest.raises(TypeError, match="one-sided"):
        RD.reduced_chunk(r, b, None, None, 2, T.HJBMinTime(), tg, out)
