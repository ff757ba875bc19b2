"""Reduced-system (black-only) red-black Gauss-Seidel on padded 2D Lyapunov
levels: the CUDA kernel of `csrc/reduced2d.cu` and its plain PyTorch
version.

Replaces the TPU kernel `pde_multigrid_tpu/ops/pallas/relax.py`
`make_split_reduced_slab_2d`, which the JAX package runs only under
`PDE_MG_SPLIT2D_REDUCED=1` (`ops/cuda/dispatch.SPLIT2D_REDUCED` here).
For the one-sided Lyapunov stencil red-black Gauss-Seidel is bipartite:
one red+black sweep collapses into a 3-term update of black,

    b <- Cxx B[x+2, j] + Cxy B[x+1, j+1-q] + Cyy B[x, j+1] + Cf,

with sweep-invariant fields built once per chunk of T sweeps, and red is
rebuilt once per chunk from the black state one sweep before the last.
The chunk length therefore changes the rounding: T is JAX's, from its
block ladder (`chunk_sweeps`).  Halves layout: that of
`ops/cuda/relax2d.py` (`ops/split2d.py`), (X, ceil(Y/2)) each.

Each wrapper launches its kernel for CUDA tensors, runs the plain version
for CPU tensors, and raises for anything else; there is no fallback from
a CUDA tensor to the plain version.  `launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from pde_multigrid_tpu_torch.grid import LevelGeometry
from pde_multigrid_tpu_torch.ops.cuda import build
from pde_multigrid_tpu_torch.ops.cuda import relax2d as R2
from pde_multigrid_tpu_torch.ops.cuda.relax import _on_cuda, _stream

launches = {"reduced2d": 0}

# the most sweeps one launch takes (csrc/reduced2d.cu's kMaxT: the halo
# of 2T rows and T slots grows with T; at 16 a 64 x 64 region owns 32 x 48)
MAX_T = 16

# the kernel's region's slots (csrc/reduced2d.cu's kLJ): a warp's 32
# threads hold two slots each
REGION_J = 64

# JAX's block ladder at its defaults (relax.py:3727, 3744, 3773): its VMEM
# budget, first T and window cap decide T, which sets where red is rebuilt
SLAB_VMEM_BUDGET = 12 * 2**20
SPLIT2D_T = 16
SPLIT2D_MAX_WINDOW = 680 * 1024


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


class Reduced2DLayout(ctypes.Structure):
    """The kernel's `Reduced2DLayout` (csrc/reduced2d.cu): the level's
    halves (X, Y2), the chunk's T, a thread's rows of points IX (the
    region's rows LX = IX threads / 32), the owned tile BX x BJ, the tiles
    along the slots and the rows, threads a CTA and shared memory
    bytes."""

    _fields_ = [(name, ctypes.c_int)
                for name in ("X", "Y2", "T", "IX", "BX", "BJ", "tj", "tx",
                             "threads", "smem_bytes")]

    def as_dict(self) -> dict:
        return {name: getattr(self, name) for name, _ in self._fields_}


def smem_bytes(LX: int) -> int:
    """csrc/reduced2d.cu's smem_floats, in bytes, for an LX-row region: r
    and fr on (LX + 1) x 65, fb and two black buffers on LX x 64, three
    red coefficients on (LX + 1) x 65, two row terms on LX + 1 rows, two
    column terms on 132 columns."""
    SJ = REGION_J + 1
    return 4 * (5 * (LX + 1) * SJ + 3 * LX * REGION_J + 2 * (LX + 1)
                + 2 * (2 * SJ + 2))


def make_layout(X: int, Y2: int, T: int, rows: int,
                IX: int) -> Reduced2DLayout:
    """The Reduced2DLayout of `rows` warps a CTA, each thread holding IX x
    2 points of the LX = rows IX row region: the kernel's forms (16, 3),
    (32, 3) and (32, 2)."""
    BX, BJ = rows * IX - 2 * T, REGION_J - T
    return Reduced2DLayout(X, Y2, T, IX, BX, BJ, -(-Y2 // BJ), -(-X // BX),
                           32 * rows, smem_bytes(rows * IX))


def form(T: int) -> tuple:
    """(warps a CTA, rows of points a thread) for a chunk of T sweeps: 16
    warps on a 48-row region up to T = 4 (two CTAs an SM), 32 warps on 96
    rows up to T = 8, 32 warps on 64 rows above: of these and 16 warps on
    64 rows, the fastest on the 4097^2 plan's levels of each T on an H100
    (PERF.md, Findings; scripts/probe_reduced_layouts.py)."""
    return (16, 3) if T <= 4 else (32, 3) if T <= 8 else (32, 2)


@functools.lru_cache(maxsize=64)
def layout(X: int, Y2: int, T: int) -> Reduced2DLayout:
    """The kernel's layout of a chunk of T sweeps on (X, Y2) halves: T's
    form, a region of LX rows by 64 slots, its owned tile LX - 2T rows by
    64 - T slots (the one-sided halo of T sweeps), tiles covering the
    level.  Cached: the wrapper asks at every launch."""
    if not 1 <= T <= MAX_T or X < 1 or Y2 < 1:
        raise ValueError(f"no layout of T = {T} on ({X}, {Y2}) halves")
    return make_layout(X, Y2, T, *form(T))


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def chunk_sweeps(geom: LevelGeometry) -> int | None:
    """T, the sweeps per chunk JAX's `split2d_plan` (relax.py:3778-3824)
    gives this level's reduced kernel, on the padded shape JAX stores it
    in (rows to a multiple of 8, columns of 128: pad_sublane_to=8,
    pad_last_to=128), with one-sided x offsets and the interior rows
    covered; None where no block fits JAX's budget."""
    nx, ny = geom.shape
    X, Y = _round_up(nx, 8), _round_up(ny, 128)
    half_row = _round_up(Y // 2, 128) * 4
    best = None
    for B in (128, 64, 32, 16, 8):
        for T in dict.fromkeys((SPLIT2D_T, 8, 4)):
            ext = B + _round_up(2 * T, 8)
            if X < ext or (X // B) * B < nx - 1:
                continue
            if (half_row * 12 * ext > SLAB_VMEM_BUDGET
                    or half_row * ext > SPLIT2D_MAX_WINDOW):
                continue
            r = ext / B
            cost = r + 2.0 * (r + 1.0) / T
            if best is None or cost < best[0]:
                best = (cost, T)
    return None if best is None else best[1]


# ------------------------------------------------------ plain version


def _coord(geom: LevelGeometry, ax: int, idx, dtype):
    """origin + idx * spacing on axis `ax`, domain-clamped (as
    `split2d.rows_layout` and the kernels compute coordinates)."""
    lo, hi = geom.domain[ax]
    x = torch.tensor(geom.origin[ax], dtype=dtype) + idx.to(
        dtype) * torch.tensor(geom.spacing[ax], dtype=dtype)
    return torch.clamp(x, min(lo, hi), max(lo, hi))


def _next(a, k: int, ax: int):
    """a[x + k] (ax 0) or a[:, j + k] (ax 1), 0 past the end: what JAX's
    zero padding holds there."""
    out = torch.zeros_like(a)
    if ax == 0:
        out[:-k] = a[k:]
    else:
        out[:, :-k] = a[:, k:]
    return out


def reduced_fields(r, b, fr, fb, problem, geom: LevelGeometry) -> dict:
    """The chunk's sweep-invariant fields on whole halves (fr, fb None: the
    f-less chunk), as the TPU kernel builds them (relax.py:3266-3331):
    c_xx, c_xy, c_yy, c_f, m_b, c_bk of the black update, and the red
    rebuild's east and south coefficients r_e, r_s, its RHS term r_f (None
    f-less), m_r and c_rk; q1 marks the odd rows."""
    X, Y2 = r.shape
    dev, dt = r.device, r.dtype
    nx, ny = geom.shape
    ke, ks, kf = problem.reduced2d_fields
    g = torch.arange(X, device=dev)[:, None]
    jj = torch.arange(Y2, device=dev)[None, :]
    q1 = (g % 2) == 1
    qi = g % 2
    y_r = 2 * jj + qi
    y_b = 2 * jj + 1 - qi
    okx = (g >= 1) & (g <= nx - 2)
    oky_b = (y_b >= 1) & (y_b <= ny - 2)
    m_b = (okx & oky_b).to(dt)
    m_r = (okx & (y_r >= 1) & (y_r <= ny - 2)).to(dt)
    m_rE = ((g + 1 >= 1) & (g + 1 <= nx - 2) & oky_b).to(dt)
    m_rS = (okx & (y_b + 1 >= 1) & (y_b + 1 <= ny - 2)).to(dt)

    def pre(gx, y):
        return problem.kernel_precompute(
            (_coord(geom, 0, gx, dt), _coord(geom, 1, y, dt)), geom, dt)

    pre_b, pre_rE, pre_rS, pre_r = (pre(g, y_b), pre(g + 1, y_b),
                                    pre(g, y_b + 1), pre(g, y_r))
    ae_b, as_b = pre_b[ke], pre_b[ks]
    c_xx = ae_b * m_rE * pre_rE[ke]
    c_xy = ae_b * m_rE * pre_rE[ks] + as_b * m_rS * pre_rS[ke]
    c_yy = as_b * m_rS * pre_rS[ks]
    rE_in = _next(r, 1, 0)
    rS_in = torch.where(q1, r, _next(r, 1, 1))
    c_f = ae_b * (1 - m_rE) * rE_in + as_b * (1 - m_rS) * rS_in
    if fr is not None:
        frE = _next(fr, 1, 0)
        frS = torch.where(q1, fr, _next(fr, 1, 1))
        c_f = c_f + (ae_b * m_rE * pre_rE[kf] * frE
                     + as_b * m_rS * pre_rS[kf] * frS + pre_b[kf] * fb)
    return {"q1": q1, "c_xx": c_xx, "c_xy": c_xy, "c_yy": c_yy, "c_f": c_f,
            "m_b": m_b, "c_bk": (1 - m_b) * b, "r_e": pre_r[ke],
            "r_s": pre_r[ks],
            "r_f": None if fr is None else pre_r[kf] * fr,
            "m_r": m_r, "c_rk": (1 - m_r) * r}


def black_update(fd: dict, b2, bxy, b1):
    """A sweep's black update from B[x+2, j], B[x+1, j+1-q] and B[x, j+1]
    (`fd`: `reduced_fields`, or its values at the same points), in the
    kernel's order."""
    upd = fd["c_xx"] * b2 + fd["c_xy"] * bxy + fd["c_yy"] * b1 + fd["c_f"]
    return fd["m_b"] * upd + fd["c_bk"]


def red_rebuild(fd: dict, bE, bS):
    """Red from b_prev's east B[x+1, j] and south B[x, j+q] neighbours."""
    r_upd = fd["r_e"] * bE + fd["r_s"] * bS
    if fd["r_f"] is not None:
        r_upd = r_upd + fd["r_f"]
    return fd["m_r"] * r_upd + fd["c_rk"]


def reduced_slab2d_plain(r, b, fr, fb, T: int, problem,
                         geom: LevelGeometry):
    """(r, b) after one chunk of T sweeps on whole halves (new tensors;
    fr, fb None: the f-less chunk): the TPU kernel's body
    (relax.py:3241-3359) in its order, every read past the last row or
    slot 0."""
    fd = reduced_fields(r, b, fr, fb, problem, geom)
    q1 = fd["q1"]

    def sweep(bb):
        b1 = _next(bb, 1, 0)
        bxy = torch.where(q1, b1, _next(b1, 1, 1))
        return black_update(fd, _next(bb, 2, 0), bxy, _next(bb, 1, 1))

    b_prev = b
    for _ in range(T - 1):
        b_prev = sweep(b_prev)
    b_new = sweep(b_prev)
    rE = _next(b_prev, 1, 0)
    rS = torch.where(q1, _next(b_prev, 1, 1), b_prev)
    return red_rebuild(fd, rE, rS), b_new


# ------------------------------------------------------------ wrappers


def reduced_chunk(r, b, fr, fb, T: int, problem, geom: LevelGeometry, out):
    """One chunk of T sweeps on the level's halves (r, b), with the RHS
    halves (fr, fb) or none (both None: the f-less kernel), written into
    `out` = (r_out, b_out), two halves apart from the inputs; returns
    `out`.  One launch of csrc/reduced2d.cu for CUDA tensors, the plain
    version for CPU tensors."""
    if not (hasattr(problem, "reduced2d_fields") and tuple(
            getattr(problem, "split2d_x_offsets", None) or ()) == (1,)):
        raise TypeError(
            "the reduced kernel serves one-sided 2D stencils naming their "
            f"reduced2d_fields (relax.py:3176-3177); got "
            f"{type(problem).__name__}")
    R2._check_halves(r, b, geom)
    if (fr is None) != (fb is None):
        raise ValueError("give both RHS halves or neither")
    fs = () if fr is None else (fr, fb)
    if fs:
        R2._check_halves(fr, fb, geom)
    R2._check_halves(*out, geom)
    if not 1 <= T <= MAX_T:
        raise ValueError(f"T = {T}: a chunk runs 1 to {MAX_T} sweeps")
    ins = (r, b, *fs)
    on_cuda = _on_cuda(*ins, *out)
    if any(R2._overlap(o, a) for o in out for a in ins) or R2._overlap(*out):
        raise ValueError("the output halves overlap the inputs or each "
                         "other")
    if not on_cuda:
        pr, pb = reduced_slab2d_plain(r, b, *(fs or (None, None)), T,
                                      problem, geom)
        out[0].copy_(pr)
        out[1].copy_(pb)
        return out
    params = R2.lyap_params(problem, geom)
    lay = layout(*r.shape, T)
    pf = (fr.data_ptr(), fb.data_ptr()) if fs else (None, None)
    rc = build.load().lib.pdemg_reduced2d(
        r.data_ptr(), b.data_ptr(), *pf, out[0].data_ptr(),
        out[1].data_ptr(), ctypes.byref(lay), ctypes.addressof(params),
        _stream(),
    )
    launches["reduced2d"] += 1
    build.check(rc, "reduced2d")
    return out


def reduced_relax_halves(r, b, fr, fb, nsweeps: int, T: int, problem,
                         geom: LevelGeometry):
    """(r, b) after `nsweeps` sweeps as JAX chains the kernel
    (relax.py:3411-3428): nsweeps // T chunks of T, then one of
    nsweeps % T, each from the last one's halves.  The outputs are two
    ping-pong pairs; the inputs are not written."""
    n_full, rem = divmod(nsweeps, T)
    bufs = [None, None]
    for k, t in enumerate([T] * n_full + [rem] * (rem > 0)):
        if bufs[k % 2] is None:
            bufs[k % 2] = (torch.empty_like(r), torch.empty_like(b))
        r, b = reduced_chunk(r, b, fr, fb, t, problem, geom, bufs[k % 2])
    return r, b


def reduced_relax(v, f, nsweeps: int, T: int, problem, geom: LevelGeometry,
                  f_zero: bool = False):
    """One leg on a dense level, in place on v, as JAX's `relax`
    (relax.py:3407-3428): split v (and f, unless `f_zero`), the chunks,
    merge back into v."""
    r, b = R2.to_halves(v)
    fr, fb = (None, None) if f_zero else R2.to_halves(f)
    r, b = reduced_relax_halves(r, b, fr, fb, nsweeps, T, problem, geom)
    return R2.from_halves(r, b, out=v)
