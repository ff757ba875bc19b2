"""Color-split red-black Gauss-Seidel on padded 2D Lyapunov and Poisson
levels: the CUDA kernels of `csrc/relax2d.cu` (the converters) and
`csrc/color_slab2d_shard.cu` (the sweeps) and their plain PyTorch
versions.

Replaces the TPU kernels `pde_multigrid_tpu/ops/pallas/relax.py`
`_pallas_split_2d`, `_pallas_merge_2d` (and the XLA `split_colors_2d` /
`merge_colors_2d` they stand in for), `make_split_color_slab_2d` (its
`raw` halves-in/halves-out form at sweeps_per_call = T: `relax_halves2d`,
chunks of T sweeps) and, on one shard of a sharded level,
`make_split_color_slab_2d_shard` (`color_slab2d_shard`, a chunk of t
sweeps, and `color_slab2d_leg`, a whole leg of a one-rank level on chip).
2D Poisson (`models/poisson.py`, whose stencil reads both x and both y
neighbours) has the chunk's one-rank form alone (`relax_halves2d`: JAX's
raw `make_split_color_slab_2d` on its padded split levels), with a halo
on both sides of each tile (`slab_tile`, sides = 2); its sharded forms
are ROADMAP.md queue 1 item 17.
Halves layout (`ops/split2d.py`): a dense (X, Y) level becomes red/black
(X, ceil(Y/2)) arrays; with q = x % 2, red sits at y = 2j + q and black at
y = 2j + 1 - q.  With an odd Y the slot y = Y of each row is inert (split
writes 0 there).

Each wrapper launches its kernel for CUDA tensors, runs the plain version
for CPU tensors, and raises for anything else; there is no fallback from
a CUDA tensor to the plain version.  `launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from pde_multigrid_tpu_torch.grid import LevelGeometry
from pde_multigrid_tpu_torch.models.lyapunov2d import Lyapunov2D
from pde_multigrid_tpu_torch.models.poisson import Poisson, split_constants
from pde_multigrid_tpu_torch.ops import split2d
from pde_multigrid_tpu_torch.ops.cuda import build
from pde_multigrid_tpu_torch.ops.cuda.relax import _on_cuda, _stream

RED, BLACK = 0, 1

launches = {"split2d": 0, "merge2d": 0, "color_slab2d_shard": 0,
            "color_slab2d_leg": 0, "color_slab2d_poisson": 0}

# csrc/color_slab2d_shard.cu's constants: points a chunk's CTA holds by
# its threads (its two forms), points a leg's CTA holds, the sweeps
# between a leg's halo refreshes and the largest cluster; and the
# chunk's tiling: the widest tile along j, the fewest owned rows, and the
# CTAs a launch keeps resident (one on each of an H100's SMs), which
# small levels' tiles are cut to fill
SLAB_POINTS = {512: 512 * 10, 1024: 1024 * 4}
LEG_POINTS = 512 * 8
LEG_T = 4
LEG_MAX_CTAS = 16
SLAB_TILE_J = 64
SLAB_MIN_BX = 8
SLAB_CTAS = 132
# sweeps a chunk of an unsharded level's relax (JAX's sweeps_per_call):
# the one-rank engine's T (config.sweeps_per_exchange); any T gives the
# same owned rows, bit for bit
CHUNK_T = 4


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


class Lyap2DParams(ctypes.Structure):
    """The kernels' `Lyap2D` (csrc/lyapunov2d.cuh): float32 constants,
    each rounded once from double (ctypes' float conversion), as JAX's
    float32 constants round."""

    _fields_ = [
        (name, ctypes.c_float)
        for name in ("o0", "h0", "lo0", "hi0", "o1", "h1", "lo1", "hi1",
                     "a00", "a01", "a10", "a11", "ahh", "nhh")
    ] + [("nx", ctypes.c_int), ("ny", ctypes.c_int)]


def lyap_params(problem, geom: LevelGeometry) -> Lyap2DParams:
    """Kernel constants of Lyapunov2D.kernel_precompute on `geom`."""
    if not isinstance(problem, Lyapunov2D):
        raise TypeError(
            "the 2D CUDA kernels implement the Lyapunov2D stencil; "
            f"got {type(problem).__name__}"
        )
    split2d.check_level(geom)
    (lo0, hi0), (lo1, hi1) = geom.domain
    hx, hy = geom.spacing
    a = problem.a
    return Lyap2DParams(
        geom.origin[0], hx, min(lo0, hi0), max(lo0, hi0),
        geom.origin[1], hy, min(lo1, hi1), max(lo1, hi1),
        a[0, 0], a[0, 1], a[1, 0], a[1, 1],
        problem.alpha * hx * hy, -hx * hy,
        geom.shape[0], geom.shape[1],
    )


class Poisson2DParams(ctypes.Structure):
    """The 2D Poisson kernels' `Poisson2D` (csrc/poisson2d.cuh): the
    constants of `split_constants`, each rounded once from double to
    float32 (ctypes' float conversion), and the logical extents."""

    _fields_ = [(name, ctypes.c_float) for name in ("w0", "w1", "inv_den")]
    _fields_ += [("nx", ctypes.c_int), ("ny", ctypes.c_int)]


def poisson_params(problem, geom: LevelGeometry) -> Poisson2DParams:
    """Kernel constants of Poisson.kernel_update / split_update2d on a 2D
    level (wrap or padded storage)."""
    if not (isinstance(problem, Poisson) and problem.ndim == 2):
        raise TypeError("the 2D Poisson kernels implement Poisson(2); got "
                        f"{type(problem).__name__}")
    if geom.ndim != 2:
        raise ValueError(f"need a 2D level, got {geom}")
    (w0, w1), inv_den = split_constants(geom)
    return Poisson2DParams(w0, w1, inv_den, *geom.shape)


# ------------------------------------------------------ plain versions


def split_colors_2d(v: torch.Tensor):
    """(X, Y) dense -> (r, b) halves (X, ceil(Y/2)); inert slots 0."""
    X, Y = v.shape
    vp = v if Y % 2 == 0 else torch.cat([v, v.new_zeros((X, 1))], dim=1)
    v0, v1 = vp[:, 0::2], vp[:, 1::2]  # even / odd y
    q1 = split2d.q1_rows(X, v.device)
    return torch.where(q1, v1, v0), torch.where(q1, v0, v1)


def merge_colors_2d(r: torch.Tensor, b: torch.Tensor, Y: int):
    """Inverse of split_colors_2d: (r, b) -> dense (X, Y)."""
    X = r.shape[0]
    q1 = split2d.q1_rows(X, r.device)
    even = torch.where(q1, b, r)
    odd = torch.where(q1, r, b)
    return torch.stack([even, odd], dim=2).reshape(X, -1)[:, :Y]


def half_sweep2d_plain(u, w, fu, color: int, problem, geom: LevelGeometry):
    """One half-sweep in place on `u` from the other color `w` (and u's
    RHS half `fu`, or None for a zero RHS), in the kernel's form: the
    coefficients of Lyapunov2D.kernel_precompute at the color's own
    coordinates, split_update2d, and a select that leaves every point
    off the interior bitwise as it was."""
    q1 = split2d.q1_rows(u.shape[0], u.device)
    cr, cb, _ = split2d.color_coords(geom, u.dtype, u.device)
    pre = problem.kernel_precompute(cr if color == RED else cb, geom,
                                    u.dtype)
    nbr = split2d._nbr_factory(w, q1 if color == RED else ~q1)
    upd = problem.split_update2d(nbr, fu, pre, geom)
    m = split2d.interior_masks_halves(geom, u.dtype, u.device)[color]
    return u.copy_(torch.where(m > 0, upd, u))


@functools.lru_cache(maxsize=8)
def _rows_fields(problem, geom: LevelGeometry, g0: int, rows: int, dtype,
                 device):
    """(q1, m_r, m_b, pre_r, pre_b) of `rows` rows from global row `g0`:
    split2d.rows_layout's q1 and interior masks (bool), and each colour's
    kernel_precompute fields."""
    lay = split2d.rows_layout(geom, g0, rows, dtype, device)
    cr, cb = lay["coords"]
    m_r, m_b = (m > 0 for m in lay["masks"])
    return (lay["q1"], m_r, m_b, problem.kernel_precompute(cr, geom, dtype),
            problem.kernel_precompute(cb, geom, dtype))


def color_slab2d_shard_plain(r_ext, b_ext, fr_ext, fb_ext, g0: int, t: int,
                             problem, geom: LevelGeometry, x_loc: int):
    """(r, b): the owned x_loc rows of one shard's ext halves after t
    red-black sweeps (new tensors); fr_ext / fb_ext None drop the RHS.
    The ext halves hold XE >= x_loc + 2t rows in the global colour
    convention, ext row 0 at global row `g0` (XE = x_loc on a one-rank
    ring, whose last row no interior point reads past); coordinates,
    colours and interior masks come from the global row.
    Each half-sweep is half_sweep2d_plain's on the ext block, its x and y
    neighbours rolled within the block as JAX's kernel rolls them
    (relax.py:2879): the rows a roll corrupts lie past x_loc + 2t - 2s
    after s sweeps."""
    q1, m_r, m_b, pre_r, pre_b = _rows_fields(
        problem, geom, g0, r_ext.shape[0], r_ext.dtype, r_ext.device)
    r, b = r_ext, b_ext
    for _ in range(t):
        upd = problem.split_update2d(split2d._nbr_factory(b, q1), fr_ext,
                                     pre_r, geom)
        r = torch.where(m_r, upd, r)
        upd = problem.split_update2d(split2d._nbr_factory(r, ~q1), fb_ext,
                                     pre_b, geom)
        b = torch.where(m_b, upd, b)
    return r[:x_loc], b[:x_loc]


# ------------------------------------------------------------ wrappers


def _check_halves(r, b, geom: LevelGeometry) -> None:
    split2d.check_level(geom)
    want = (geom.padded_shape[0], split2d.half_width(geom))
    for t in (r, b):
        if tuple(t.shape) != want:
            raise ValueError(
                f"halves {tuple(t.shape)} do not match level "
                f"{geom.padded_shape} (want {want})"
            )


def to_halves(v: torch.Tensor, out: tuple | None = None):
    """Dense (X, Y) -> (r, b) halves, written into `out` when given (the
    level's persistent halves)."""
    if v.dim() != 2:
        raise ValueError(f"need a 2D level, got {tuple(v.shape)}")
    X, Y = v.shape
    Y2 = (Y + 1) // 2
    if out is None:
        out = (torch.empty((X, Y2), dtype=v.dtype, device=v.device),
               torch.empty((X, Y2), dtype=v.dtype, device=v.device))
    r, b = out
    if tuple(r.shape) != (X, Y2) or r.shape != b.shape:
        raise ValueError(f"split output shapes {tuple(r.shape)}, "
                         f"{tuple(b.shape)}")
    if not _on_cuda(v, r, b):
        pr, pb = split_colors_2d(v)
        return r.copy_(pr), b.copy_(pb)
    rc = build.load().lib.pdemg_split2d(
        v.data_ptr(), r.data_ptr(), b.data_ptr(), X, Y, _stream()
    )
    launches["split2d"] += 1
    build.check(rc, "split2d")
    return r, b


def from_halves(r: torch.Tensor, b: torch.Tensor, out: torch.Tensor):
    """(r, b) halves -> dense, written into `out` (X, Y) in place: one
    launch of csrc/relax2d.cu's merge2d_kernel (the level as one flat
    array of 16-byte quads, `out` anywhere 4-byte aligned)."""
    if out.dim() != 2:
        raise ValueError(f"need a 2D level, got {tuple(out.shape)}")
    X, Y = out.shape
    if tuple(r.shape) != (X, (Y + 1) // 2) or r.shape != b.shape:
        raise ValueError(f"halves {tuple(r.shape)}, {tuple(b.shape)} do "
                         f"not match {tuple(out.shape)}")
    if not _on_cuda(r, b, out):
        return out.copy_(merge_colors_2d(r, b, Y))
    rc = build.load().lib.pdemg_merge2d(
        r.data_ptr(), b.data_ptr(), out.data_ptr(), X, Y, _stream()
    )
    launches["merge2d"] += 1
    build.check(rc, "merge2d")
    return out


def relax_halves2d(r, b, fr, fb, nsweeps: int, problem,
                   geom: LevelGeometry, spare=None):
    """`nsweeps` red-then-black sweeps on a level's halves (r, b) with the
    RHS halves (fr, fb), or None for none (the f-less chunk): JAX's raw
    `make_split_color_slab_2d` at sweeps_per_call = CHUNK_T, that is
    ceil(nsweeps / CHUNK_T) one-rank chunks (`color_slab2d_shard`, the
    remainder last), in turns from (r, b) into `spare` (the level's
    second pair of halves; a new pair when None) and back.  Returns the
    pair the last chunk wrote: (r, b) after an even count of chunks, else
    `spare`.  The result is bitwise the half-sweep chain's
    (`half_sweep2d_plain`)."""
    _check_halves(r, b, geom)
    if (fr is None) != (fb is None):
        raise ValueError("give both RHS halves or neither")
    if fr is not None:
        _check_halves(fr, fb, geom)
    nxt = (torch.empty_like(r), torch.empty_like(b)) if spare is None \
        else spare
    _check_halves(*nxt, geom)
    cur = (r, b)
    n_full, rem = divmod(nsweeps, CHUNK_T)
    for t in [CHUNK_T] * n_full + [rem] * (rem > 0):
        color_slab2d_shard(*cur, fr, fb, 0, t, problem, geom, r.shape[0],
                           nxt, one_rank=True)
        cur, nxt = nxt, cur
    return cur


def _overlap(a: torch.Tensor, b: torch.Tensor) -> bool:
    """True when the memory of `a` and `b` (contiguous) overlaps."""
    a0, b0 = a.data_ptr(), b.data_ptr()
    return a0 < b0 + b.nbytes and b0 < a0 + a.nbytes


def slab_tile(x_loc: int, Y2: int, t: int, sides: int = 1):
    """(RX, RJ, BX, BJ, threads): the loaded and owned rows and slots of
    the chunk kernel's tiles for `t` sweeps on a shard of x_loc rows of Y2
    slots, with a 2t halo on +x and, where a tile does not span the row,
    on +j (sides = 2, 2D Poisson's two-sided stencil: 2t on each side of
    both, the kernel's halo (RX - BX) / 2 before the owned points), and
    the kernel's form (threads a CTA).  Whole rows where Y2 <=
    SLAB_TILE_J, else SLAB_TILE_J slots; as many rows as the CTA's points
    allow (SLAB_POINTS[threads]), or on a level whose tiles would leave
    SLAB_CTAS CTAs idle, fewer (at least SLAB_MIN_BX owned), so that the
    tiles fill whole waves of SLAB_CTAS.  The form: 1024 threads where
    512-thread tiles take more than one wave (2049^2 and up; 1025^2 at
    t = 4), else 512."""

    h = 2 * t * sides  # halo points of a cut axis

    def tiling(points):
        RJ = min(Y2, SLAB_TILE_J)
        BJ = Y2 if RJ >= Y2 else RJ - h
        ntj = -(-Y2 // BJ) if BJ > 0 else 1
        bx_max = points // RJ - h
        waves = -(-(-(-x_loc // max(bx_max, 1)) * ntj) // SLAB_CTAS)
        rows = max(1, waves * SLAB_CTAS // ntj)
        BX = min(bx_max, max(SLAB_MIN_BX, -(-x_loc // rows)))
        return BX + h, RJ, BX, BJ, waves

    threads = 1024 if tiling(SLAB_POINTS[512])[4] > 1 else 512
    RX, RJ, BX, BJ, _ = tiling(SLAB_POINTS[threads])
    if BX < 1 or BJ < 1:
        raise ValueError(f"{t} sweeps do not fit a {RX} x {RJ} tile of the "
                         f"chunk kernel")
    return RX, RJ, BX, BJ, threads


def leg_layout(geom: LevelGeometry):
    """(RX, BX, nctas) of `color_slab2d_leg` on a one-rank level: bands
    of BX rows (plus 2 LEG_T halo rows, RX in all) on the largest cluster
    of at most LEG_MAX_CTAS CTAs whose bands are at least 2 LEG_T rows
    and hold LEG_POINTS points, the rows spread evenly; the whole level in
    one CTA where no cluster fits and it holds LEG_POINTS points; None
    where the level does not fit on chip."""
    X, Y2 = geom.padded_shape[0], split2d.half_width(geom)
    for n in range(LEG_MAX_CTAS, 1, -1):
        BX = -(-X // n)
        RX = BX + 2 * LEG_T
        if BX >= 2 * LEG_T and RX * Y2 <= LEG_POINTS and (n - 1) * BX < X:
            return RX, BX, n
    return (X, X, 1) if X * Y2 <= LEG_POINTS else None


def color_slab2d_shard(r_ext, b_ext, fr_ext, fb_ext, g0: int, t: int,
                       problem, geom: LevelGeometry, x_loc: int, out,
                       one_rank: bool = False):
    """One chunk of `t` sweeps on a shard's (XE, Y2) ext halves (global
    colour convention, ext row 0 at global row `g0`, XE >= x_loc + 2t),
    with the RHS halves (fr_ext, fb_ext), or None for none (the f-less
    form: no RHS read, no f a_f term), the exact owned rows written into
    `out` = (r, b), two (x_loc, Y2) tensors apart from the inputs; returns
    `out`.  `one_rank`: the form of a one-rank ring (and of an unsharded
    level, `relax_halves2d`), whose shard reaches the level's last row:
    rows past x_loc read as 0 (no interior point reads them), so XE >=
    x_loc and no ext rows are read.  Tiles and the kernel's form:
    `slab_tile`.  One launch of csrc/color_slab2d_shard.cu for CUDA
    tensors, the plain version for CPU tensors.  2D Poisson takes the
    one-rank form of an unsharded level alone (g0 = 0, x_loc the level's
    rows): rows -1 and X, before and past the level, read as 0, and only
    its boundary rows read them; the tiles carry a halo on both sides
    (`slab_tile`, sides = 2), launched as `pdemg_color_slab2d_poisson`."""
    split2d.check_level(geom)
    Y2 = split2d.half_width(geom)
    XE = r_ext.shape[0]
    poisson = isinstance(problem, Poisson)
    if poisson and not (one_rank and g0 == 0
                        and x_loc == geom.padded_shape[0]):
        raise NotImplementedError(
            "the 2D Poisson colour slab runs the one-rank chunk of an "
            "unsharded level; its sharded forms are ROADMAP.md queue 1 "
            "item 17")
    if (fr_ext is None) != (fb_ext is None):
        raise ValueError("give both RHS halves or neither")
    ins = (r_ext, b_ext) + (() if fr_ext is None else (fr_ext, fb_ext))
    for a in ins:
        if tuple(a.shape) != (XE, Y2):
            raise ValueError(f"ext halves {tuple(a.shape)}, want ({XE}, "
                             f"{Y2}) for level {geom.padded_shape}")
    for o in out:
        if tuple(o.shape) != (x_loc, Y2):
            raise ValueError(f"output halves {tuple(o.shape)}, want "
                             f"({x_loc}, {Y2})")
    if one_rank and g0 + x_loc < geom.shape[0]:
        raise ValueError(
            f"the one-rank form needs the shard to reach the level's last "
            f"row: rows {g0} .. {g0 + x_loc - 1} of {geom.shape[0]}")
    need = x_loc if one_rank else x_loc + 2 * t
    if t < 1 or XE < need:
        raise ValueError(f"{t} sweeps need an ext slab of "
                         f"{'x_loc' if one_rank else 'x_loc + 2t'} = {need} "
                         f"rows or more; got {XE}")
    if any(_overlap(o, a) for o in out for a in ins) or _overlap(*out):
        raise ValueError("the output halves overlap the inputs or each "
                         "other")
    if one_rank:
        ins = tuple(a[:x_loc] for a in ins)
        XE = x_loc
    tiles = slab_tile(x_loc, Y2, t, 2 if poisson else 1)
    fs = ins[2:] or (None, None)
    if not _on_cuda(*ins, *out):
        pr, pb = color_slab2d_shard_plain(*ins[:2], *fs, g0, t, problem,
                                          geom, x_loc)
        out[0].copy_(pr)
        out[1].copy_(pb)
        return out
    lib = build.load().lib
    if poisson:
        fn, params = lib.pdemg_color_slab2d_poisson, poisson_params(
            problem, geom)
        name = "color_slab2d_poisson"
    else:
        fn, params = lib.pdemg_color_slab2d_shard, lyap_params(problem,
                                                                geom)
        name = "color_slab2d_shard"
    rc = fn(
        *(None if a is None else a.data_ptr() for a in (*ins[:2], *fs, *out)),
        XE, x_loc, Y2, g0, t, *tiles, ctypes.addressof(params), _stream(),
    )
    launches[name] += 1
    build.check(rc, name)
    return out


def color_slab2d_leg(r, b, fr, fb, nsweeps: int, problem,
                     geom: LevelGeometry, out):
    """A whole leg of `nsweeps` sweeps on a one-rank level's (X, Y2)
    halves (global colour convention: the port's split), written into
    `out` = (r, b), two (X, Y2) tensors apart from the inputs; returns
    `out`.  The same owned rows as chunks of the one-rank form
    (`color_slab2d_shard(..., one_rank=True)`), bit for bit.  One launch
    of csrc/color_slab2d_shard.cu's leg form (`leg_layout`: one CTA or a
    cluster) for CUDA tensors, the plain version for CPU tensors; a level
    that does not fit on chip raises."""
    _check_halves(r, b, geom)
    _check_halves(fr, fb, geom)
    for o in out:
        if o.shape != r.shape:
            raise ValueError(f"output halves {tuple(o.shape)}, want "
                             f"{tuple(r.shape)}")
    if nsweeps < 1:
        raise ValueError(f"a leg of {nsweeps} sweeps")
    ins = (r, b, fr, fb)
    if any(_overlap(o, a) for o in out for a in ins) or _overlap(*out):
        raise ValueError("the output halves overlap the inputs or each "
                         "other")
    layout = leg_layout(geom)
    if layout is None:
        raise ValueError(f"level {geom.padded_shape} does not fit on chip "
                         f"({LEG_MAX_CTAS} CTAs of {LEG_POINTS} points)")
    X, Y2 = r.shape
    if not _on_cuda(*ins, *out):
        pr, pb = color_slab2d_shard_plain(*ins, 0, nsweeps, problem, geom, X)
        out[0].copy_(pr)
        out[1].copy_(pb)
        return out
    params = lyap_params(problem, geom)
    rc = build.load().lib.pdemg_color_slab2d_leg(
        *(a.data_ptr() for a in (*ins, *out)), X, Y2, nsweeps, *layout,
        ctypes.addressof(params), _stream(),
    )
    launches["color_slab2d_leg"] += 1
    build.check(rc, "color_slab2d_leg")
    return out
