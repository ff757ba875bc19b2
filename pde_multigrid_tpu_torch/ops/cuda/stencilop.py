"""Red-black Gauss-Seidel for implicit-stencil operators (a K-point
coefficient field per point, `ops/galerkin.StencilOperator`): the CUDA
kernels of `csrc/stencilop.cu`, their plain PyTorch version, their layouts
and the per-level plan.

Replaces the TPU kernels `pde_multigrid_tpu/ops/pallas/stencilop.py`
`make_stencil_relax_resident` (`stencil_resident`: a whole leg in one
launch, the level on chip; 1D, 2D and 3D levels) and
`make_stencil_relax_slab_2d` (`stencil_slab2d`: 2D levels too large to
hold, T sweeps per launch in tiles with a 2T halo).  All evaluate each
half-sweep's colour from the iterate as it stood before it, as the plain
form `v + m * (gs_update(v, f) - v)` does: the 9- and 27-point Galerkin
stencils read same-colour diagonal neighbours.

The resident kernel has two forms.  The leg (`leg_layout`): a CTA sized
to the level, or a cluster of up to 16 CTAs, each thread holding P points
of each colour with their coefficients in registers; a cluster barrier
every half-sweep, or halo rows refreshed every te sweeps.  The general
form (`resident_ctas`): one CTA or an 8-CTA cluster walking every slot
each half-sweep, for the levels the leg does not hold.  The slab kernel
walks its tiles on one CTA an SM (`slab_form`: T and the tile shape).

Coefficients: the level's `aux["stencil_coeffs"]`, read on every call
(no copy is kept), of shape (*shape, K) or, for a constant operator such
as `Poisson.stencil_operator`'s, (1, ..., 1, K), which the kernels read
with a point stride of 0.  Red and black are the interior points of even
and odd index sum (`grid.base_aux`), computed in the kernels from the
geometry.

The wrappers launch their kernel for CUDA tensors, run the plain version
for CPU tensors, and raise for anything else; there is no fallback from a
CUDA tensor to the plain version.  `launches` counts kernel launches (both
resident forms under "stencil_resident").
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from pde_multigrid_tpu_torch.grid import LevelGeometry, base_aux
from pde_multigrid_tpu_torch.ops import stencil
from pde_multigrid_tpu_torch.ops.cuda import build
from pde_multigrid_tpu_torch.ops.cuda.relax import _on_cuda, _stream
from pde_multigrid_tpu_torch.ops.galerkin import StencilOperator

launches = {"stencil_resident": 0, "stencil_slab2d": 0}


class SlabForm(NamedTuple):
    """The slab kernel's launch: at most T sweeps, tiles of BX x BY owned
    points with a halo of 2T on every side."""

    T: int
    BX: int
    BY: int


class LegLayout(NamedTuple):
    """The resident leg's launch: a cluster of `ctas` CTAs (up to 16)
    along x, `threads` threads each, P points of each colour a thread,
    their coefficients and f in registers; te = 0: the edge rows pushed and
    a cluster barrier every half-sweep, te > 0: 2 te halo rows a side,
    refreshed every te sweeps."""

    ctas: int
    threads: int
    P: int
    te: int = 0


# the slab kernel's form by K (csrc/stencilop.cu pdemg_stencil_slab2d):
# 1024^2 (K = 5) and 512^2 (K = 9) on the varcoef2d row, each the fastest
# 40-sweep leg on an H100 (PERF.md, Findings); K = 3, on no level of that
# row, as K = 5.  `slab_form` halves the tiles' rows where they would
# leave SMs idle (256^2: 16 x 32).
SLAB_FORMS = {3: SlabForm(3, 32, 64), 5: SlabForm(3, 32, 64),
              9: SlabForm(4, 32, 32)}
# the slab's CTAs (one an SM, 512 threads, P = 4 slots of each colour a
# thread) and the SMs of an H100 SXM, for the layout helpers below (the
# kernel asks the card)
SLAB_THREADS = 512
SLAB_P = 4
H100_SMS = 132
# the general form: one CTA, or a cluster of this many, and the shared
# memory one CTA may hold (two copies of v and f: 12 B a point)
CLUSTER_CTAS = 8
MAX_SMEM_BYTES = 232448
# the largest level the general form runs on one CTA: one whose colours
# each fit one pass of its 1024 threads (block barriers; the 8-CTA cluster
# above)
ONE_CTA_MAX_SLOTS = 1024
MAX_K = 27
# the K each kernel is built for (csrc/stencilop.cu): the finest operators
# (2d + 1 points; 2 for Ode1D, 3 for Lyapunov2D) and the Galerkin ones
# (3^d points)
RESIDENT_K = (2, 3, 5, 7, 9, 27)
SLAB_K = tuple(SLAB_FORMS)
# the leg: its cluster sizes (up to 16, non-portable past 8; fewer where
# the rows do not divide) and points of each colour a thread
LEG_CTAS = (1, 2, 4, 8, 16)
LEG_P = (1, 2)
# sweeps between a cluster's halo refreshes: 0, a barrier every half-sweep
LEG_TE = (0, 2)
# the leg's rule: one CTA where a colour's slots fit this many threads,
# else the largest cluster that holds the level
LEG_CTA_SLOTS = 512


class StencilOpParams(ctypes.Structure):
    """The kernels' `StencilOp` (csrc/stencilop.cu)."""

    _fields_ = [
        ("X", ctypes.c_int), ("Y", ctypes.c_int), ("Z", ctypes.c_int),
        ("lo", ctypes.c_int * 3), ("hi", ctypes.c_int * 3),
        ("K", ctypes.c_int), ("center", ctypes.c_int), ("odd", ctypes.c_int),
        ("cstride", ctypes.c_int), ("wrap", ctypes.c_int),
        ("off", ctypes.c_int * (3 * MAX_K)),
    ]


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _view(geom: LevelGeometry):
    """The kernels' (X, Y, Z) view of the level, Z contiguous: 3D as it
    is, 2D as (X, 1, Y), 1D as (1, 1, N); and the axes of the view the
    level's own axes sit on."""
    s = tuple(geom.padded_shape)
    if geom.ndim == 3:
        return s, (0, 1, 2)
    if geom.ndim == 2:
        return (s[0], 1, s[1]), (0, 2)
    return (1, 1, s[0]), (2,)


@functools.lru_cache(maxsize=256)
def params(offsets, geom: LevelGeometry, constant: bool) -> StencilOpParams:
    """The kernels' operator and level description: the view, the
    interior bounds of `grid.base_aux` (wrap storage: index 0 is the
    boundary; padded: the logical ring and the padding), the offsets on
    the view's axes, which of them reach the other colour, and the point
    stride of the coefficients (0 for a constant operator)."""
    K = len(offsets)
    if not 1 <= K <= MAX_K or any(len(o) != geom.ndim for o in offsets):
        raise ValueError(f"offsets {offsets} for a {geom.ndim}D level")
    if any(abs(x) > 1 for o in offsets for x in o):
        raise ValueError("stencil reach must be at most 1")
    view, axes = _view(geom)
    lo, hi = _interior(geom)
    off = [0] * (3 * MAX_K)
    odd = 0
    for k, o in enumerate(offsets):
        for a, vax in enumerate(axes):
            off[3 * k + vax] = o[a]
        if sum(abs(x) for x in o) % 2:
            odd |= 1 << k
    center = offsets.index((0,) * geom.ndim)
    return StencilOpParams(
        *view, (ctypes.c_int * 3)(*lo), (ctypes.c_int * 3)(*hi), K, center,
        odd, 0 if constant else K, int(geom.wrap),
        (ctypes.c_int * (3 * MAX_K))(*off),
    )


@functools.lru_cache(maxsize=64)
def _masks(geom: LevelGeometry, dtype, device):
    aux = base_aux(geom, dtype, device)
    return aux["m_red"], aux["m_black"]


def stencil_relax_plain(v, f, coeffs, offsets, geom: LevelGeometry,
                        nsweeps: int):
    """`nsweeps` red-black sweeps in place on v: `stencil.relax_rbgs` over
    `StencilOperator.gs_update` with the masks of `grid.base_aux` (the
    Galerkin tier's plain relax)."""
    op = StencilOperator(offsets=tuple(offsets), coeffs=coeffs)
    m_red, m_black = _masks(geom, v.dtype, v.device)
    return stencil.relax_rbgs(op.gs_update, v, f, m_red, m_black, nsweeps)


def _check(v, f, coeffs, offsets, geom: LevelGeometry) -> tuple[bool, bool]:
    """Shapes against the level, then `_on_cuda` (device, float32,
    contiguous).  Returns (whether the coefficients are constant, whether
    the tensors lie on the card)."""
    shape = tuple(geom.padded_shape)
    if tuple(v.shape) != shape or f is None or tuple(f.shape) != shape:
        raise ValueError(
            f"v {tuple(v.shape)} and f {None if f is None else tuple(f.shape)}"
            f" do not match level {shape}"
        )
    K = len(offsets)
    cshape = tuple(coeffs.shape)
    constant = cshape == (1,) * geom.ndim + (K,)
    if cshape != shape + (K,) and not constant:
        raise ValueError(
            f"coefficients {cshape}: want {shape + (K,)} or "
            f"{(1,) * geom.ndim + (K,)}"
        )
    return constant, _on_cuda(v, f, coeffs)


def resident_smem_bytes(geom: LevelGeometry, ctas: int, K: int = 0,
                        constant: bool = True, staged: bool = False) -> int:
    """Shared memory per CTA of the general form on `ctas` CTAs
    (csrc/stencilop.cu resident_smem): two copies of v and f in its local
    layout (its axis-0 rows with a ghost row on each side, one appended
    plane on the real axes among y and z), and, staged, their K
    coefficients (K in all for a constant operator)."""
    (X, Y, Z), _ = _view(geom)
    gx = 1 if X > 1 else 0
    pts = (-(-X // ctas) + 2 * gx) * (Y + (Y > 1)) * (Z + 1)
    coef = (K if constant else K * pts) if staged else 0
    return 4 * (3 * pts + coef)


def resident_ctas(geom: LevelGeometry) -> int | None:
    """The CTAs the resident kernel runs the level on: one where a colour's
    slots fit one pass of 1024 threads, else the 8-CTA cluster (not for 1D
    levels: the (1, 1, N) view has one row); None when neither holds v and
    f."""
    (X, Y, Z), _ = _view(geom)
    if X * Y * -(-Z // 2) <= ONE_CTA_MAX_SLOTS or geom.ndim == 1:
        return 1 if resident_smem_bytes(geom, 1) <= MAX_SMEM_BYTES else None
    if resident_smem_bytes(geom, CLUSTER_CTAS) <= MAX_SMEM_BYTES:
        return CLUSTER_CTAS
    return None


def resident_staged(geom: LevelGeometry, ctas: int, K: int,
                    constant: bool) -> bool:
    """Whether the resident kernel's CTAs also hold the level's
    coefficients (else it reads them from device memory every sweep)."""
    return resident_smem_bytes(geom, ctas, K, constant, True) <= (
        MAX_SMEM_BYTES)


def leg_rows(geom: LevelGeometry, ctas: int) -> int:
    """Axis-0 rows of the kernels' view each of the leg's `ctas` CTAs
    owns (the last may own fewer)."""
    (X, _, _), _ = _view(geom)
    return -(-X // ctas)


def _ghost(geom: LevelGeometry, te: int) -> int:
    """Ghost rows on each side of a leg CTA's rows: 2 te, or one (none
    on the one-row 1D view)."""
    (X, _, _), _ = _view(geom)
    return 2 * te if te else (1 if X > 1 else 0)


def leg_slots(geom: LevelGeometry, ctas: int, te: int = 0) -> int:
    """Slots of each colour of one of the leg's CTAs: (row, y, k) over its
    rows (te > 0: every loaded row but the first and last), z = 2k or
    2k + 1 (csrc/stencilop.cu stencil_resident_leg_kernel); the slots off
    the interior update nothing."""
    (_, Y, Z), _ = _view(geom)
    rows = leg_rows(geom, ctas)
    rows += 2 * _ghost(geom, te) - 2 if te else 0
    return rows * Y * -(-Z // 2)


def leg_smem_bytes(geom: LevelGeometry, ctas: int, te: int = 0) -> int:
    """Dynamic shared memory of one of the leg's CTAs: two copies of v in
    the local layout (its rows with `_ghost` rows on each side, one
    appended plane on the real axes among y and z; te > 0, each as its two
    colours' halves of ceil((Z + 1) / 2) points a row, and two inboxes of
    both sides' halo rows of both colours).  The coefficients, f and the
    center's reciprocal live in registers."""
    (X, Y, Z), _ = _view(geom)
    G, Ly = _ghost(geom, te), Y + (Y > 1)
    rows = leg_rows(geom, ctas) + 2 * G
    if te:
        v = (4 * rows + 8 * G) * Ly * -(-(Z + 1) // 2)
    else:
        v = 2 * rows * Ly * (Z + 1)
    return 4 * v


def leg_max_threads(K: int, P: int) -> int:
    """The leg form's most threads a CTA (its registers: K + 3 a point)."""
    return 1024 if K <= 5 and P == 1 else 512


def leg_fits(geom: LevelGeometry, K: int, ctas: int, P: int,
             te: int = 0) -> int | None:
    """The threads of the leg on `ctas` CTAs with P points of each colour a
    thread (the slots rounded up to whole warps), or None where that form
    does not hold the level: P is 1 or 2, K = 27 takes one point a
    thread, every CTA of a cluster owns a row (te > 0: a cluster whose CTAs
    each own the 2 te rows they hand on, te even, no CTA's rows and halo
    longer than the level), a CTA holds at most 227 KB."""
    (X, _, Z), _ = _view(geom)
    rows = leg_rows(geom, ctas)
    if (K not in RESIDENT_K or P not in LEG_P
            or not 1 <= ctas <= 16 or (K == 27 and P != 1)
            or (ctas - 1) * rows >= X or Z < 2 or te < 0 or te % 2
            or (te and (ctas < 2 or X - (ctas - 1) * rows < 2 * te
                        or rows + 8 * te > X))):
        return None
    threads = max(32, -(-leg_slots(geom, ctas, te) // (32 * P)) * 32)
    if threads > leg_max_threads(K, P) or (
            leg_smem_bytes(geom, ctas, te) > MAX_SMEM_BYTES):
        return None
    return threads


def leg_layouts(geom: LevelGeometry, K: int) -> list[LegLayout]:
    """Every leg form that holds the level, fewest CTAs first, then a
    barrier every half-sweep (te = 0) before halo rows refreshed every 2
    sweeps (a cluster), then one point of each colour a thread before two
    (two only where they take fewer threads)."""
    (X, _, _), _ = _view(geom)
    out = []
    # a cluster of up to 8 or 16 CTAs, as many as own rows (33 rows: 7
    # CTAs of 5, or 11 of 3)
    for ctas in sorted({-(-X // -(-X // c)) for c in LEG_CTAS}):
        for te in LEG_TE:
            one = leg_fits(geom, K, ctas, 1, te)
            two = leg_fits(geom, K, ctas, 2, te)
            out += [LegLayout(ctas, t, P, te) for P, t in ((1, one), (2, two))
                    if t and not (P == 2 and t == one)]
    return out


def leg_layout(geom: LevelGeometry, K: int) -> LegLayout | None:
    """The leg's form on the level, or None where none holds it: one CTA
    where a colour's slots fit LEG_CTA_SLOTS threads (32^2 and below in
    2D), else the largest cluster (16 CTAs, fewer where the rows do not
    divide) with halo rows refreshed every 2 sweeps where that holds the
    level (128^2, 64^2), else a barrier every half-sweep; then the fewest
    points of each colour a thread.  On an H100 the fastest at each level
    of the varcoef2d row, and faster than the general form on every 1D
    and 3D Galerkin level measured (PERF.md, Findings)."""
    forms = leg_layouts(geom, K)
    if not forms:
        return None
    one = forms[0]
    if one.ctas == 1 and leg_slots(geom, 1) <= LEG_CTA_SLOTS and one.P == 1:
        return one
    most = max(f.ctas for f in forms)
    return min((f for f in forms if f.ctas == most),
               key=lambda f: (-f.te, f.P))


def _interior(geom: LevelGeometry):
    """The interior bounds of `grid.base_aux` on the kernels' view: wrap
    storage from index 1 to the last stored one, padded storage the
    logical ring's."""
    _, axes = _view(geom)
    lo, hi = [0, 0, 0], [0, 0, 0]
    for a, vax in enumerate(axes):
        lo[vax] = 1
        hi[vax] = (geom.padded_shape[a] - 1 if geom.wrap
                   else geom.shape[a] - 2)
    return lo, hi


def leg_points(geom: LevelGeometry, layout: LegLayout):
    """The leg's assignment of points (csrc/stencilop.cu, its slot walk):
    for each CTA and colour c, the flat indices (in the level's padded
    shape) of the points its slots q = tid + m threads (tid < threads,
    m < P) update, in slot order, and whether each lies in the CTA's own
    rows (te > 0: the halo rows' points are updated too, x modulo X)."""
    (X, Y, Z), _ = _view(geom)
    lo, hi = _interior(geom)
    rows, Zh = leg_rows(geom, layout.ctas), -(-Z // 2)
    G = _ghost(geom, layout.te)
    out = []
    for r in range(layout.ctas):
        x0 = r * rows
        nr = max(0, min(rows, X - x0))
        nrl, f0 = (nr + 2 * G - 2, 1) if layout.te else (nr, G)
        q = np.arange(layout.threads * layout.P)
        q = q[q < nrl * Y * Zh]
        x = x0 - G + f0 + q // (Y * Zh)
        xw = x % X
        y = q % (Y * Zh) // Zh
        k = q % Zh
        cols = []
        for c in (0, 1):
            z = 2 * k + ((x + y + c) & 1)
            on = (z < Z) & (xw >= lo[0]) & (xw <= hi[0]) & (y >= lo[1]) & (
                y <= hi[1]) & (z >= lo[2]) & (z <= hi[2])
            own = (x >= x0) & (x < x0 + nr)
            cols.append((((xw * Y + y) * Z + z)[on], own[on]))
        out.append(cols)
    return out


def slab_tiles(geom: LevelGeometry, form: SlabForm) -> tuple[int, int]:
    """The slab's tiles along x and y: they cover [0, n - 1) in steps of
    BX (BY) and the last one owns the rest (slab2d.cu): 1024^2 in wrap
    storage is 32 x 16 tiles of 32 x 64."""
    (X, _, Y), _ = _view(geom)

    def count(n, t):
        return -(-(n - 1) // t) if n > 1 else 1

    return count(X, form.BX), count(Y, form.BY)


def slab_region(form: SlabForm) -> tuple[int, int]:
    """Rows and row stride of a tile's loaded region at most: the owned
    points, one more (a last tile's remainder) and a 2T halo each side."""
    return form.BX + 1 + 4 * form.T, form.BY + 1 + 4 * form.T


def slab_smem_bytes(K: int, constant: bool, form: SlabForm | None = None,
                    double: bool = True) -> int:
    """Shared memory of one of the slab's CTAs (csrc/stencilop.cu
    launch_slab): a buffer of v, f and the K coefficients of each loaded
    point (K in all for a constant operator), two of them where a CTA walks
    more than one tile (the next tile's copies in flight), and the second
    copy of v."""
    RX, S = slab_region(form or SLAB_FORMS[K])
    n = RX * S
    buf = n * (2 + (0 if constant else K)) + (K if constant else 0)
    return 4 * ((2 if double else 1) * buf + n)


def slab_fits(K: int, form: SlabForm) -> bool:
    """Whether the kernel takes the form: the CTA's 512 threads' four slots
    of each colour cover a tile's updated rows, and both buffers fit."""
    RX, S = slab_region(form)
    return ((RX - 2) * -(-S // 2) <= SLAB_THREADS * SLAB_P
            and slab_smem_bytes(K, False, form) <= MAX_SMEM_BYTES)


def slab_form(geom: LevelGeometry, K: int) -> SlabForm:
    """The slab's form on a level: the K's SLAB_FORMS, its tiles' rows
    halved (down to 16) while the tiles would not fill H100_SMS CTAs."""
    form = SLAB_FORMS[K]
    while form.BX > 16 and np.prod(slab_tiles(geom, form)) < H100_SMS:
        form = form._replace(BX=form.BX // 2)
    return form


def slab_walk(geom: LevelGeometry, form: SlabForm,
              sms: int = H100_SMS) -> list[list[int]]:
    """The persistent walk: CTA b of min(tiles, sms) takes tiles b,
    b + grid, ... (tile = x index * tiles along y + y index)."""
    ntx, nty = slab_tiles(geom, form)
    grid = min(ntx * nty, sms)
    return [list(range(b, ntx * nty, grid)) for b in range(grid)]


def slab_box(geom: LevelGeometry, form: SlabForm, tile: int):
    """One tile's owned box ((gx0, gx1), (gy0, gy1)) and loaded box
    ((ox, LX), (oy, LY)), LX and LY counting the appended row and column 0
    of wrap storage (csrc/stencilop.cu Box)."""
    (X, _, Y), _ = _view(geom)
    ntx, nty = slab_tiles(geom, form)
    H = 2 * form.T
    ty, tx = divmod(tile, nty)
    gx0, gy0 = ty * form.BX, tx * form.BY
    gx1 = X if ty + 1 == ntx else gx0 + form.BX
    gy1 = Y if tx + 1 == nty else gy0 + form.BY
    ox, oy = max(gx0 - H, 0), max(gy0 - H, 0)
    LX = min(gx1 + H, X) - ox
    LY = min(gy1 + H, Y) - oy
    LX += bool(geom.wrap and ox + LX == X)
    LY += bool(geom.wrap and oy + LY == Y)
    return ((gx0, gx1), (gy0, gy1)), ((ox, LX), (oy, LY))


def slab_points(geom: LevelGeometry, form: SlabForm, tile: int):
    """A tile's slots (csrc/stencilop.cu stencil_slab2d_kernel): for each
    colour, the flat indices of the points its threads' slots q = tid + m
    512 update, (lx, k) over the loaded rows 1 .. LX - 2."""
    (X, _, Y), _ = _view(geom)
    lo, hi = _interior(geom)
    _, ((ox, LX), (oy, LY)) = slab_box(geom, form, tile)
    Yh = (LY + 1) // 2
    q = np.arange(SLAB_THREADS * SLAB_P)
    lx = 1 + q // Yh
    k = q % Yh
    out = []
    for c in (0, 1):
        ly = 2 * k + ((ox + lx + oy + c) & 1)
        gx, gy = ox + lx, oy + ly
        on = (lx < LX - 1) & (ly >= 1) & (ly < LY - 1) & (gx >= lo[0]) & (
            gx <= hi[0]) & (gy >= lo[2]) & (gy <= hi[2])
        out.append((gx * Y + gy)[on])
    return out


def stencil_resident(v, f, coeffs, offsets, geom: LevelGeometry,
                     nsweeps: int):
    """`nsweeps` red-black sweeps in place on v, one launch: the leg
    (`leg_layout`) where it holds the level, else the general form on
    `resident_ctas(geom)` CTAs, the coefficients staged in shared memory
    where `resident_staged` says they fit; returns v (the plain version
    for CPU tensors)."""
    constant, on_card = _check(v, f, coeffs, offsets, geom)
    if not on_card:
        return stencil_relax_plain(v, f, coeffs, offsets, geom, nsweeps)
    K = len(offsets)
    layout = leg_layout(geom, K)
    if layout is not None:
        _launch_leg(v, f, coeffs, offsets, geom, nsweeps, layout, constant)
    else:
        _launch_resident(v, f, coeffs, offsets, geom, nsweeps,
                         resident_ctas(geom), constant)
    return v


def _launch_leg(v, f, coeffs, offsets, geom: LevelGeometry, nsweeps: int,
                layout: LegLayout, constant: bool):
    """One launch of the leg in `layout` (`leg_layout`'s)."""
    if nsweeps < 1:
        return
    p = params(tuple(offsets), geom, constant)
    rc = build.load().lib.pdemg_stencil_leg(
        v.data_ptr(), f.data_ptr(), coeffs.data_ptr(), layout.ctas,
        layout.threads, layout.P, layout.te, nsweeps, ctypes.addressof(p),
        _stream(),
    )
    launches["stencil_resident"] += 1
    build.check(rc, "stencil_resident")


def _launch_resident(v, f, coeffs, offsets, geom: LevelGeometry,
                     nsweeps: int, ctas, constant: bool):
    """One launch of the general form on `ctas` CTAs."""
    K = len(offsets)
    if (ctas not in (1, CLUSTER_CTAS) or K not in RESIDENT_K
            or resident_smem_bytes(geom, ctas) > MAX_SMEM_BYTES):
        raise ValueError(
            f"level {geom.padded_shape}, K = {K}: the resident kernel holds "
            f"levels of {CLUSTER_CTAS} x {MAX_SMEM_BYTES} B of shared memory "
            f"and K in {RESIDENT_K}"
        )
    staged = resident_staged(geom, ctas, K, constant)
    if nsweeps < 1:
        return
    p = params(tuple(offsets), geom, constant)
    rc = build.load().lib.pdemg_stencil_resident(
        v.data_ptr(), f.data_ptr(), coeffs.data_ptr(), ctas, int(staged),
        nsweeps, ctypes.addressof(p), _stream(),
    )
    launches["stencil_resident"] += 1
    build.check(rc, "stencil_resident")


def stencil_slab2d(v, f, coeffs, offsets, geom: LevelGeometry,
                   nsweeps: int):
    """`nsweeps` red-black sweeps of a 2D level, returned as a new tensor
    (v is not changed; 0 sweeps return v itself), in ceil(nsweeps / T)
    launches of at most T sweeps each, in `slab_form`'s form."""
    if geom.ndim != 2:
        raise ValueError(f"the slab kernel takes 2D levels, not {geom}")
    K = len(offsets)
    if K not in SLAB_K:
        raise ValueError(f"the slab kernel is built for K in {SLAB_K}, not "
                         f"{K}")
    form = slab_form(geom, K)
    constant, on_card = _check(v, f, coeffs, offsets, geom)
    if nsweeps < 1:
        return v
    if not on_card:
        return stencil_relax_plain(v.clone(), f, coeffs, offsets, geom,
                                   nsweeps)
    p = ctypes.addressof(params(tuple(offsets), geom, constant))
    fn = build.load().lib.pdemg_stencil_slab2d
    stream = _stream()
    bufs = [torch.empty_like(v)]
    if nsweeps > form.T:
        bufs.append(torch.empty_like(v))
    src, done = v, 0
    while done < nsweeps:
        dst = bufs[0] if src is not bufs[0] else bufs[1]
        here = min(form.T, nsweeps - done)
        rc = fn(src.data_ptr(), dst.data_ptr(), f.data_ptr(),
                coeffs.data_ptr(), here, *form, p, stream)
        launches["stencil_slab2d"] += 1
        build.check(rc, "stencil_slab2d")
        src, done = dst, done + here
    return src


class StencilPlan:
    """One level's relax on the card: `kernel` is "stencil_resident" (the
    leg in `layout`, or the general form on `ctas` CTAs where `layout` is
    None) or "stencil_slab2d" (in `form`); calling it runs a leg."""

    def __init__(self, offsets, geom: LevelGeometry, kernel: str,
                 ctas: int | None = None, layout: LegLayout | None = None,
                 form: SlabForm | None = None):
        self.offsets = tuple(offsets)
        self.geom = geom
        self.kernel = kernel
        self.ctas = ctas
        self.layout = layout
        self.form = form

    def launches(self, nsweeps: int) -> int:
        """Kernel launches of one leg of `nsweeps` sweeps."""
        if nsweeps < 1:
            return 0
        return 1 if self.kernel == "stencil_resident" else -(
            -nsweeps // self.form.T)

    def __call__(self, v, f, coeffs, nsweeps: int):
        fn = stencil_resident if self.kernel == "stencil_resident" else (
            stencil_slab2d)
        return fn(v, f, coeffs, self.offsets, self.geom, nsweeps)

    def __repr__(self):
        what = (f", {tuple(self.layout)}" if self.layout else
                f", {self.ctas} CTA(s)" if self.ctas else
                f", {tuple(self.form)}" if self.form else "")
        return f"StencilPlan({self.geom.padded_shape}, {self.kernel}{what})"


def plan_stencil_relax(offsets, geom: LevelGeometry) -> StencilPlan:
    """The kernel of one stencil-operator level (the counterpart of the
    JAX `plan_stencil_relax`, resident else slab), chosen on the card:
    the resident kernel where it holds the level with its coefficients --
    the leg (`leg_layout`: 128^2 and below on the varcoef2d row), else the
    general form where it stages them (1D and 3D levels also where only v
    and f fit) -- the slab kernel on other 2D levels (`slab_form`).  A
    level neither holds (3D levels above ~155k points, 1D above ~19k, or
    a K no kernel is built for) raises: its kernel is ROADMAP.md queue 2
    item 36."""
    K = len(offsets)
    layout = leg_layout(geom, K)
    if layout is not None:
        return StencilPlan(offsets, geom, "stencil_resident", layout.ctas,
                           layout)
    ctas = resident_ctas(geom)
    if ctas is not None and K in RESIDENT_K and (
            geom.ndim != 2 or resident_staged(geom, ctas, K, False)):
        return StencilPlan(offsets, geom, "stencil_resident", ctas)
    if geom.ndim == 2 and K in SLAB_K and slab_fits(K, slab_form(geom, K)):
        return StencilPlan(offsets, geom, "stencil_slab2d",
                           form=slab_form(geom, K))
    raise NotImplementedError(
        f"Galerkin level {geom.padded_shape} (K = {K}): neither stencil "
        "kernel holds it on the card (ROADMAP.md queue 2 item 36)"
    )
