"""Dense red-black Gauss-Seidel on 2D levels too large for the dense leg
kernel (padded HJB levels; 2D Poisson levels in wrap or padded storage),
in 2D tiles with a 2T-point halo: the CUDA kernel of `csrc/slab2d.cu` and
its plain PyTorch version.

Replaces the TPU kernel `pde_multigrid_tpu/ops/pallas/relax.py`
`make_slab_relax` (the 513^2 finest level of the HJB row; 2D Poisson's
wrap levels 4096^2 ... 1024^2, and 512^2, which no cluster of the dense
leg holds).  The update is the Pallas kernel's `v + m * (kernel_update -
v)`, red (x + y even) then black, with the masks of
`resident._plain_fields` (the interior, for HJB without the pinned target
ball); the HJB kernel reads the same mask and coefficient tensors
(`resident.hjb_fields`), the Poisson one two constants and the interior
from the global index (`relax2d.poisson_params`).  A wrap level is tiled
as its logical (n, n) level, whose last row and column are stored row
and column 0 (csrc/slab2d.cu).  Each tile (one CTA) relaxes its owned
points with a halo of 2T points; every T sweeps the halos are refreshed
from the neighbours' owned points.  On a level whose tiles the card holds
co-resident (`slab_layout`'s `leg`: 513^2) a whole leg is one cooperative
launch, the refreshes going through device memory; on larger levels each
launch takes at most T sweeps.  A launch reads one array and writes
another, so `slab_relax` returns a new tensor and leaves `v` as it was.

The wrapper launches the kernel for CUDA tensors, runs the plain version
for CPU tensors, and raises for anything else; there is no fallback from
a CUDA tensor to the plain version.  `launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from pde_multigrid_tpu_torch.grid import LevelGeometry
from pde_multigrid_tpu_torch.models.hjb import HJBMinTime
from pde_multigrid_tpu_torch.models.poisson import Poisson
from pde_multigrid_tpu_torch.ops.cuda import build
from pde_multigrid_tpu_torch.ops.cuda.relax import _on_cuda, _sm_count, _stream
from pde_multigrid_tpu_torch.ops.cuda.relax2d import poisson_params
from pde_multigrid_tpu_torch.ops.cuda.resident import (
    _plain_fields,
    check_hjb,
    hjb_fields,
)

launches = {"slab2d": 0, "slab2d_poisson": 0}

# csrc/slab2d.cu's constants: the rows a thread's segment may hold (the
# kernel's template instances: the layouts of 2^k + 1 and 3 2^k + 1
# levels take 4 or 6; 8 to 12 measured slower at 513^2, PERF.md), the
# threads and shared memory a CTA may take, and the halo refreshes one
# launch of a leg may make
SLAB_ROWS = (4, 6)
MAX_THREADS = 1024
MAX_SMEM_BYTES = 232448
MAX_REFRESH = 254
# the layout's choices, measured on an H100 (PERF.md, Findings): T, the
# sweeps between halo refreshes; the tiles (owned rows, columns) a leg
# tries, smallest first, on at most LEG_CTAS CTAs (one on each of an
# H100's SMs); the tile of a level no leg holds, at most T sweeps a launch
SLAB_T = 4
LEG_TILES = ((16, 32), (32, 64))
LEG_CTAS = 132
CHAIN_TILE = (32, 64)


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


class HJBSlabLayout(ctypes.Structure):
    """The kernel's `HJBSlab` (csrc/slab2d.cu): the logical level, the
    tiles along x and y (a CTA each), the rows and columns a tile owns
    (the last of each axis also the level's rest), T and the halo H = 2T,
    row segments G of L rows (the kernel's template instance), threads a
    segment NC, the row stride S and rows in shared memory, threads a CTA,
    shared memory bytes (the tile, and a leg's refresh table), the form: 1
    a whole leg in one cooperative launch, 0 at most T sweeps a launch,
    and wrap (1: wrap storage, the level stored as (X - 1, Y - 1))."""

    _fields_ = [(name, ctypes.c_int)
                for name in ("X", "Y", "ntx", "nty", "BX", "BY", "T", "H",
                             "G", "L", "NC", "S", "rows", "threads",
                             "smem_bytes", "leg", "wrap")]

    def as_dict(self) -> dict:
        return {name: getattr(self, name) for name, _ in self._fields_}

    @property
    def ctas(self) -> int:
        return self.ntx * self.nty

    def face_words(self) -> int:
        """Outbox words of one CTA at one parity (csrc/slab2d.cu
        `face_words`): top and bottom strips, H rows by the widest tile's
        owned columns, and left and right, the tallest tile's rows by H."""
        WX = self.X - (self.ntx - 1) * self.BX
        WY = self.Y - (self.nty - 1) * self.BY
        return 2 * self.H * WY + 2 * WX * self.H

    def table_entries(self) -> int:
        """Entries of a leg's refresh table (csrc/slab2d.cu
        `table_entries`): the points a CTA publishes, at most face_words,
        then its halo points, at most the widest loaded region less the
        smallest owned one; none without outboxes."""
        if not self.leg or self.ctas == 1:
            return 0
        WX = self.X - (self.ntx - 1) * self.BX
        WY = self.Y - (self.nty - 1) * self.BY
        LX, LY = min(WX + 2 * self.H, self.X), min(WY + 2 * self.H, self.Y)
        return self.face_words() + LX * LY - self.BX * self.BY


def _slab_layout(X: int, Y: int, BX: int, BY: int, T: int, leg: bool,
                 L: int | None = None, wrap: int = 0):
    """The HJBSlabLayout of a logical X x Y level (wrap: stored as X - 1 by
    Y - 1) in tiles of BX x BY owned points
    ((X - 1) // BX tiles along x, the last owning the rest; one tile owning
    all X rows where that is fewer than two; likewise y), T sweeps between
    refreshes (a leg) or at most T a launch, the widest tile's loaded rows
    in segments of L rows (by default the fewest rows whose segments the
    threads allow); None where the kernel cannot take it (a tile with a
    neighbour owning fewer than 2T rows or columns, a leg on more than
    LEG_CTAS CTAs, more threads or shared memory than a CTA has)."""
    H = 2 * T
    ntx, nty = max(1, (X - 1) // BX), max(1, (Y - 1) // BY)
    BX, BY = (BX if ntx > 1 else X), (BY if nty > 1 else Y)
    if T < 1 or (ntx > 1 and BX < H) or (nty > 1 and BY < H):
        return None
    if leg and ntx * nty > LEG_CTAS:
        return None
    WX, WY = X - (ntx - 1) * BX, Y - (nty - 1) * BY
    LX, LY = min(WX + 2 * H, X), min(WY + 2 * H, Y)
    NC = -(-(LY - 2) // 32) * 32
    for rows in (SLAB_ROWS if L is None else (L,)):
        G = -(-LX // rows)
        lay = HJBSlabLayout(X, Y, ntx, nty, BX, BY, T, H, G, rows, NC,
                            NC + 2, G * rows + 4, G * NC, 0, int(leg), wrap)
        lay.smem_bytes = 4 * lay.rows * lay.S + 8 * lay.table_entries()
        if (rows in SLAB_ROWS and lay.threads <= MAX_THREADS
                and lay.smem_bytes <= MAX_SMEM_BYTES):
            return lay
    return None


@functools.lru_cache(maxsize=64)
def slab_layout(geom: LevelGeometry):
    """The kernel's layout of a 2D level, None where it has none: a whole
    leg a launch on the smallest of LEG_TILES whose tiles a co-resident
    grid holds (513^2, and wrap 512^2, whose logical level is 513^2: 16 x
    8 tiles of 32 x 64 points), else at most SLAB_T sweeps a launch on
    CHAIN_TILE (1025^2 and up, wrap 1024^2 and up).  A wrap level is laid
    out as its logical level (its stored extents plus the shared boundary
    row and column).  Cached per level: the wrapper asks at every call."""
    if geom.ndim != 2:
        return None
    w = int(geom.wrap)
    X, Y = (n + w for n in geom.padded_shape)
    for tile in LEG_TILES:
        lay = _slab_layout(X, Y, *tile, SLAB_T, True, None, w)
        if lay is not None:
            return lay
    return _slab_layout(X, Y, *CHAIN_TILE, SLAB_T, False, None, w)


def sweeps_per_launch(lay: HJBSlabLayout) -> int:
    """The most sweeps one launch of `lay` takes."""
    return (MAX_REFRESH + 1) * lay.T if lay.leg else lay.T


def slab_launches(nsweeps: int, geom: LevelGeometry) -> int:
    """Kernel launches of one `nsweeps`-sweep leg on `geom`."""
    return -(-nsweeps // sweeps_per_launch(slab_layout(geom)))


def slab_relax_plain(v, f, nsweeps: int, problem, geom: LevelGeometry):
    """`nsweeps` red-black sweeps in the Pallas kernel's form
    (relax.py:129-137), v += m_color * (kernel_update(v, f) - v), on a
    copy of v, which is returned."""
    m_red, m_black, pre = _plain_fields(problem, geom, v.dtype, v.device)
    v = v.clone()
    for _ in range(nsweeps):
        v.add_(m_red * (problem.kernel_update(v, f, pre, geom) - v))
        v.add_(m_black * (problem.kernel_update(v, f, pre, geom) - v))
    return v


# per (device, layout): a leg's outboxes (int64 words) and its two
# counters (int32), zero when made and never cleared (csrc/slab2d.cu: the
# launch counter in the words' epochs)
_LEG_STATE: dict = {}


def _leg_state(lay: HJBSlabLayout, device):
    """(box, count) of the legs of one layout on one device: the legs of a
    device share them (they run on one stream).  Made once outside a CUDA
    graph capture; a capture that finds none makes its own (zeroed by a
    captured fill, so every replay starts afresh)."""
    key = (device, tuple(lay.as_dict().values()))
    state = _LEG_STATE.get(key)
    if state is None:
        state = (torch.zeros(2 * lay.ctas * lay.face_words(),
                             dtype=torch.int64, device=device),
                 torch.zeros(2, dtype=torch.int32, device=device))
        if not torch.cuda.is_current_stream_capturing():
            _LEG_STATE[key] = state
    return state


def slab_relax(v, f, nsweeps: int, problem, geom: LevelGeometry):
    """`nsweeps` red-black sweeps of v, returned as a new tensor (v is not
    changed; on the card 0 sweeps return v itself), in `slab_launches`
    launches of the kernel on `slab_layout(geom)`: one for a leg on 513^2;
    a layout whose CTAs the card cannot hold co-resident raises.  HJB on
    padded levels, 2D Poisson on padded and wrap levels."""
    poisson = isinstance(problem, Poisson) and problem.ndim == 2
    if geom.ndim != 2 or (geom.wrap and not poisson) or tuple(
            v.shape) != tuple(geom.padded_shape):
        raise ValueError(
            f"v {tuple(v.shape)} does not match a 2D level "
            f"{geom.padded_shape} of the slab kernel (wrap storage: 2D "
            "Poisson only)"
        )
    if f is None or f.shape != v.shape:
        raise ValueError("the slab kernel takes f of v's shape")
    if poisson:
        params = poisson_params(problem, geom)
    elif isinstance(problem, HJBMinTime):
        check_hjb(problem)
    else:
        raise TypeError(
            "the slab kernel implements the HJBMinTime upwind update and "
            f"the 2D Poisson one; got {type(problem).__name__}"
        )
    lay = slab_layout(geom)
    if lay is None:
        raise ValueError(f"level {geom.padded_shape} fits no layout of the "
                         "slab kernel")
    if not _on_cuda(v, f):
        return slab_relax_plain(v, f, nsweeps, problem, geom)
    if nsweeps < 1:
        return v
    sms = _sm_count(v.device.index)
    if lay.leg and lay.ctas > sms:
        raise ValueError(f"the slab kernel's leg needs {lay.ctas} CTAs "
                         f"co-resident; the card has {sms} SMs")
    if not poisson:
        params, _ = hjb_fields(problem, geom, v.device)
    box, count = None, None
    if lay.leg and lay.ctas > 1:
        box, count = (a.data_ptr() for a in _leg_state(lay, v.device))
    lib = build.load().lib
    name = "slab2d_poisson" if poisson else "slab2d"
    fn = lib.pdemg_slab2d_poisson if poisson else lib.pdemg_slab2d
    per = sweeps_per_launch(lay)
    bufs = [torch.empty_like(v)]
    if nsweeps > per:
        bufs.append(torch.empty_like(v))
    src, done = v, 0
    while done < nsweeps:
        dst = bufs[0] if src is not bufs[0] else bufs[1]
        here = min(per, nsweeps - done)
        rc = fn(src.data_ptr(), dst.data_ptr(), f.data_ptr(), here,
                ctypes.byref(lay), ctypes.byref(params), box, count,
                _stream())
        launches[name] += 1
        build.check(rc, name)
        src, done = dst, done + here
    return src
