"""Whole-leg dense red-black Gauss-Seidel on small 2D levels (the 2D
Lyapunov equation and the HJB equation's upwind scheme on padded levels,
2D Poisson on wrap and padded levels): the CUDA kernels and their plain
PyTorch version.

Replaces the TPU kernel `pde_multigrid_tpu/ops/pallas/relax.py`
`make_resident_relax`: all sweeps of a relax leg in one launch, the level
held on chip for the whole leg (`fits` / `hjb_leg_layout` say whether a
level fits).  Lyapunov runs the dense form of the colour slab's leg
(csrc/color_slab2d_shard.cu, `pdemg_resident2d`): the level in x bands
on the largest cluster of at most 16 CTAs that holds it
(`relax2d.leg_layout`: 16, 15 and 9 CTAs at 257^2, 129^2 and 65^2; one
CTA on levels no cluster fits), each band kept as colour halves in shared
memory, split from the dense rows on load and merged on store, its
coefficients (and f a_f) in registers, block barriers between
half-sweeps and one cluster barrier every 4 sweeps, when each band's
first 8 rows are pushed into its left neighbour as its halo.  HJB
(csrc/resident.cu, `hjb_leg_layout`): each thread holds a column of a
segment of rows (v, f, the update-mask bits, the column's four
coefficients) in registers, the band dense in shared memory for the y
neighbours; one CTA up to 65^2 (its rows in segments), and above, the
level in x bands on the largest cluster of at most 16 CTAs whose bands
hold 2T rows, with 2T halo rows each side refreshed every T sweeps
through distributed shared memory under one cluster barrier.  2D Poisson
(`poisson_leg_layout`) runs the same kernel on its own stencil
(csrc/poisson2d.cuh: no coefficient or mask array, the interior from the
global index), on padded levels and on wrap levels, which it holds as the
logical (n, n) level whose last row and column are stored row and column
0.  Capacity gate: where no cluster holds a level (Poisson's wrap 512^2,
like HJB's 513^2), `poisson_leg_layout` is None and the level goes to the
slab kernel (`slab2d.py`), JAX's `make_slab_relax`.  The update is the
Pallas kernel's
`v + m * (kernel_update - v)`, red (x + y even) then black, with the masks
of `_coords_and_masks`: the interior times the problem's
`kernel_keep_mask` where it has one (HJB's pinned target ball).

The wrapper launches the kernel for CUDA tensors, runs the plain version
for CPU tensors, and raises for anything else; there is no fallback from
a CUDA tensor to the plain version.  `launches` counts kernel launches,
per variant.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from pde_multigrid_tpu_torch.grid import LevelGeometry, base_aux
from pde_multigrid_tpu_torch.models.hjb import HJBMinTime
from pde_multigrid_tpu_torch.models.poisson import Poisson
from pde_multigrid_tpu_torch.ops.cuda import build
from pde_multigrid_tpu_torch.ops.cuda.relax import _on_cuda, _stream
from pde_multigrid_tpu_torch.ops.cuda.relax2d import (
    leg_layout,
    lyap_params,
    poisson_params,
)
from pde_multigrid_tpu_torch.ops.cuda.subtree import check_cluster

launches = {"resident": 0, "resident_hjb": 0, "resident_poisson": 0}

# csrc/resident.cu's HJB constants: the largest cluster, the threads and
# shared memory a CTA may take, and the rows a thread's segment may hold
# (the kernel's template instances)
HJB_MAX_CTAS = 16
HJB_MAX_THREADS = 512
MAX_SMEM_BYTES = 232448
HJB_ROWS = (4, 6, 8, 10, 12, 14)
# the layout's choices, measured on an H100 (PERF.md, Findings): rows a
# thread's segment takes where the threads allow (else as few segments as
# the registers allow), and the sweeps between a cluster's halo refreshes,
# the longest first
HJB_SEG_ROWS = 4
HJB_TS = (4, 2)


class HJB2DParams(ctypes.Structure):
    """The kernels' `HJB2D` (csrc/hjb2d.cuh): device pointers to the update
    mask (uint8, one byte per point) and the four coefficient columns, and
    float32(1 / h2), rounded once from double."""

    _fields_ = [(name, ctypes.c_void_p)
                for name in ("mask", "c1", "s1", "inv_in", "inv_act")]
    _fields_ += [("c2", ctypes.c_float)]


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def layout(geom: LevelGeometry):
    """(RX, BX, nctas) of the Lyapunov kernel on a padded 2D level: bands
    of BX owned rows (RX loaded) on nctas CTAs, `relax2d.leg_layout`; None
    where the level does not fit on chip (513^2 and up: the split tier's
    levels)."""
    if geom.ndim != 2 or geom.wrap:
        return None
    return leg_layout(geom)


def fits(geom: LevelGeometry) -> bool:
    """True when the Lyapunov kernel can hold the level (RHS included)."""
    return layout(geom) is not None


class HJBLegLayout(ctypes.Structure):
    """The dense leg kernel's `HJBLeg` (csrc/resident.cu): the logical
    level, the CTAs (a cluster when more than one), owned rows B a CTA,
    halo rows H = 2T each side and T, row segments G of L rows (the
    kernel's template instance), threads a segment NC, the band's row
    stride S and rows, threads a CTA, shared memory bytes, and wrap (1:
    wrap storage, the level stored as (X - 1, Y - 1))."""

    _fields_ = [(name, ctypes.c_int)
                for name in ("X", "Y", "nctas", "B", "H", "T", "G", "L", "NC",
                             "S", "rows", "threads", "smem_bytes", "wrap")]

    def as_dict(self) -> dict:
        return {name: getattr(self, name) for name, _ in self._fields_}


def _hjb_layout(X: int, Y: int, nctas: int, T: int, G: int, wrap: int = 0):
    """The HJBLegLayout of an X x Y level on `nctas` CTAs (one: the whole
    level, no halo; more: x bands of B = ceil(X / nctas) rows with 2T halo
    rows each side, T sweeps between refreshes) with its band's rows cut
    into G segments of the same even number of rows L (the last may hold
    fewer); None where the kernel cannot take it (bands under 2T rows, an
    empty CTA or segment, more rows a segment than the largest instance,
    more threads or shared memory than a CTA has)."""
    cluster = nctas > 1
    B = -(-X // nctas)
    H = 2 * T if cluster else 0
    if (nctas - 1) * B >= X or (cluster and B < H) or nctas > HJB_MAX_CTAS:
        return None
    nload = min(B + 2 * H, X)
    L = next((w for w in HJB_ROWS if G * w >= nload), None)
    if L is None or (G - 1) * L >= nload:
        return None
    NC = -(-(Y - 2) // 32) * 32
    S = NC + 2
    rows = G * L + 4
    smem = 4 * (rows * S + (4 * H * S if cluster else 0))
    if G * NC > HJB_MAX_THREADS or smem > MAX_SMEM_BYTES:
        return None
    return HJBLegLayout(X, Y, nctas, B, H, T if cluster else 0, G, L, NC,
                        S, rows, G * NC, smem, wrap)


def _segments(X: int, Y: int, nctas: int, T: int, wrap: int = 0):
    """The HJBLegLayout of a level on `nctas` CTAs with T sweeps between
    refreshes, in segments of HJB_SEG_ROWS rows where the threads allow,
    else in as few segments as the largest instance allows; None where
    neither fits."""
    B = -(-X // nctas)
    nload = min(B + 4 * T, X) if nctas > 1 else X
    for rows in (HJB_SEG_ROWS, HJB_ROWS[-1]):
        lay = _hjb_layout(X, Y, nctas, T, -(-nload // rows), wrap)
        if lay is not None:
            return lay
    return None


@functools.lru_cache(maxsize=64)
def _leg_layout(X: int, Y: int, wrap: int):
    """The dense leg kernel's layout of a logical X x Y level, None where
    it cannot hold it: one CTA where its threads hold the level in
    segments (`_segments`: 65^2 and below, one warp on 3^2); above, the
    largest cluster of at most HJB_MAX_CTAS CTAs whose bands hold 2T rows,
    T the first of HJB_TS that fits.  Cached: the wrappers ask at every
    launch."""
    lay = _segments(X, Y, 1, 0, wrap)
    if lay is not None:
        return lay
    for n in range(HJB_MAX_CTAS, 1, -1):
        for T in HJB_TS:
            lay = _segments(X, Y, n, T, wrap)
            if lay is not None:
                return lay
    return None


def hjb_leg_layout(geom: LevelGeometry):
    """The HJB kernel's layout of a padded 2D level (`_leg_layout`), None
    where it cannot hold the level (513^2: the slab kernel's level)."""
    if geom.ndim != 2 or geom.wrap:
        return None
    return _leg_layout(*geom.padded_shape, 0)


def poisson_leg_layout(geom: LevelGeometry):
    """The 2D Poisson kernel's layout of a 2D level in either storage
    (`_leg_layout` of the logical level: a wrap level's stored extents
    plus its shared boundary row and column), None where no cluster holds
    it: padded 257^2 ... 3^2 and wrap 256^2 ... 2^2 fit, wrap 512^2 (the
    logical 513^2) does not, the capacity gate that sends it to the slab
    kernel."""
    if geom.ndim != 2:
        return None
    w = int(geom.wrap)
    X, Y = geom.padded_shape
    return _leg_layout(X + w, Y + w, w)


def check_hjb(problem) -> None:
    """The HJB kernels implement the upwind scheme."""
    if problem.scheme != "upwind":
        raise NotImplementedError(
            f"HJBMinTime(scheme={problem.scheme!r}) has no CUDA kernel yet "
            "(ROADMAP.md queue 2 item 30); its plain tier runs on the CPU"
        )


@functools.lru_cache(maxsize=64)
def _plain_fields(problem, geom: LevelGeometry, dtype, device):
    """(m_red, m_black, pre): the color masks times the problem's
    `kernel_keep_mask` where it has one (the Pallas `_coords_and_masks`),
    and its `kernel_precompute` fields."""
    aux = base_aux(geom, dtype, device)
    coords = geom.coords(dtype, device)
    m_red, m_black = aux["m_red"], aux["m_black"]
    keep = getattr(problem, "kernel_keep_mask", None)
    if keep is not None:
        k = keep(coords, geom, dtype)
        m_red, m_black = m_red * k, m_black * k
    pre = problem.kernel_precompute(coords, geom, dtype)
    return m_red, m_black, pre


@functools.lru_cache(maxsize=64)
def hjb_fields(problem, geom: LevelGeometry, device):
    """(HJB2DParams, the tensors it points to) on `device`: the update mask
    from `_plain_fields`' masks and row 0 of its coefficient fields, which
    depend on the column coordinate alone.  The tensors are the plain
    version's own values, so kernel and plain version read the same."""
    m_red, m_black, pre = _plain_fields(problem, geom, torch.float32, device)
    mask = ((m_red + m_black) > 0).to(torch.uint8).contiguous()
    cols = [pre[k][0].contiguous() for k in ("c1", "s1", "inv_in",
                                              "inv_act")]
    params = HJB2DParams(mask.data_ptr(), *(c.data_ptr() for c in cols),
                         1.0 / geom.spacing[1])
    return params, (mask, *cols)


def resident_relax_plain(v, f, nsweeps: int, problem, geom: LevelGeometry):
    """`nsweeps` red-black sweeps in place on v in the Pallas kernel's
    form (relax.py:129-137): v += m_color * (kernel_update(v, f) - v);
    f None drops the RHS term."""
    m_red, m_black, pre = _plain_fields(problem, geom, v.dtype, v.device)
    for _ in range(nsweeps):
        v.add_(m_red * (problem.kernel_update(v, f, pre, geom) - v))
        v.add_(m_black * (problem.kernel_update(v, f, pre, geom) - v))
    return v


def resident_relax(v, f, nsweeps: int, problem, geom: LevelGeometry):
    """`nsweeps` red-black sweeps in place on v (one launch); f None is
    the f-less leg (Lyapunov and Poisson).  The Lyapunov kernel runs on
    `layout(geom)`, the HJB kernel on `hjb_leg_layout(geom)`, the 2D
    Poisson one on `poisson_leg_layout(geom)`."""
    if tuple(v.shape) != tuple(geom.padded_shape) or geom.ndim != 2:
        raise ValueError(
            f"v {tuple(v.shape)} does not match 2D level {geom.padded_shape}"
        )
    fs = () if f is None else (f,)
    if fs and f.shape != v.shape:
        raise ValueError(f"f {tuple(f.shape)} vs v {tuple(v.shape)}")
    hjb = isinstance(problem, HJBMinTime)
    if hjb:
        check_hjb(problem)
        if not fs:
            raise ValueError("the HJB resident kernel takes f")
    if isinstance(problem, Poisson):
        return _resident_poisson(v, f, nsweeps, problem, geom)
    lay = None if hjb else layout(geom)
    if not hjb and lay is None:
        raise ValueError(
            f"level {geom.padded_shape} does not fit the resident kernel's "
            "cluster (relax2d.leg_layout)"
        )
    if not _on_cuda(v, *fs):
        return resident_relax_plain(v, f, nsweeps, problem, geom)
    if hjb:
        return _resident_hjb(v, f, nsweeps, problem, geom)
    if nsweeps < 1:
        return v
    params = lyap_params(problem, geom)
    X, Y = geom.padded_shape
    rc = build.load().lib.pdemg_resident2d(
        v.data_ptr(), f.data_ptr() if fs else None, X, Y, nsweeps, *lay,
        ctypes.addressof(params), _stream(),
    )
    launches["resident"] += 1
    build.check(rc, "resident")
    return v


def _resident_poisson(v, f, nsweeps: int, problem, geom: LevelGeometry):
    lay = poisson_leg_layout(geom)
    if lay is None:
        raise ValueError(
            f"level {geom.padded_shape} does not fit the dense leg kernel "
            f"({HJB_MAX_CTAS} CTAs of {MAX_SMEM_BYTES} B of shared memory "
            f"and {HJB_MAX_THREADS} threads): the slab kernel's level")
    params = poisson_params(problem, geom)
    if not _on_cuda(v, *(() if f is None else (f,))):
        return resident_relax_plain(v, f, nsweeps, problem, geom)
    if nsweeps < 1:
        return v
    lib = build.load().lib
    if lay.nctas > 1:
        check_cluster(lib.pdemg_resident2d_poisson_clusters, lay,
                      (lay.nctas, lay.threads, lay.smem_bytes),
                      "resident_poisson")
    rc = lib.pdemg_resident2d_poisson(
        v.data_ptr(), None if f is None else f.data_ptr(), nsweeps,
        ctypes.byref(lay), ctypes.byref(params), _stream(),
    )
    launches["resident_poisson"] += 1
    build.check(rc, "resident_poisson")
    return v


def _resident_hjb(v, f, nsweeps: int, problem, geom: LevelGeometry):
    lay = hjb_leg_layout(geom)
    if lay is None:
        raise ValueError(
            f"level {geom.padded_shape} does not fit the HJB resident "
            f"kernel ({HJB_MAX_CTAS} CTAs of {MAX_SMEM_BYTES} B of shared "
            f"memory and {HJB_MAX_THREADS} threads)"
        )
    if nsweeps < 1:
        return v
    params, _ = hjb_fields(problem, geom, v.device)
    lib = build.load().lib
    if lay.nctas > 1:
        check_cluster(lib.pdemg_resident2d_hjb_clusters, lay,
                      (lay.nctas, lay.threads, lay.smem_bytes),
                      "resident_hjb")
    rc = lib.pdemg_resident2d_hjb(
        v.data_ptr(), f.data_ptr(), nsweeps, ctypes.byref(lay),
        ctypes.byref(params), _stream(),
    )
    launches["resident_hjb"] += 1
    build.check(rc, "resident_hjb")
    return v
