"""Whole-leg dense red-black Gauss-Seidel on small padded 2D levels (the
2D Lyapunov equation and the HJB equation's upwind scheme): the CUDA
kernels and their plain PyTorch version.

Replaces the TPU kernel `pde_multigrid_tpu/ops/pallas/relax.py`
`make_resident_relax`: all sweeps of a relax leg in one launch, the level
held on chip for the whole leg (`fits` / `hjb_ctas` say whether a level
fits).  Lyapunov runs the dense form of the colour slab's leg
(csrc/color_slab2d_shard.cu, `pdemg_resident2d`): the level in x bands
on the largest cluster of at most 16 CTAs that holds it
(`relax2d.leg_layout`: 16, 15 and 9 CTAs at 257^2, 129^2 and 65^2; one
CTA on levels no cluster fits), each band kept as colour halves in shared
memory, split from the dense rows on load and merged on store, its
coefficients (and f a_f) in registers, block barriers between
half-sweeps and one cluster barrier every 4 sweeps, when each band's
first 8 rows are pushed into its left neighbour as its halo.  HJB
(csrc/resident.cu) runs on one CTA up to 33^2 and on a cluster of 8 CTAs
from 65^2 to 257^2 (`hjb_ctas`).  The update is the Pallas kernel's
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
from pde_multigrid_tpu_torch.ops.cuda import build
from pde_multigrid_tpu_torch.ops.cuda.relax import _on_cuda, _stream
from pde_multigrid_tpu_torch.ops.cuda.relax2d import leg_layout, lyap_params

launches = {"resident": 0, "resident_hjb": 0}

# the cluster the HJB kernel runs on from 65^2 up: CTAs, and the shared
# memory one may hold
CLUSTER_CTAS = 8
MAX_SMEM_BYTES = 232448
# the largest level the HJB kernel runs on one CTA: one whose colors each
# fit one pass of its 1024 threads (33^2 and below).  Measured on an H100
# (PERF.md, Findings), one CTA wins there (block barriers), and the 8-CTA
# cluster wins from 65^2 up (one SM's throughput, not the barrier, bounds
# the larger levels)
ONE_CTA_MAX_SLOTS = 1024


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


def hjb_smem_bytes(geom: LevelGeometry, ctas: int) -> int:
    """Shared memory per CTA of the HJB kernel on `ctas` CTAs: v, f and
    the mask byte for ceil(X / ctas) rows, and four coefficient columns."""
    X, Y = geom.padded_shape
    rows = -(-X // ctas)
    return rows * Y * 9 + 4 * Y * 4


def hjb_ctas(geom: LevelGeometry) -> int | None:
    """The CTAs the HJB kernel runs the level on: one where a color's
    slots fit one pass of 1024 threads, else the 8-CTA cluster; None when
    the cluster cannot hold it (513^2: the slab kernel's level)."""
    if geom.ndim != 2 or geom.wrap:
        return None
    X, Y = geom.padded_shape
    if X * -(-Y // 2) <= ONE_CTA_MAX_SLOTS:
        return 1
    return (CLUSTER_CTAS
            if hjb_smem_bytes(geom, CLUSTER_CTAS) <= MAX_SMEM_BYTES else None)


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
    the f-less leg (Lyapunov only).  The Lyapunov kernel runs on
    `layout(geom)`, the HJB kernel on `hjb_ctas(geom)` CTAs."""
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


def _resident_hjb(v, f, nsweeps: int, problem, geom: LevelGeometry):
    ctas = hjb_ctas(geom)
    if ctas is None:
        raise ValueError(
            f"level {geom.padded_shape} does not fit the HJB resident "
            f"kernel's {CLUSTER_CTAS} x {MAX_SMEM_BYTES} B of shared memory"
        )
    if nsweeps < 1:
        return v
    params, _ = hjb_fields(problem, geom, v.device)
    X, Y = geom.padded_shape
    rc = build.load().lib.pdemg_resident2d_hjb(
        v.data_ptr(), f.data_ptr(), X, Y, ctas, nsweeps,
        ctypes.addressof(params), _stream(),
    )
    launches["resident_hjb"] += 1
    build.check(rc, "resident_hjb")
    return v
