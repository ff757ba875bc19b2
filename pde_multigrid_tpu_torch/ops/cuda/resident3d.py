"""Whole-leg red-black Gauss-Seidel on small 3D wrap-storage Poisson
levels: the CUDA kernel of `csrc/resident3d.cu`, its plain PyTorch
versions, and the gate that says which levels it holds.

Replaces three TPU kernels of `pde_multigrid_tpu/ops/pallas/relax.py`,
each a mode of the one kernel:

  * `make_merged_resident_relax` (row 4): dense v and f in and out, on the
    levels JAX's `plan_relax` gives it (3D wrap, Z < 128, Y Z % 128 == 0:
    64^3, 32^3, 16^3); `merged_resident_relax`, counted as
    `launches["merged_resident"]`;
  * `make_split_merged_relax` (row 5): the same leg on colour halves in
    and out, which JAX's plan never selects; `split_merged_relax`,
    `launches["split_merged"]`;
  * `make_resident_relax` (row 1) on 3D Poisson wrap levels below the
    merged gate (8^3, 4^3, 2^3): dense, one CTA; `resident3d_relax`,
    `launches["resident3d"]`.

All sweeps of a leg run in one launch with the level's v and f in
shared memory, on the fused subtree's relax leg (`csrc/halves3d.cuh`,
shared with `csrc/subtree.cu`): a level of more than 8^3 points on one
non-portable cluster of 16 CTAs, x-slabs whose edge planes the
neighbours bulk-copy into each other's halo planes every half-sweep
(64^3: 4 planes a CTA, 32^3: 2, 16^3: 1), 8^3 and below on one CTA
(`layout`).  A card that refuses the cluster makes the launch raise
(`cudaOccupancyMaxActiveClusters`, asked once per launch shape).
The merged (X, Y Z / 128, 128) view is TPU tiling only and has no
counterpart here.  The update is Poisson's `merged_update` (dense,
`v + m (upd - v)`, red x + y + z even first) or, on halves,
`split_update` with the half-sweep masks: the same arithmetic, so each
mode is bitwise its plain version and the row-9 half-sweep chain on the
card.

Each wrapper launches the kernel for CUDA tensors, runs the plain version
for CPU tensors, and raises for anything else; there is no fallback from
a CUDA tensor to the plain version.  v (or r, b) is updated in place on
both devices.  The gate `fits` is the kernel's capacity (one CTA, or one
cluster of 16 CTAs), not JAX's VMEM budget.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from pde_multigrid_tpu_torch.grid import LevelGeometry
from pde_multigrid_tpu_torch.models.poisson import split_constants
from pde_multigrid_tpu_torch.ops.cuda import build
from pde_multigrid_tpu_torch.ops.cuda import relax as R
from pde_multigrid_tpu_torch.ops.cuda.relax import (
    _check_poisson,
    _on_cuda,
    _stream,
)
from pde_multigrid_tpu_torch.ops.cuda.subtree import (
    CLUSTER_CTAS,
    MAX_SMEM_BYTES,
    RUN,
    THREADS,
    SubLevelParams,
    _split,
    check_cluster,
)

launches = {"merged_resident": 0, "split_merged": 0, "resident3d": 0}

# The layout is the fused subtree's (subtree.py): its 16-CTA cluster and
# shared memory a CTA, its cut of a level into x-slabs (`_split`), its
# runs of RUN planes and THREADS a CTA (a 64^3 leg on 1024 threads ran
# slower on the card: scripts/probe_resident_masked.py).  On one CTA a
# thread walks a single plane (the shortest chain a half-sweep).
ONE_CTA_RUN = 1
# a level of at most this many points keeps the port's first form, a point
# a thread (run 0): on 2^3 it beat the runs of one plane in the same call
# on the card (scripts/ab_rows.py resident3d; PERF.md section 6 row 1)
POINT_MAX_POINTS = 2**3


class Resident3DParams(ctypes.Structure):
    """csrc/resident3d.cu `Resident3DParams`."""

    _fields_ = [("lev", SubLevelParams)]
    _fields_ += [(n, ctypes.c_int) for n in
                 ("nsweeps", "halves", "threads", "smem_bytes", "halo_off",
                  "halo_plane", "run")]


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


# ------------------------------------------------------------ gates


def merged_gate(geom: LevelGeometry) -> bool:
    """JAX's gate of the merged-layout kernel (relax.py:3889-3896)
    without its VMEM budget: a 3D wrap level with Z < 128 and
    Y Z % 128 == 0."""
    if not (geom.wrap and geom.ndim == 3):
        return False
    _, Y, Z = geom.padded_shape
    return Z < 128 and (Y * Z) % 128 == 0


def layout(geom: LevelGeometry):
    """The kernel's layout of the level, or None when it cannot hold it:
    {"nctas": 1 or CLUSTER_CTAS, "smem_bytes": per CTA, "threads": per
    CTA, "halo": (float offset, floats a plane) of the 2 colours x 2 sides
    of halo planes, (0, 0) on one CTA, "run": the longest run of planes a
    thread walks, 0 for a point a thread}.  The kernel takes 3D wrap levels
    with power-of-two extents, v and f as colour halves in shared memory.
    A level the subtree splits (`subtree._split`: more than 8^3 points,
    at least one x-plane a CTA; and a half's plane a whole number of
    16-byte bulk copies) is cut into x-slabs over the cluster, each CTA
    holding its v and f and the halo planes; a smaller one lives on one
    CTA.  A thread runs a
    (run of up to `run` planes, z-pair) item of each colour, at most
    THREADS: runs of RUN planes on a split level, ONE_CTA_RUN on one CTA,
    and a point a thread (the port's first form) on a level of at most
    POINT_MAX_POINTS points."""
    if not (geom.wrap and geom.ndim == 3):
        return None
    shape = geom.padded_shape
    if any(n < 2 or n & (n - 1) for n in shape):
        return None
    X, Y, Z = shape
    pts = X * Y * Z
    # a half's plane goes to a neighbour as a whole number of 16-byte
    # bulk copies
    split = _split(geom, CLUSTER_CTAS) and (Y * Z // 2) % 4 == 0
    nctas = CLUSTER_CTAS if split else 1
    held = pts // nctas
    halo = (2 * held, Y * Z // 2) if split else (0, 0)
    smem = 4 * (2 * held + 4 * halo[1])
    if smem > MAX_SMEM_BYTES:
        return None
    planes = X // nctas
    run = (RUN if split else 0 if pts <= POINT_MAX_POINTS
           else ONE_CTA_RUN)
    items = (held // 2 if run == 0
             else planes // min(run, planes) * (Y * Z // 4))
    threads = min(THREADS, max(32, -(-items // 32) * 32))
    return {"nctas": nctas, "smem_bytes": smem, "threads": threads,
            "halo": halo, "run": run}


def fits(geom: LevelGeometry) -> bool:
    """Whether the kernel holds the level."""
    return layout(geom) is not None


def one_cta(geom: LevelGeometry) -> bool:
    """Whether the kernel holds the level on one CTA: row 1's 3D mode."""
    lay = layout(geom)
    return lay is not None and lay["nctas"] == 1


@functools.lru_cache(maxsize=None)
def _params(geom: LevelGeometry, nsweeps: int,
            halves: bool) -> Resident3DParams:
    lay = layout(geom)
    (w0, w1, w2), inv_den = split_constants(geom)
    X, Y, Z = geom.padded_shape
    lx, ly, lz = (n.bit_length() - 1 for n in (X, Y, Z))
    lev = SubLevelParams(lx, ly, lz, lay["nctas"], 0,
                         X * Y * Z // lay["nctas"], w0, w1, w2, inv_den)
    return Resident3DParams(lev=lev, nsweeps=nsweeps, halves=int(halves),
                            threads=lay["threads"],
                            smem_bytes=lay["smem_bytes"],
                            halo_off=lay["halo"][0],
                            halo_plane=lay["halo"][1], run=lay["run"])


# ------------------------------------------------------ plain versions


@R._cached
def _masks(X: int, Y: int, Z: int, device):
    """(m_red, m_black) float32 (X, Y, Z): the interior x, y, z >= 1 of
    parity x + y + z even / odd (relax.py:624-633), built on the device
    (a CUDA graph capture may call it)."""
    x = torch.arange(X, device=device)[:, None, None]
    y = torch.arange(Y, device=device)[None, :, None]
    z = torch.arange(Z, device=device)[None, None, :]
    interior = (x >= 1) & (y >= 1) & (z >= 1)
    par = (x + y + z) % 2
    return (((par == 0) & interior).to(torch.float32),
            ((par == 1) & interior).to(torch.float32))


def _roll(a, ax, off):
    return torch.roll(a, -off, dims=ax)


def merged_resident_plain(v, f, nsweeps: int, problem, geom: LevelGeometry):
    """`nsweeps` dense masked red-black sweeps of Poisson.merged_update
    with torch.roll on (X, Y, Z): v + m_red (upd - v), then black, as
    `make_merged_resident_relax` computes them (relax.py:635-643) and, with
    kernel_update's identical arithmetic, `make_resident_relax` on a 3D
    wrap level.  In any float dtype; a new tensor, the inputs are not
    written."""
    m_red, m_black = _masks(*v.shape, v.device)
    for _ in range(nsweeps):
        v = v + m_red * (problem.merged_update(v, f, _roll, geom) - v)
        v = v + m_black * (problem.merged_update(v, f, _roll, geom) - v)
    return v


def split_merged_plain(r, b, fr, fb, nsweeps: int, problem,
                       geom: LevelGeometry):
    """(r, b) after `nsweeps` red-then-black sweeps on colour halves, as
    `make_split_merged_relax` computes them (relax.py:737-753): the row-9
    plain sweeps `relax.relax_halves_plain`, u + m (split_update - u), on
    clones.  New tensors; the inputs are not written."""
    return R.relax_halves_plain(r.clone(), b.clone(), fr, fb, nsweeps,
                                problem, geom)


# ------------------------------------------------------------ wrappers


def _check(ts, shape, geom: LevelGeometry, nsweeps: int, what: str) -> bool:
    """The operands' shapes and the level, checked before a leg; True for
    CUDA tensors (`relax._on_cuda`)."""
    if not (geom.wrap and geom.ndim == 3):
        raise ValueError(f"{what} serves 3D wrap levels only")
    if any(tuple(t.shape) != tuple(shape) for t in ts):
        raise ValueError(f"{what}: operands {[tuple(t.shape) for t in ts]}, "
                         f"level {geom.padded_shape} wants {tuple(shape)}")
    if nsweeps < 0:
        raise ValueError(f"nsweeps {nsweeps}")
    if not fits(geom):
        raise ValueError(f"{what}: the kernel cannot hold level "
                         f"{geom.padded_shape} (power-of-two extents, one "
                         f"CTA or one cluster of {CLUSTER_CTAS} CTAs)")
    return _on_cuda(*ts)


def _launch(name, v, vb, f, fb, nsweeps, problem, geom, halves):
    _check_poisson(problem)
    params = _params(geom, nsweeps, halves)
    if params.lev.nctas > 1:
        check_cluster(build.load().lib.pdemg_resident3d_clusters, params,
                      (params.lev.nctas, params.threads, params.smem_bytes),
                      "resident3d")
    rc = build.load().lib.pdemg_resident3d(
        v.data_ptr(), None if vb is None else vb.data_ptr(), f.data_ptr(),
        None if fb is None else fb.data_ptr(), ctypes.byref(params),
        _stream())
    launches[name] += 1
    build.check(rc, name)


def _dense_leg(name, v, f, nsweeps, problem, geom):
    if not _check((v, f), geom.padded_shape, geom, nsweeps, name):
        return v.copy_(merged_resident_plain(v, f, nsweeps, problem, geom))
    if nsweeps:
        _launch(name, v, None, f, None, nsweeps, problem, geom, False)
    return v


def merged_resident_relax(v, f, nsweeps: int, problem, geom: LevelGeometry):
    """Row 4: `nsweeps` sweeps on the dense level, v in place; the levels
    of `merged_gate` that the kernel holds."""
    if not merged_gate(geom):
        raise ValueError(f"level {geom.padded_shape} is outside the merged "
                         "gate (Z < 128, Y Z % 128 == 0)")
    return _dense_leg("merged_resident", v, f, nsweeps, problem, geom)


def resident3d_relax(v, f, nsweeps: int, problem, geom: LevelGeometry):
    """Row 1's 3D mode: `nsweeps` sweeps on a dense level the kernel holds
    on one CTA, v in place."""
    if not one_cta(geom):
        raise ValueError(f"level {geom.padded_shape} does not fit one CTA "
                         "of the resident kernel")
    return _dense_leg("resident3d", v, f, nsweeps, problem, geom)


def split_merged_relax(r, b, fr, fb, nsweeps: int, problem,
                       geom: LevelGeometry):
    """Row 5: `nsweeps` sweeps on the colour halves (X, Y/2, Z) of a level
    of `merged_gate`, r and b in place."""
    if not merged_gate(geom):
        raise ValueError(f"level {geom.padded_shape} is outside the merged "
                         "gate (Z < 128, Y Z % 128 == 0)")
    shape = R._halves_shape(geom.padded_shape)
    if not _check((r, b, fr, fb), shape, geom, nsweeps, "split_merged"):
        ro, bo = split_merged_plain(r, b, fr, fb, nsweeps, problem, geom)
        r.copy_(ro)
        b.copy_(bo)
        return r, b
    if nsweeps:
        _launch("split_merged", r, b, fr, fb, nsweeps, problem, geom, True)
    return r, b
