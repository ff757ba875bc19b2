"""The fused coarse-subtree V-cycle on 3D wrap levels: the CUDA kernel of
`csrc/subtree.cu`, its plain PyTorch version, and the plan that places it.

Replaces the TPU kernel `pde_multigrid_tpu/ops/pallas/subtree.py` `_build`
(planned by its `plan_fused_cycles`): one launch runs a whole V-cycle
(or, with mu > 1, a W-cycle: each correction visits the next level mu
times) rooted at a small level, every deeper level held on chip, or only
the coarse-grid correction of the root (`with_root_relax=False`).  In the
correction scheme the levels below the root are temporaries of the
V-cycle (their v is zeroed and their f overwritten before every use), so
the kernel keeps them out of device memory altogether; `cycles.py`
consults the tier's `fused_vcycle` / `fused_correction` hooks.

The plain version composes the CUDA tier's existing plain versions in the
order of JAX's `_build` (`vcyc` / `correction`): the split half-sweeps
(`relax.half_sweep_plain` on `split_colors` halves, then `merge_colors`),
`transfer.residual_restrict_plain`, the coarse v zeroed, the recursion,
`transfer.prolong_blend_plain` in 'add' mode.

The wrapper launches the kernel for CUDA tensors, runs the plain version
for CPU tensors, and raises for anything else; there is no fallback from
a CUDA tensor to the plain version.  It updates v in place on both
devices.  `launches` counts kernel launches.

The TPU's VMEM budgets have no Hopper counterpart.  The plan's gate is
the kernel's capacity, `CAPACITY`: the shared memory of one 16-CTA
cluster (non-portable: the launch raises where the card refuses it,
never falls back to a smaller one).  `layout` places a subtree in it
(the kernel's only layout: every level's v and f in shared memory, but
the correction-only variant's root f) or says it does not fit.  The
variant's root v counts, so the capacity decides what JAX's budgets do:
roots up to 64^3 fused, the correction-only variant nowhere (a 128^3
root's v alone would take 512 KB a CTA).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from pde_multigrid_tpu_torch.grid import LevelGeometry
from pde_multigrid_tpu_torch.models.poisson import Poisson, split_constants
from pde_multigrid_tpu_torch.ops.cuda import build
from pde_multigrid_tpu_torch.ops.cuda import relax as R
from pde_multigrid_tpu_torch.ops.cuda import transfer as T
from pde_multigrid_tpu_torch.ops.cuda.relax import (
    _check_poisson,
    _on_cuda,
    _stream,
)

launches = {"subtree": 0}

# the kernel's cluster: CTAs, and the dynamic shared memory each may hold
# (227 KB less the 16 B of csrc/subtree.cu's two halo mbarriers)
CLUSTER_CTAS = 16
MAX_SMEM_BYTES = 232448 - 16
# the plan's gate: a subtree fits when its layout needs at most
# CAPACITY / CLUSTER_CTAS bytes on each CTA
CAPACITY = CLUSTER_CTAS * MAX_SMEM_BYTES
# a level of at most this many points lives whole on CTA 0 (block
# barriers); larger levels are cut into x-slabs over the cluster (16^3 one
# plane a CTA: faster on the card than whole on CTA 0)
LOCAL_MAX_POINTS = 8**3
THREADS = 512
# the longest run of z-pairs a thread of a half-sweep walks along x
RUN = 4
MAX_LEVELS = 8


class SubLevelParams(ctypes.Structure):
    """csrc/subtree.cu `SubLevel`."""

    _fields_ = [(n, ctypes.c_int) for n in
                ("lx", "ly", "lz", "nctas", "v_off", "f_off")]
    _fields_ += [(n, ctypes.c_float) for n in ("w0", "w1", "w2", "inv_den")]


class SubtreeParams(ctypes.Structure):
    """csrc/subtree.cu `SubtreeParams`."""

    _fields_ = [(n, ctypes.c_int) for n in
                ("nlev", "nu1", "nu2", "mu", "with_root_relax", "nctas",
                 "threads", "smem_bytes", "halo_off", "halo_plane")]
    _fields_ += [("lev", SubLevelParams * MAX_LEVELS)]


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


# ------------------------------------------------------------ layout


def subtree_ok(problem, geoms) -> bool:
    """The kernel serves 3D wrap Poisson subtrees of at most MAX_LEVELS
    levels, each level half its parent on every axis."""
    geoms = tuple(geoms)
    return (
        isinstance(problem, Poisson)
        and 1 <= len(geoms) <= MAX_LEVELS
        and all(g.wrap and g.ndim == 3 for g in geoms)
        and all(n >= 2 and n & (n - 1) == 0
                for g in geoms for n in g.padded_shape)
        and all(tuple(f.padded_shape) == tuple(2 * n for n in c.padded_shape)
                for f, c in zip(geoms, geoms[1:]))
    )


def _points(g: LevelGeometry) -> int:
    X, Y, Z = g.padded_shape
    return X * Y * Z


def _split(g: LevelGeometry, ctas: int) -> bool:
    """Whether the level is cut into x-slabs over a cluster of `ctas`."""
    return g.padded_shape[0] >= ctas and _points(g) > LOCAL_MAX_POINTS


def layout(geoms, with_root_relax: bool, capacity: int | None = None,
           ctas: int = CLUSTER_CTAS):
    """The kernel's layout of the subtree `geoms` (root first), or None
    when it does not fit `capacity` (default CAPACITY): a dict with the
    launch's CTAs and threads, the shared memory per CTA, and per level
    its CTAs (the cluster's: x-slabs; 1: whole on CTA 0) and the float
    offsets of its v and f in shared memory (-1: device memory), and
    "halo": the float offset and the plane size of the halo planes a split
    level's half-sweeps exchange (2 colours x 2 sides; (0, 0) on one CTA).
    A split root takes a cluster of `ctas` (16: at the 32^3 root faster
    than 8 on the card, `chip_smoke.py` times both; a 64^3 root's v and f
    fit 16 only).  Every level's v and f are in shared
    memory, the root's loaded once, but for the correction-only variant's
    root f, which the residual reads once from device memory."""
    geoms = tuple(geoms)
    limit = (CAPACITY if capacity is None else capacity) // CLUSTER_CTAS
    cluster = _split(geoms[0], ctas)
    nctas = [ctas if cluster and _split(g, ctas) else 1 for g in geoms]
    held = [_points(g) // n for g, n in zip(geoms, nctas)]
    offs, off = [], 0
    for k, n in enumerate(held):
        v_off, off = off, off + n
        f_off = -1
        if k or with_root_relax:
            f_off, off = off, off + n
        offs.append((v_off, f_off))
    halo = (0, 0)
    if cluster:  # 4 halo planes, each a half's plane of the root
        halo = (off, _points(geoms[0]) // geoms[0].padded_shape[0] // 2)
        off += 4 * halo[1]
    if 4 * off > limit:
        return None
    # a thread per run of up to RUN x 2 points (along x, a z-pair) of each
    # colour, at most THREADS: the small levels' barriers then span few
    # warps
    per = max(n // (4 * min(RUN, g.padded_shape[0] // c))
              for n, g, c in zip(held, geoms, nctas))
    threads = min(THREADS, max(32, -(-per // 32) * 32))
    return {"nctas": ctas if cluster else 1, "threads": threads,
            "smem_bytes": 4 * off, "halo": halo,
            "levels": [(n, v, f) for n, (v, f) in zip(nctas, offs)]}


@functools.lru_cache(maxsize=None)
def _params(geoms, nu1: int, nu2: int, with_root_relax: bool,
            capacity: int, ctas: int = CLUSTER_CTAS,
            mu: int = 1) -> SubtreeParams:
    lay = layout(geoms, with_root_relax, capacity, ctas)
    if lay is None:
        raise ValueError(
            f"the subtree rooted at {geoms[0].padded_shape} does not fit "
            f"the kernel's shared memory ({capacity} B over "
            f"{CLUSTER_CTAS} CTAs)")
    p = SubtreeParams(nlev=len(geoms), nu1=nu1, nu2=nu2, mu=mu,
                      with_root_relax=int(with_root_relax),
                      nctas=lay["nctas"], threads=lay["threads"],
                      smem_bytes=lay["smem_bytes"], halo_off=lay["halo"][0],
                      halo_plane=lay["halo"][1])
    for k, (g, (nct, v_off, f_off)) in enumerate(zip(geoms, lay["levels"])):
        (w0, w1, w2), inv_den = split_constants(g)
        lx, ly, lz = (n.bit_length() - 1 for n in g.padded_shape)
        p.lev[k] = SubLevelParams(lx, ly, lz, nct, v_off, f_off, w0, w1, w2,
                                  inv_den)
    return p


# the kernels and launch shapes (CTAs, threads, shared memory) the card
# runs a cluster of
_CLUSTERS_OK: set = set()


def check_cluster(fn, params, shape, what: str) -> None:
    """Raise unless the card runs a cluster of the launch `params` of
    `shape` (CTAs, threads, shared memory): asked once per kernel and
    shape, at its first call, through `fn` (the kernel's
    cudaOccupancyMaxActiveClusters entry point).  Shared with
    resident3d.py, whose 16-CTA leg is this kernel's."""
    if (what, shape) in _CLUSTERS_OK:
        return
    clusters = ctypes.c_int(0)
    build.check(fn(ctypes.byref(params), ctypes.byref(clusters)),
                f"{what} (cudaOccupancyMaxActiveClusters)")
    if clusters.value < 1:
        raise RuntimeError(
            f"the card runs no cluster of {shape[0]} CTAs of {shape[1]} "
            f"threads and {shape[2]} B of shared memory each (the {what} "
            "kernel's launch); there is no smaller layout to fall back to")
    _CLUSTERS_OK.add((what, shape))


def _launch(v, f, params: SubtreeParams) -> None:
    """One launch of the kernel on the root's dense v (updated in place)
    and f, CUDA tensors the wrapper checked."""
    if params.nctas > 1:
        check_cluster(build.load().lib.pdemg_subtree_clusters, params,
                      (params.nctas, params.threads, params.smem_bytes),
                      "subtree")
    rc = build.load().lib.pdemg_subtree(v.data_ptr(), f.data_ptr(),
                                        ctypes.byref(params), _stream())
    launches["subtree"] += 1
    build.check(rc, "subtree")


# ------------------------------------------------------ plain version


def _relax_plain(v, f, problem, geom: LevelGeometry, nsweeps: int):
    """The port's split relax leg: split, red-then-black half-sweeps,
    merge (no leg when nsweeps is 0)."""
    if nsweeps == 0:
        return v
    r, b = R.split_colors(v)
    fr, fb = R.split_colors(f)
    for _ in range(nsweeps):
        R.half_sweep_plain(r, b, fr, R.RED, problem, geom)
        R.half_sweep_plain(b, r, fb, R.BLACK, problem, geom)
    return R.merge_colors(r, b)


def subtree_vcycle_plain(v, f, problem, geoms, nu1: int, nu2: int,
                         with_root_relax: bool = True, mu: int = 1):
    """The cycle rooted at geoms[0] (or, without `with_root_relax`, its
    coarse-grid correction alone) from the tier's plain versions, in the
    order of JAX's `_build` (`vcyc`, `correction`, subtree.py:593-616):
    each correction visits the next level `mu` times (1: a V-cycle, 2: a
    W-cycle) from cv = 0.  In any float dtype; a new tensor, the inputs
    are not written."""
    geoms = tuple(geoms)

    def correction(k, v, f):
        cf = T.residual_restrict_plain(v, f, problem, geoms[k], geoms[k + 1],
                                       True)
        cv = torch.zeros_like(cf)
        for _ in range(mu):
            cv = vcycle(k + 1, cv, cf)
        return T.prolong_blend_plain(cv, v, "add")

    def vcycle(k, v, f):
        v = _relax_plain(v, f, problem, geoms[k], nu1)
        if k + 1 < len(geoms):
            v = correction(k, v, f)
        return _relax_plain(v, f, problem, geoms[k], nu2)

    if with_root_relax:
        return vcycle(0, v, f)
    if len(geoms) < 2:
        raise ValueError("a coarse-grid correction needs a coarser level")
    return correction(0, v, f)


# ------------------------------------------------------------ wrapper


def subtree_vcycle(v, f, problem, geoms, nu1: int, nu2: int,
                   with_root_relax: bool = True, mu: int = 1):
    """One cycle rooted at geoms[0] (or its coarse-grid correction alone)
    on the root's dense v and f, each level below the root visited `mu`
    times a correction (1: a V-cycle, 2: a W-cycle), written into v in
    place; returns v.  Every deeper level is a temporary of the call."""
    if mu < 1:
        raise ValueError(f"mu={mu}: the fused cycle visits each coarser "
                         "level at least once")
    geoms = tuple(geoms)
    if not all(g.wrap and g.ndim == 3 for g in geoms):
        raise ValueError("the subtree kernel serves 3D wrap levels only")
    if not subtree_ok(problem, geoms):
        raise ValueError(
            f"no subtree kernel for {type(problem).__name__} on "
            f"{[g.padded_shape for g in geoms]}")
    if not with_root_relax and len(geoms) < 2:
        raise ValueError("a coarse-grid correction needs a coarser level")
    for t, what in ((v, "v"), (f, "f")):
        if tuple(t.shape) != tuple(geoms[0].padded_shape):
            raise ValueError(f"{what} shape {tuple(t.shape)} != root "
                             f"{geoms[0].padded_shape}")
    if min(nu1, nu2) < 0:
        raise ValueError(f"negative sweep counts {nu1}, {nu2}")
    if not _on_cuda(v, f):
        return v.copy_(subtree_vcycle_plain(v, f, problem, geoms, nu1, nu2,
                                            with_root_relax, mu))
    _check_poisson(problem)
    _launch(v, f, _params(geoms, nu1, nu2, bool(with_root_relax), CAPACITY,
                          mu=mu))
    return v


# --------------------------------------------------------------- plan


def plan_fused_cycles(problem, geoms, cycle, dtype=torch.float32):
    """(vfns, cfns), each a per-level list, the counterpart of JAX's
    `plan_fused_cycles` (subtree.py:824): vfns[l](v, f) runs the whole
    cycle (V or W: `cycle.mu` visits a level) rooted at level l, cfns[l](v,
    f) only its coarse-grid correction (the caller relaxes), each updating
    v in place.  None where no kernel is planned: a level whose subtree is
    not 3D wrap Poisson, a cycle other than red-black Gauss-Seidel in the
    correction scheme with mu >= 1 and the relaxed coarsest level, another
    dtype than float32, or a subtree the kernel's shared memory does not
    hold.  cfns[l] is
    planned where JAX's rule puts it: vfns[l] is None and vfns[l + 1] is
    set (the correction variant needs only the deeper levels on chip).

    One documented difference: with coarsest="exact" nothing is fused.
    JAX fuses an in-kernel fast-diagonalization coarsest level at coarsest
    levels of at most 32^3; the port's kernel has none yet (ROADMAP.md
    queue 2 item 13)."""
    n = len(geoms)
    vfns: list = [None] * n
    cfns: list = [None] * n
    if (cycle is None or cycle.smoother != "rbgs" or cycle.scheme != "cs"
            or cycle.coarsest != "relax" or cycle.mu < 1
            or dtype != torch.float32):
        return vfns, cfns
    for l in range(n - 1, -1, -1):
        sub = tuple(geoms[l:])
        if not subtree_ok(problem, sub):
            continue
        if layout(sub, True) is not None:
            vfns[l] = functools.partial(
                subtree_vcycle, problem=problem, geoms=sub, nu1=cycle.nu1,
                nu2=cycle.nu2, with_root_relax=True, mu=cycle.mu)
        elif (l + 1 < n and vfns[l + 1] is not None
              and layout(sub, False) is not None):
            cfns[l] = functools.partial(
                subtree_vcycle, problem=problem, geoms=sub, nu1=cycle.nu1,
                nu2=cycle.nu2, with_root_relax=False, mu=cycle.mu)
    return vfns, cfns
