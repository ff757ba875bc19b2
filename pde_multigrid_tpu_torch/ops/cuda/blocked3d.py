"""Blocked color-split red-black Gauss-Seidel on 3D wrap levels: the CUDA
kernel of `csrc/blocked3d.cu` and its plain PyTorch version.

Replaces the TPU kernel `pde_multigrid_tpu/ops/pallas/relax.py`
`make_split_slab_relax_2d` (float32, T sweeps per round trip), which the
JAX package plans only with the wavefront off (`PDE_MG_TIMESKEW=0`), on
the levels whose whole half-plane busts its row-9 slab budget
(`use_blocked`: 256^3 and 512^3 on the bench's rows).  Its bf16 `raw`
form, the inner smoother of JAX's mixed 2D-defect path (off in JAX,
`defect.DEFECT_2D`), is not ported.  Halves layout: that of
`ops/cuda/relax.py`.

The function is 2T half-sweeps of row 9's update (`relax.relax_halves`) in
row 9's order, so the kernel equals the half-sweep chain bit for bit, and
the plain version is the half-sweep chain's own.

Each wrapper launches its kernel for CUDA tensors, runs the plain version
for CPU tensors, and raises for anything else; there is no fallback from
a CUDA tensor to the plain version.  `launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from pde_multigrid_tpu_torch.grid import LevelGeometry
from pde_multigrid_tpu_torch.models.poisson import split_constants
from pde_multigrid_tpu_torch.ops.cuda import build
from pde_multigrid_tpu_torch.ops.cuda import relax as R

launches = {"blocked3d": 0}

# sweeps per launch: JAX's SPLIT_SWEEPS_PER_CALL (relax.py:3734), the T of
# its plan; the kernel takes 1 to MAX_T (JAX asserts T <= 4, relax.py:3480)
BLOCKED_T = 1
MAX_T = 4

# JAX's slab budget (relax.py:3727), against which its row-9 kernel's
# whole half-planes are measured
SLAB_VMEM_BUDGET = 12 * 2**20


# the kernel's launch (csrc/blocked3d.cu): its threads a CTA, its owned
# (j, z) tile by T (kBJ x kBZ at T = 1, TileOf above), the CTAs an SM
# holds by T (two where the form's registers and shared memory fit
# twice), and an H100 SXM's 132 SMs, which the tiles times the bands fill
# in one wave
THREADS = 256
TILE = {1: (16, 64), 2: (16, 32), 3: (8, 32), 4: (8, 32)}
CTAS_PER_SM = {1: 2, 2: 2, 3: 1, 4: 1}
NUM_SMS = 132


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


class Blocked3DLayout(ctypes.Structure):
    """The kernel's `Blocked3DLayout` (csrc/blocked3d.cu): the level's
    halves (X, Y2, Z), T, the owned (j, z) tile BJ x BZ and band of B x
    planes, the tiles along j and z and the bands along x, threads a CTA
    and shared memory bytes."""

    _fields_ = [(name, ctypes.c_int)
                for name in ("X", "Y2", "Z", "T", "BJ", "BZ", "B", "tj",
                             "tz", "bands", "threads", "smem_bytes")]

    def as_dict(self) -> dict:
        return {name: getattr(self, name) for name, _ in self._fields_}


@functools.lru_cache(maxsize=64)
def layout(X: int, Y2: int, Z: int, T: int) -> Blocked3DLayout:
    """The kernel's layout of a launch of T sweeps on (X, Y2, Z) halves:
    T's tile, and the fewest bands of x planes with which the tiles still
    fill the SMs in one wave (a band's 4T lead-in planes are read twice);
    its shared memory.  Cached: the wrapper asks at every launch."""
    if not 1 <= T <= MAX_T or min(X, Y2, Z) < 1:
        raise ValueError(f"no layout of T = {T} on ({X}, {Y2}, {Z}) halves")
    BJ, BZ = TILE[T]
    tj, tz = -(-Y2 // BJ), -(-Z // BZ)
    bands = max(1, min(X, NUM_SMS * CTAS_PER_SM[T] // (tj * tz)))
    B = -(-X // bands)
    bands = -(-X // B)
    LJ, LZ = BJ + 4 * T, BZ + 4 * T
    # T = 1: two double-buffered planes (static); above, the ring of 2T + 3
    # planes of four arrays and the tables (dynamic)
    smem = (16 * LJ * LZ if T == 1
            else 4 * 4 * (2 * T + 3) * LJ * LZ + 4 * (LJ + LZ))
    return Blocked3DLayout(X, Y2, Z, T, BJ, BZ, B, tj, tz, bands, THREADS,
                           smem)


def use_blocked(geom: LevelGeometry) -> bool:
    """Whether the wavefront-off plan gives this 3D wrap level row 19: JAX's
    row-9 budget test (relax.py:3968-3990) fails, so its `plan_relax`
    moves on to the blocked kernel (:3996-4022).  A level stays on row 9
    when some B in (16, 8, 4) has X % B == 0, X >= B + 4 and
    Y/2 * Z * 4 * 14 * (B + 5) <= 12 MiB (ext = B + 4 T, T = 1).  Its TPU
    lane conditions are dropped, as `relax.timeskew_plan` drops them."""
    X, Y, Z = geom.padded_shape
    half_plane = (Y // 2) * Z * 4
    return not any(
        X % B == 0 and X >= B + 4
        and half_plane * 14 * (B + 4 + 1) <= SLAB_VMEM_BUDGET
        for B in (16, 8, 4)
    )


def blocked_slab3d_plain(r, b, fr, fb, T: int, problem, geom: LevelGeometry):
    """(r, b) after T red-then-black sweeps (new tensors): row 9's plain
    chain (`relax.relax_halves_plain`) on copies, since the kernel
    computes the same function."""
    return R.relax_halves_plain(r.clone(), b.clone(), fr, fb, T, problem,
                                geom)


def blocked_chunk(r, b, fr, fb, T: int, problem, geom: LevelGeometry, out):
    """T sweeps on the level's halves (r, b) with RHS halves (fr, fb),
    written into `out` = (r_out, b_out), two halves apart from the inputs;
    returns `out`.  One launch of csrc/blocked3d.cu for CUDA tensors, the
    plain version for CPU tensors."""
    ins = (r, b, fr, fb)
    R._check_sweep_args(r, b, fr, geom)
    R._check_sweep_args(fb, *out, geom)
    if not 1 <= T <= MAX_T:
        raise ValueError(f"T = {T}: a launch runs 1 to {MAX_T} sweeps")
    if len({a.data_ptr() for a in out}) < 2 or any(
            o.data_ptr() == a.data_ptr() for o in out for a in ins):
        raise ValueError("the output halves alias the inputs or each other")
    if not R._on_cuda(*ins, *out):
        pr, pb = blocked_slab3d_plain(r, b, fr, fb, T, problem, geom)
        out[0].copy_(pr)
        out[1].copy_(pb)
        return out
    R._check_poisson(problem)
    lay = layout(*r.shape, T)
    (w0, w1, w2), inv_den = split_constants(geom)
    rc = build.load().lib.pdemg_blocked3d(
        *(a.data_ptr() for a in (*ins, *out)), ctypes.byref(lay), w0, w1,
        w2, inv_den, R._stream(),
    )
    launches["blocked3d"] += 1
    build.check(rc, "blocked3d")
    return out


def blocked_relax_halves(r, b, fr, fb, nsweeps: int, problem,
                         geom: LevelGeometry, T: int = BLOCKED_T):
    """(r, b) after `nsweeps` sweeps as JAX chains the kernel
    (`relax_raw`, relax.py:3693-3708): nsweeps // T launches of T, then
    one of nsweeps % T, each from the last one's halves, in two ping-pong
    pairs; the inputs are not written."""
    n_full, rem = divmod(nsweeps, T)
    bufs = [None, None]
    for k, t in enumerate([T] * n_full + [rem] * (rem > 0)):
        if bufs[k % 2] is None:
            bufs[k % 2] = (torch.empty_like(r), torch.empty_like(b))
        r, b = blocked_chunk(r, b, fr, fb, t, problem, geom, bufs[k % 2])
    return r, b


def make_blocked_relax(problem, geom: LevelGeometry):
    """relax(v, f, nsweeps) -> v for one 3D wrap level, as JAX's `relax`
    (relax.py:3713-3719): split v and f into halves, sweep, merge back
    into v's own storage in place."""
    R._halves_shape(geom.padded_shape)

    def relax(v, f, nsweeps: int):
        r, b = R.split(v)
        fr, fb = R.split(f)
        r, b = blocked_relax_halves(r, b, fr, fb, nsweeps, problem, geom)
        return R.merge(r, b, out=v)

    return relax
