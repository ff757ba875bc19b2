"""Color-split red-black Gauss-Seidel on 3D wrap levels: the CUDA kernels
of `csrc/relax.cu` and `csrc/timeskew.cu` and their plain PyTorch
versions (the blocked kernel that serves the large levels with the
wavefront off, row 19, is `ops/cuda/blocked3d.py`).

Replaces the TPU kernels `pde_multigrid_tpu/ops/pallas/relax.py`
`_pallas_split`, `_pallas_merge`, `make_split_slab_relax` (float32
sweeps of the iterate, one half-sweep per launch here),
`make_split_timeskew_relax` and `make_split_timeskew_relax_jb` (float32
sweeps of the iterate, T sweeps per launch: the time-skewed wavefront on
the large levels), `make_split_timeskew_relax_shard` (the same wavefront
on one shard's extended slab, for `parallel/halo.py`) and
`make_split_resident_sweeps` (bf16 sweeps of the error equation from
zero, for `ops/cuda/defect.py`: a whole leg a launch with the halves on
chip where they fit, `error_leg`, else the wavefront's error mode,
`error_timeskew`; `error_form` picks).  Halves layout: a
dense (X, Y, Z) level becomes red/black (X, Y/2, Z) arrays; with
q = (x + z) % 2, red (parity 0) sits at y = 2j + q and black at
y = 2j + 1 - q.

Each wrapper launches its kernel for CUDA tensors, runs the plain version
for CPU tensors, and raises for anything else; there is no fallback from
a CUDA tensor to the plain version.  `launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
import os

import torch

from pde_multigrid_tpu_torch.grid import LevelGeometry
from pde_multigrid_tpu_torch.models.poisson import (
    Poisson,
    folded_constants,
    split_constants,
)
from pde_multigrid_tpu_torch.ops.cuda import build

RED, BLACK = 0, 1

# the smallest half-plane (Y/2 * Z points) the wavefront takes: the JAX
# package's crossover, measured on the TPU (relax.py:3842-3853,
# timeskew_plan); the card's own crossover is ROADMAP queue 2 item 39
TIMESKEW_MIN_PLANE = 16384
# sweeps per wavefront launch, from an A/B on the card at 256^3 and 512^3
# (PERF.md); csrc/timeskew.cu is built for T = 1 ... TIMESKEW_MAX_T, the
# smaller ones serving the remainder launch of a leg
TIMESKEW_T = 4
TIMESKEW_MAX_T = 4
# the wavefront's launch limits: threads per CTA, CTAs per cluster
# (non-portable past 8: the launch raises where the card refuses it), and
# the dynamic shared memory a CTA may hold (227 KB less the 16 B of its
# two halo mbarriers)
TIMESKEW_THREADS = 512
TIMESKEW_CTAS = 16
TIMESKEW_SMEM_BYTES = 232448 - 16
# the resident clusters `timeskew_layout` assumes where no card is asked
# (the wrapper asks the card once per launch shape)
TIMESKEW_CLUSTERS = 8

# the error leg's launch limits: threads per CTA, the dynamic shared memory
# a CTA may hold (227 KB), and the SMs `error_leg_layout` assumes where no
# card is asked (the H100 SXM's; the wrapper asks the card)
ERROR_LEG_THREADS = 1024
ERROR_LEG_SMEM_BYTES = 232448
ERROR_LEG_SMS = 132
# the most x planes a block of the error leg holds (csrc/relax.cu
# kLegMaxPlanes: a thread keeps a j face's word a plane in registers)
ERROR_LEG_MAX_PLANES = 4

launches = {"split": 0, "merge": 0, "half_sweep": 0, "error_sweep": 0,
            "error_leg": 0, "error_timeskew": 0, "timeskew": 0,
            "timeskew_shard": 0}
# wavefront launches by the level's halves shape (X, Y/2, Z), counted at
# the same place as launches["timeskew"]
timeskew_by_level: dict[tuple[int, int, int], int] = {}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0
    timeskew_by_level.clear()


# ------------------------------------------------------------ checks


def _on_cuda(*ts: torch.Tensor, dtype=torch.float32) -> bool:
    """True for CUDA tensors (kernel), False for CPU tensors (plain
    version); raises on mixed or other devices, tensors not of `dtype`
    (the one the wrapper's kernel takes) or non-contiguous tensors."""
    dev = ts[0].device
    for t in ts:
        if t.device != dev:
            raise ValueError(f"tensors on {t.device} and {dev}")
        if t.dtype != dtype:
            raise TypeError(
                f"kernels take {str(dtype).removeprefix('torch.')}, "
                f"got {t.dtype}"
            )
        if not t.is_contiguous():
            raise ValueError("kernels take contiguous tensors")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    if dev.index != torch.cuda.current_device():
        raise ValueError(
            f"tensor on {dev} but the current CUDA device is "
            f"{torch.cuda.current_device()}"
        )
    return True


def _check_poisson(problem) -> None:
    """The kernels hard-code the Poisson (2d+1)-point stencil."""
    if not isinstance(problem, Poisson):
        raise TypeError(
            "the CUDA kernels implement the Poisson stencil; "
            f"got {type(problem).__name__}"
        )


def _halves_shape(v_shape) -> tuple[int, int, int]:
    if len(v_shape) != 3 or v_shape[1] % 2:
        raise ValueError(f"need a 3D level with even Y, got {tuple(v_shape)}")
    X, Y, Z = v_shape
    return X, Y // 2, Z


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


# ------------------------------------------------------ plain versions


def _roll(a, ax, off):
    return torch.roll(a, -off, dims=ax)


def _cached(fn):
    """`fn(*shape, device)` cached by its arguments: the plain versions
    would otherwise rebuild their index masks at every call, which more
    than doubles their PyTorch operations.  Nothing is cached while a CUDA
    graph is being captured (the tensors would live in the graph's
    memory pool)."""
    cached = functools.lru_cache(maxsize=16)(fn)

    @functools.wraps(fn)
    def get(*args):
        dev = torch.device(args[-1])
        if dev.type == "cuda" and torch.cuda.is_current_stream_capturing():
            return fn(*args)
        return cached(*args[:-1], dev)

    return get


@_cached
def _qmask(X: int, Z: int, device) -> torch.Tensor:
    """bool (X, 1, Z): q(x, z) = (x + z) % 2 == 1."""
    x = torch.arange(X, device=device)[:, None, None]
    z = torch.arange(Z, device=device)[None, None, :]
    return (x + z) % 2 == 1


def split_colors(v: torch.Tensor):
    """(X, Y, Z) dense -> (r, b) color-split (X, Y/2, Z) tensors
    (relax.py:853)."""
    X, Y2, Z = _halves_shape(v.shape)
    qb = _qmask(X, Z, v.device)
    v4 = v.reshape(X, Y2, 2, Z)
    v0, v1 = v4[:, :, 0, :], v4[:, :, 1, :]
    return torch.where(qb, v1, v0), torch.where(qb, v0, v1)


def merge_colors(r: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Inverse of split_colors (relax.py:861)."""
    X, Y2, Z = r.shape
    qb = _qmask(X, Z, r.device)
    v0 = torch.where(qb, b, r)
    v1 = torch.where(qb, r, b)
    return torch.stack([v0, v1], dim=2).reshape(X, 2 * Y2, Z)


@_cached
def half_sweep_masks(X: int, Y2: int, Z: int, device):
    """(ok_red, ok_black) bool masks on halves (relax.py:1117-1151):
    x >= 1 and z >= 1; red `j >= 1 or q == 1`, black `j >= 1 or q == 0`."""
    x = torch.arange(X, device=device)[:, None, None]
    j = torch.arange(Y2, device=device)[None, :, None]
    z = torch.arange(Z, device=device)[None, None, :]
    q1 = (x + z) % 2 == 1
    ok = (x >= 1) & (z >= 1)
    return ((j >= 1) | q1) & ok, ((j >= 1) | ~q1) & ok


@_cached
def _float_masks(X: int, Y2: int, Z: int, device):
    return tuple(m.to(torch.float32)
                 for m in half_sweep_masks(X, Y2, Z, device))


def _pairs(w, color: int):
    """Neighbour pair sums (x, y, z) of the points of `color`, gathered
    from the other color's half `w` in the TPU kernels' order
    (relax.py:1164-1176)."""
    X, Y2, Z = w.shape
    q1 = _qmask(X, Z, w.device)
    if color == RED:
        ypair = w + torch.where(q1, _roll(w, 1, +1), _roll(w, 1, -1))
    else:
        ypair = w + torch.where(q1, _roll(w, 1, -1), _roll(w, 1, +1))
    return (
        _roll(w, 0, -1) + _roll(w, 0, +1),
        ypair,
        _roll(w, 2, -1) + _roll(w, 2, +1),
    )


def half_sweep_plain(u, w, fu, color: int, problem, geom: LevelGeometry):
    """One half-sweep in place on `u` from the other color `w` — the
    sweep body of relax.py:1161-1179 with Poisson.split_update."""
    X, Y2, Z = u.shape
    upd = problem.split_update(_pairs(w, color), fu, geom)
    m = _float_masks(X, Y2, Z, u.device)[color]
    u.add_(m * (upd - u))  # u + m*(upd - u), in place
    return u


def relax_halves_plain(r, b, fr, fb, nsweeps: int, problem,
                       geom: LevelGeometry):
    """`nsweeps` red-then-black `half_sweep_plain` sweeps, in place on r
    and b: relax_halves' plain version, on any device."""
    for _ in range(nsweeps):
        half_sweep_plain(r, b, fr, RED, problem, geom)
        half_sweep_plain(b, r, fb, BLACK, problem, geom)
    return r, b


def error_half_sweep_plain(eu, ew, ru, color: int, problem,
                           geom: LevelGeometry, v_zero: bool = False):
    """One half-sweep of the error equation A e = r, written into `eu`:
    eu = where(ok, upd, 0) with upd = Poisson.split_update_folded in
    float32 from the widened other color `ew` and RHS half `ru`, rounded
    to eu's dtype (the body of relax.py:1389-1413).  The old value of eu
    is never read.  `v_zero`: the other color is identically zero (the
    first red half-sweep from e = 0); `ew` is then not read."""
    if v_zero:
        w = torch.zeros(ru.shape, dtype=torch.float32, device=ru.device)
    else:
        w = ew.to(torch.float32)
    upd = problem.split_update_folded(_pairs(w, color),
                                      ru.to(torch.float32), geom)
    ok = half_sweep_masks(*eu.shape, eu.device)[color]
    eu.copy_(torch.where(ok, upd, 0.0).to(eu.dtype))
    return eu


def error_sweeps_plain(rr, rb, nsweeps: int, problem, geom: LevelGeometry):
    """(er, eb): `nsweeps` red-then-black sweeps of the error equation from
    e = 0, stored in rr's dtype (bfloat16 on the defect path; float32
    makes it the direct smoother's algebraic twin), computed in float32."""
    er, eb = torch.zeros_like(rr), torch.zeros_like(rb)
    for s in range(nsweeps):
        error_half_sweep_plain(er, eb, rr, RED, problem, geom, v_zero=s == 0)
        error_half_sweep_plain(eb, er, rb, BLACK, problem, geom)
    return er, eb


def timeskew_sweeps_plain(b, fr, fb, nsweeps: int, problem,
                          geom: LevelGeometry, v_zero: bool = False):
    """(r, b): `nsweeps` red-then-black sweeps from the black half `b`
    and the RHS halves (fr, fb) in the where form of the time-skewed TPU
    kernels (relax.py:1592-1612): every update is written as
    where(ok, upd, 0) with Poisson.split_update, so the red input is never
    read, and plane 0 of `b` reads as zero (the kernels never load it).
    `v_zero`: b is zero (`b` is not read).  In any float dtype; new
    tensors, the inputs are not written.  This is not the blend form
    u + m*(upd - u) of `half_sweep_plain`: the two differ in the last bits,
    as the TPU kernels do."""
    if nsweeps < 1:
        raise ValueError(f"nsweeps {nsweeps}: the wavefront runs >= 1 sweep")
    ok_r, ok_b = half_sweep_masks(*fr.shape, fr.device)
    if v_zero:
        b = torch.zeros_like(fr)
    else:
        b = b.clone()
        b[0] = 0.0
    for _ in range(nsweeps):
        r = torch.where(ok_r, problem.split_update(_pairs(b, RED), fr, geom),
                        0.0)
        b = torch.where(ok_b, problem.split_update(_pairs(r, BLACK), fb,
                                                   geom), 0.0)
    return r, b


# ------------------------------------------------------------ wrappers


def split(v: torch.Tensor, red: bool = True):
    """Dense (X, Y, Z) -> (r, b) halves; without `red` only the black half
    is written, and r is None."""
    X, Y2, Z = _halves_shape(v.shape)
    if not _on_cuda(v):
        r, b = split_colors(v)
        return (r if red else None), b
    b = torch.empty((X, Y2, Z), dtype=v.dtype, device=v.device)
    r = torch.empty_like(b) if red else None
    rc = build.load().lib.pdemg_split(
        v.data_ptr(), None if r is None else r.data_ptr(), b.data_ptr(), X,
        Y2, Z, _stream()
    )
    launches["split"] += 1
    build.check(rc, "split")
    return r, b


def merge(r: torch.Tensor, b: torch.Tensor, out: torch.Tensor | None = None):
    """(r, b) halves -> dense (X, Y, Z); written into `out` when given
    (the dense tensor the halves came from, overwritten in place)."""
    if r.dim() != 3 or r.shape != b.shape:
        raise ValueError(f"halves shapes {tuple(r.shape)}, {tuple(b.shape)}")
    X, Y2, Z = r.shape
    if out is None:
        out = torch.empty((X, 2 * Y2, Z), dtype=r.dtype, device=r.device)
    if tuple(out.shape) != (X, 2 * Y2, Z):
        raise ValueError(f"merge output shape {tuple(out.shape)}")
    if not _on_cuda(r, b, out):
        return out.copy_(merge_colors(r, b))
    rc = build.load().lib.pdemg_merge(
        r.data_ptr(), b.data_ptr(), out.data_ptr(), X, Y2, Z, _stream()
    )
    launches["merge"] += 1
    build.check(rc, "merge")
    return out


def _check_sweep_args(u, w, fu, geom: LevelGeometry,
                      dtype=torch.float32) -> bool:
    if not (u.shape == w.shape == fu.shape):
        raise ValueError("half-sweep operands differ in shape")
    if tuple(u.shape) != _halves_shape(geom.padded_shape):
        raise ValueError(
            f"halves {tuple(u.shape)} do not match level "
            f"{geom.padded_shape}"
        )
    if not geom.wrap or geom.ndim != 3:
        raise ValueError("the split relax serves 3D wrap levels only")
    return _on_cuda(u, w, fu, dtype=dtype)


def relax_halves(r, b, fr, fb, nsweeps: int, problem, geom: LevelGeometry):
    """`nsweeps` red-then-black sweeps on halves, in place on r and b:
    2*nsweeps launches, the operands checked once."""
    _check_sweep_args(b, r, fb, geom)
    if not _check_sweep_args(r, b, fr, geom):
        return relax_halves_plain(r, b, fr, fb, nsweeps, problem, geom)
    _check_poisson(problem)
    X, Y2, Z = r.shape
    (w0, w1, w2), inv_den = split_constants(geom)
    fn = build.load().lib.pdemg_half_sweep
    stream = _stream()
    pr, pb, pfr, pfb = r.data_ptr(), b.data_ptr(), fr.data_ptr(), fb.data_ptr()
    for _ in range(nsweeps):
        rc = fn(pr, pb, pfr, X, Y2, Z, RED, w0, w1, w2, inv_den, stream)
        launches["half_sweep"] += 1
        build.check(rc, "half_sweep")
        rc = fn(pb, pr, pfb, X, Y2, Z, BLACK, w0, w1, w2, inv_den, stream)
        launches["half_sweep"] += 1
        build.check(rc, "half_sweep")
    return r, b


def error_leg_layout(X: int, Y2: int, Z: int,
                     sms: int = ERROR_LEG_SMS) -> dict | None:
    """The error leg's launch geometry on bf16 halves (X, Y/2, Z) with
    `sms` SMs, or None where the card's shared memory does not hold the
    leg: the halves cut into blocks of "planes" x planes (at most
    ERROR_LEG_MAX_PLANES) by "rows" j rows, every z, "yblocks" blocks
    along j and one CTA a block, at most one an SM ("ctas"); "threads" a
    CTA (a thread on a z pair of a row, the rows of a block as many as the
    threads take, at least 2 where the blocks are more than one) and
    "smem_bytes" (its block of er and eb with a halo row either side of
    each plane's rows, and of rr and rb, 2 B a point; the faces a block
    shares with its x and j neighbours go through device memory)."""
    if X < 1 or Y2 < 1 or Z < 2 or Z % 2 or sms < 1:
        return None
    zh = Z // 2
    if zh > ERROR_LEG_THREADS:
        return None
    rows = min(Y2, ERROR_LEG_THREADS // zh)
    yblocks = -(-Y2 // rows)
    if yblocks > sms or (yblocks > 1 and rows < 2):
        return None
    planes = -(-X // (sms // yblocks))
    smem = 8 * planes * Z * (rows + 1)
    if planes > ERROR_LEG_MAX_PLANES or smem > ERROR_LEG_SMEM_BYTES:
        return None
    return {"ctas": -(-X // planes) * yblocks, "planes": planes,
            "rows": rows, "yblocks": yblocks,
            "threads": -(-rows * zh // 32) * 32, "smem_bytes": smem}


def error_form(geom: LevelGeometry, sms: int = ERROR_LEG_SMS) -> str | None:
    """Which kernel runs a leg of the error sweeps on the 3D wrap level
    `geom`: "leg" (`error_leg`, one launch a leg) where its four halves fit
    the shared memory of the card's SMs (`error_leg_layout`: 128^3 and
    below), "wavefront" (`error_timeskew`, TIMESKEW_T sweeps a launch)
    where the wavefront's tile holds a half-plane row at k = 4 (Z % 4 ==
    0), else
    "chain" (`error_chain`, one launch a half-sweep: 1024^3, or Z % 4 != 0
    past the leg's shared memory); None off even 3D wrap levels."""
    if not (geom.wrap and geom.ndim == 3):
        return None
    X, Y, Z = geom.padded_shape
    if X % 2 or Y % 2 or Z % 2:
        return None
    if error_leg_layout(X, Y // 2, Z, sms) is not None:
        return "leg"
    if Z % 4 or X * (Y // 2) * Z >= 2**31:
        return "chain"
    try:
        _timeskew_tile(Y // 2, Z, TIMESKEW_T, 4)
    except ValueError:
        return "chain"
    return "wavefront"


def error_launches(form: str, nsweeps: int) -> int:
    """Launches of one nsweeps leg of the error sweeps in `form`."""
    if form == "chain":
        return 2 * nsweeps
    return 1 if form == "leg" else len(leg_launches(nsweeps))


def _check_error_args(rr, rb, nsweeps: int, geom: LevelGeometry):
    """(on_cuda, zeros): the operands checked; zeros is the result of a
    leg of no sweep, else None."""
    on_cuda = _check_sweep_args(rr, rb, rr, geom, dtype=torch.bfloat16)
    if nsweeps < 1:
        return on_cuda, (torch.zeros_like(rr), torch.zeros_like(rb))
    return on_cuda, None


class ErrorLegLayout(ctypes.Structure):
    """csrc/relax.cu `ErrorLegLayout`: the error leg's launch geometry."""

    _fields_ = [(n, ctypes.c_int) for n in
                ("ctas", "planes", "rows", "yblocks", "threads",
                 "smem_bytes")]


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _error_leg_launch(X: int, Y2: int, Z: int, sms: int) -> ErrorLegLayout:
    lay = error_leg_layout(X, Y2, Z, sms)
    if lay is None:
        raise ValueError(
            f"halves {(X, Y2, Z)}: the error leg's four halves do not fit "
            f"the shared memory of {sms} SMs")
    return ErrorLegLayout(*(lay[n] for n, _ in ErrorLegLayout._fields_))


@_cached
def _leg_words(n: int, dtype, device) -> torch.Tensor:
    """The error leg's outboxes (int64 words) or barrier counters (int32):
    zero, and left zero by every launch (cached per size and device outside
    a capture; a capture gets its own, zeroed by a captured fill)."""
    return torch.zeros(n, dtype=dtype, device=device)


def error_leg(rr, rb, nsweeps: int, problem, geom: LevelGeometry):
    """(er, eb) bf16 = `nsweeps` red-black sweeps of the error equation
    A e = r from e = 0 on bf16 residual halves (rr, rb), computed in
    float32 with the folded update; masked-off points are exactly 0.  One
    cooperative launch of csrc/relax.cu's leg on `error_leg_layout` with the
    card's SMs; a grid the card cannot co-schedule raises.  The legs of
    one device share their outboxes (2 (rows + planes) Z words of 8 B a
    CTA) and counters: they run on one stream."""
    on_cuda, zeros = _check_error_args(rr, rb, nsweeps, geom)
    if zeros is not None:
        return zeros
    if not on_cuda:
        return error_sweeps_plain(rr, rb, nsweeps, problem, geom)
    _check_poisson(problem)
    X, Y2, Z = rr.shape
    sms = _sm_count(rr.device.index)
    lay = _error_leg_launch(X, Y2, Z, sms)
    iso, (a0, a1, a2), inv_den = folded_constants(geom)
    er, eb = torch.empty_like(rr), torch.empty_like(rb)
    box = _leg_words(2 * lay.ctas * (lay.rows + lay.planes) * Z, torch.int64,
                     rr.device)
    bar = _leg_words(2, torch.int32, rr.device)
    rc = build.load().lib.pdemg_error_leg(
        ctypes.byref(lay), er.data_ptr(), eb.data_ptr(), rr.data_ptr(),
        rb.data_ptr(), box.data_ptr(), bar.data_ptr(), X, Y2, Z, nsweeps,
        int(iso), a0, a1, a2, inv_den, _stream())
    launches["error_leg"] += 1
    build.check(rc, "error_leg")
    return er, eb


def error_timeskew(rr, rb, nsweeps: int, problem, geom: LevelGeometry):
    """(er, eb) bf16: `error_leg`'s function through the wavefront's error
    mode (csrc/timeskew.cu), as `timeskew_relax_halves` chains it:
    nsweeps // T launches of T = TIMESKEW_T sweeps, then one of the
    nsweeps % T left, each from the previous launch's black half (the
    first from zero); only the last launch writes er.  k = 4 z points a
    thread: Z % 4 == 0."""
    on_cuda, zeros = _check_error_args(rr, rb, nsweeps, geom)
    if zeros is not None:
        return zeros
    if not on_cuda:
        return error_sweeps_plain(rr, rb, nsweeps, problem, geom)
    _check_poisson(problem)
    X, Y2, Z = rr.shape
    if Z % 4 or X * Y2 * Z >= 2**31:
        raise ValueError(
            f"halves {(X, Y2, Z)}: the wavefront's error mode takes Z % 4 "
            "== 0 and X * Y/2 * Z < 2^31 points")
    if rr.data_ptr() % 8 or rb.data_ptr() % 8:
        raise ValueError("the wavefront's error mode reads 8-byte aligned "
                         "halves")
    iso, (a0, a1, a2), inv_den = folded_constants(geom)
    fn = build.load().lib.pdemg_timeskew_error
    stream = _stream()
    er = torch.empty_like(rr)
    bufs = (torch.empty_like(rb), torch.empty_like(rb))  # ping-pong eb
    src = None
    ts = leg_launches(nsweeps)
    for i, t in enumerate(ts):
        dst = bufs[i % 2]
        lay = _timeskew_launch(X, Y2, Z, t, 4, X, True)
        rc = fn(ctypes.byref(lay), None if src is None else src.data_ptr(),
                rr.data_ptr(), rb.data_ptr(),
                er.data_ptr() if i == len(ts) - 1 else None, dst.data_ptr(),
                X, Y2, Z, t, int(src is None), int(iso), a0, a1, a2, inv_den,
                stream)
        launches["error_timeskew"] += 1
        build.check(rc, "error_timeskew")
        src = dst
    return er, src


def error_chain(rr, rb, nsweeps: int, problem, geom: LevelGeometry):
    """(er, eb) bf16: `error_leg`'s function as 2*nsweeps launches of one
    half-sweep each, the first red one without reading black (the levels
    that fit neither `error_leg` nor `error_timeskew`)."""
    on_cuda, zeros = _check_error_args(rr, rb, nsweeps, geom)
    if zeros is not None:
        return zeros
    if not on_cuda:
        return error_sweeps_plain(rr, rb, nsweeps, problem, geom)
    _check_poisson(problem)
    X, Y2, Z = rr.shape
    if Z % 2 or rr.data_ptr() % 4 or rb.data_ptr() % 4:
        raise ValueError(
            "the error sweep kernel reads bf16 pairs along z: it needs an "
            "even Z and 4-byte aligned halves"
        )
    iso, (a0, a1, a2), inv_den = folded_constants(geom)
    er, eb = torch.empty_like(rr), torch.empty_like(rb)
    fn = build.load().lib.pdemg_error_half_sweep
    stream = _stream()
    per, peb, prr, prb = (er.data_ptr(), eb.data_ptr(), rr.data_ptr(),
                          rb.data_ptr())
    for s in range(nsweeps):
        rc = fn(per, peb, prr, X, Y2, Z, RED, int(s == 0), int(iso),
                a0, a1, a2, inv_den, stream)
        launches["error_sweep"] += 1
        build.check(rc, "error_sweep")
        rc = fn(peb, per, prb, X, Y2, Z, BLACK, 0, int(iso),
                a0, a1, a2, inv_den, stream)
        launches["error_sweep"] += 1
        build.check(rc, "error_sweep")
    return er, eb


ERROR_SWEEPS = {"leg": error_leg, "wavefront": error_timeskew,
                "chain": error_chain}


def error_sweeps(rr, rb, nsweeps: int, problem, geom: LevelGeometry):
    """(er, eb) bf16 = `nsweeps` red-black sweeps of the error equation
    from e = 0 (`error_sweeps_plain`'s function), by the kernel
    `error_form` gives the level: `error_leg`, `error_timeskew` or
    `error_chain`."""
    on_cuda, zeros = _check_error_args(rr, rb, nsweeps, geom)
    if zeros is not None:
        return zeros
    if not on_cuda:
        return error_sweeps_plain(rr, rb, nsweeps, problem, geom)
    return ERROR_SWEEPS[error_form(geom)](rr, rb, nsweeps, problem, geom)


class TimeskewLayout(ctypes.Structure):
    """csrc/timeskew.cu `TimeskewLayout`: the wavefront's launch
    geometry."""

    _fields_ = [(n, ctypes.c_int) for n in
                ("k", "ctas", "rows", "band", "halo", "bands", "chunks",
                 "lx", "threads", "smem_bytes")]


def _timeskew_smem(rows: int, Z: int, T: int) -> int:
    """Bytes of shared memory a CTA of `rows` j rows needs: two step
    parities of a tile of rows + 2 rows (the halo rows) x 2T levels x Z
    points, each level's even and odd points padded to a multiple of 4."""
    zp = -(-(Z // 2) // 4) * 4
    return 2 * (rows + 2) * 2 * 2 * T * zp * 4


@functools.lru_cache(maxsize=None)
def _timeskew_tile(Y2: int, Z: int, T: int, k: int):
    """(ctas, rows, band, halo, bands): the cluster's CTAs, the j rows each
    holds (every z), the rows a band owns, the rows it computes past each
    outer edge (0: its ring is the level's own j wrap) and the bands over
    Y2.  One band over the whole half-plane when the card holds it (the
    largest cluster of 16, 8, 4, 2 or 1 CTAs dividing Y2 into CTAs of at
    most the rows a CTA's threads and shared memory take); otherwise bands
    that recompute 2T rows past each outer edge, on the fewest CTAs whose
    band covers Y2, or 16 CTAs of the most rows."""
    if T < 1 or T > TIMESKEW_MAX_T:
        raise ValueError(f"T = {T}: the wavefront is built for T = 1 ... "
                         f"{TIMESKEW_MAX_T}")
    if Z % 2 or Z % k or k not in (2, 4):
        raise ValueError(f"Z = {Z}, k = {k}: the wavefront takes an even Z "
                         "and k = 2 or 4 points a thread")
    per_row = Z // k
    rmax = TIMESKEW_THREADS // per_row
    while rmax >= 1 and _timeskew_smem(rmax, Z, T) > TIMESKEW_SMEM_BYTES:
        rmax -= 1
    if rmax < 1:
        raise ValueError(f"Z = {Z}: a row of the half-plane does not fit "
                         "one CTA of the wavefront")
    for c in (16, 8, 4, 2, 1):
        if Y2 % c == 0 and Y2 // c <= rmax:
            return c, Y2 // c, Y2, 0, 1
    halo = 2 * T
    for c in (1, 2, 4, 8, 16):
        if c * rmax - 2 * halo >= Y2:
            rows = -(-(Y2 + 2 * halo) // c)
            return c, rows, c * rows - 2 * halo, halo, 1
    band = TIMESKEW_CTAS * rmax - 2 * halo
    if band < 1:
        raise ValueError(f"halves (Y/2, Z) = {(Y2, Z)}: a band of the "
                         f"wavefront at T = {T} owns no row")
    return TIMESKEW_CTAS, rmax, band, halo, -(-Y2 // band)


@functools.lru_cache(maxsize=None)
def _x_chunks(W: int, bands: int, T: int, slots: int):
    """(chunks, lx): the x chunks of a window of W planes, each of lx
    planes (even), that minimise waves x steps, with `slots` clusters
    resident on the card at once, one per band and chunk, and a chunk of
    lx planes taking lx + 4T steps."""
    best = None
    for c in range(1, W + 1):
        lx = -(-W // c)
        lx += lx % 2
        if -(-W // lx) != c:  # the same chunks as a smaller c
            continue
        cost = -(-bands * c // slots) * (lx + 4 * T)
        if best is None or cost < best[0]:
            best = (cost, c, lx)
    return best[1], best[2]


def timeskew_layout(X: int, Y2: int, Z: int, T: int,
                    clusters: int = TIMESKEW_CLUSTERS, k: int | None = None,
                    window: int | None = None) -> dict:
    """The wavefront kernel's launch geometry on halves (X, Y/2, Z) at T
    sweeps a launch, with `clusters` clusters resident on the card (the
    wrapper asks the card) and the window of `window` planes written
    (default X): a dict with "k" (z points a thread: 4, or 2 where Z % 4 or
    the tensors' alignment forbid 16-byte access), "ctas" (the cluster,
    along j), "rows" (j rows per CTA: the CTA tile is rows x Z),
    "threads", "smem_bytes" (per CTA), "band" (rows a band owns), "halo"
    (rows it recomputes past each outer edge: 0 when one band covers the
    half-plane and its ring is the level's own j wrap), "bands",
    "chunks" and "lx" (the x chunks, each lx planes), and "redundancy":
    updates computed / updates needed, bands x ctas x rows / Y2 times
    (W + 4T chunks) / W."""
    if k is None:
        k = 4 if Z % 4 == 0 else 2
    ctas, rows, band, halo, bands = _timeskew_tile(Y2, Z, T, k)
    W = X if window is None else window
    if W < 1 or clusters < 1:
        raise ValueError(f"window {W}, clusters {clusters}")
    chunks, lx = _x_chunks(W, bands, T, clusters)
    threads = -(-rows * (Z // k) // 32) * 32
    return {"k": k, "ctas": ctas, "rows": rows, "threads": threads,
            "smem_bytes": _timeskew_smem(rows, Z, T), "band": band,
            "halo": halo, "bands": bands, "chunks": chunks, "lx": lx,
            "redundancy": bands * ctas * rows / Y2 * (W + 4 * T * chunks)
            / W}


def timeskew_rows(lay: dict, Y2: int) -> list:
    """The kernel's rows of a layout: for every band, CTA and row of the
    CTA, (j, owned): the half-plane row it computes (the band's rows start
    `halo` rows before its first owned one, wrapping modulo Y2) and
    whether it writes it out (csrc/timeskew.cu `jg`, `owned`)."""
    out = []
    for band in range(lay["bands"]):
        first = band * lay["band"]
        for cta in range(lay["ctas"]):
            for i in range(lay["rows"]):
                pos = cta * lay["rows"] + i
                j = (first - lay["halo"] + pos) % Y2
                owned = (lay["halo"] <= pos < lay["halo"] + lay["band"]
                         and first + pos - lay["halo"] < Y2)
                out.append((j, owned))
    return out


def _layout_struct(lay: dict) -> TimeskewLayout:
    return TimeskewLayout(*(lay[n] for n, _ in TimeskewLayout._fields_))


# resident clusters by launch shape (T, k, ctas, threads, shared memory),
# asked once each outside any capture
_TIMESKEW_CLUSTERS: dict = {}


@functools.lru_cache(maxsize=None)
def timeskew_launch_layout(X: int, Y2: int, Z: int, T: int, k: int,
                           window: int, err: bool = False) -> dict:
    """`timeskew_layout` of a launch on the card, its x chunks sized for
    the clusters the card holds of its tile (cudaOccupancyMaxActiveClusters,
    asked once per launch shape and mode, `err` the error mode, in
    "clusters"); raises where the card runs no such cluster (there is no
    smaller layout to fall back to)."""
    tile = timeskew_layout(X, Y2, Z, T, k=k, window=window)
    shape = (T, k, tile["ctas"], tile["threads"], tile["smem_bytes"], err)
    if shape not in _TIMESKEW_CLUSTERS:
        n = ctypes.c_int(0)
        build.check(build.load().lib.pdemg_timeskew_clusters(
            ctypes.byref(_layout_struct(tile)), T, int(err),
            ctypes.byref(n)),
            "timeskew (cudaOccupancyMaxActiveClusters)")
        if n.value < 1:
            raise RuntimeError(
                f"the card runs no cluster of {tile['ctas']} CTAs of "
                f"{tile['threads']} threads and {tile['smem_bytes']} B of "
                "shared memory each (the wavefront's launch)")
        _TIMESKEW_CLUSTERS[shape] = n.value
    clusters = _TIMESKEW_CLUSTERS[shape]
    return {**timeskew_layout(X, Y2, Z, T, clusters, k, window),
            "clusters": clusters}


@functools.lru_cache(maxsize=None)
def _timeskew_launch(X: int, Y2: int, Z: int, T: int, k: int,
                     window: int, err: bool = False) -> TimeskewLayout:
    return _layout_struct(timeskew_launch_layout(X, Y2, Z, T, k, window,
                                                 err))


def _launch_k(Z: int, *ts: torch.Tensor) -> int:
    """4 z points a thread (16-byte access) where Z % 4 == 0 and every
    tensor is 16-byte aligned, else 2."""
    ok = Z % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in ts)
    return 4 if ok else 2


def leg_launches(nsweeps: int, T: int = TIMESKEW_T) -> list[int]:
    """The sweeps of each launch of an nsweeps leg (relax_raw's chain):
    nsweeps // T launches of T, then one of nsweeps % T."""
    n_full, rem = divmod(nsweeps, T)
    return [T] * n_full + [rem] * (rem > 0)


def timeskew_relax_halves(b, fr, fb, nsweeps: int, problem,
                          geom: LevelGeometry, v_zero: bool = False,
                          T: int = TIMESKEW_T):
    """(r, b) after `nsweeps` red->black sweeps from the black half `b`
    (not read with `v_zero`, and then may be None) and the RHS halves
    (fr, fb), as `relax_raw` chains the TPU wavefront (relax.py:1744-1769):
    nsweeps // T launches of T (default TIMESKEW_T) sweeps, then one of the
    nsweeps % T left, each from the previous launch's b; only the last
    launch writes r.  New tensors; the inputs are not written."""
    if nsweeps < 1:
        raise ValueError(f"nsweeps {nsweeps}: the wavefront runs >= 1 sweep")
    on_cuda = _check_sweep_args(fr, fr if v_zero else b, fb, geom)
    X, Y2, Z = fr.shape
    # 32-bit element offsets, formed for planes inside the level only
    if Z % 2 or X * Y2 * Z >= 2**31:
        raise ValueError(
            f"halves {(X, Y2, Z)}: the wavefront takes an even Z and "
            "X * Y/2 * Z < 2^31 points")
    if not on_cuda:
        return timeskew_sweeps_plain(b, fr, fb, nsweeps, problem, geom,
                                     v_zero)
    _check_poisson(problem)
    if any(t.data_ptr() % 8 for t in (fr, fb, *(() if v_zero else (b,)))):
        raise ValueError("the wavefront kernel reads 8-byte aligned halves")
    (w0, w1, w2), inv_den = split_constants(geom)
    fn = build.load().lib.pdemg_timeskew
    stream = _stream()
    r = torch.empty_like(fr)
    bufs = (torch.empty_like(fr), torch.empty_like(fr))  # ping-pong b
    k = _launch_k(Z, r, *bufs, fr, fb, *(() if v_zero else (b,)))
    src = None if v_zero else b
    ts = leg_launches(nsweeps, T)
    for i, t in enumerate(ts):
        dst = bufs[i % 2]
        lay = _timeskew_launch(X, Y2, Z, t, k, X)
        rc = fn(ctypes.byref(lay), None if src is None else src.data_ptr(),
                fr.data_ptr(), fb.data_ptr(),
                r.data_ptr() if i == len(ts) - 1 else None, dst.data_ptr(),
                X, Y2, Z, t, int(src is None), w0, w1, w2, inv_den, stream)
        launches["timeskew"] += 1
        timeskew_by_level[(X, Y2, Z)] = timeskew_by_level.get((X, Y2, Z),
                                                              0) + 1
        build.check(rc, "timeskew")
        src = dst
    return r, src


def _check_shard(b_ext, fr_w, fb_w, g0, t, geom, x_loc):
    """The slab shape (x_loc + 4t, Y/2, Z) of a shard chunk on the 3D wrap
    level `geom`, after checking the operands against it."""
    XG, Y, Z = geom.padded_shape
    shape = (x_loc + 4 * t, Y // 2, Z)
    if not (geom.wrap and geom.ndim == 3):
        raise ValueError("the shard chunk serves 3D wrap levels only")
    if not (tuple(b_ext.shape) == tuple(fr_w.shape) == tuple(fb_w.shape)
            == shape):
        raise ValueError(f"shard chunk operands {tuple(b_ext.shape)}, "
                         f"{tuple(fr_w.shape)}, {tuple(fb_w.shape)}; want "
                         f"{shape}")
    if t < 1 or g0 % 2 or x_loc % 2:
        raise ValueError(f"t = {t}, g0 = {g0}, x_loc = {x_loc}: the chunk "
                         "runs >= 1 sweep from an even offset and width")
    return shape


def timeskew_shard_plain(b_ext, fr_w, fb_w, g0: int, t: int, problem,
                         geom: LevelGeometry, x_loc: int):
    """(r, b) extended halves after `t` red->black sweeps of one shard's
    chunk, as JAX's `make_split_timeskew_relax_shard` (relax.py:1787)
    computes them: the inputs are the shard's black half and RHS halves on
    XE = x_loc + 4t planes, plane x being global plane g0 + x of the level
    `geom`.  A plane updates (where form) iff x >= 1 and 1 <= g <= XG - 1;
    its +1 read is zero past global plane XG - 1 or the slab's last plane
    (the TPU kernel's gate), its -1 read is the raw plane.  Only the owned
    window [2t, 2t + x_loc) is exact.  New tensors, in any float dtype."""
    shape = _check_shard(b_ext, fr_w, fb_w, g0, t, geom, x_loc)
    XG, XE = geom.padded_shape[0], shape[0]
    x = torch.arange(XE, device=fr_w.device)
    g = g0 + x
    gv = ((x >= 1) & (g >= 1) & (g <= XG - 1))[:, None, None]
    gate = ((g + 1 <= XG - 1) & (x + 1 <= XE - 1)).to(fr_w.dtype)
    gate = gate[:, None, None]
    ok_r, ok_b = half_sweep_masks(*shape, fr_w.device)
    ok_r, ok_b = ok_r & gv, ok_b & gv

    def pairs(w, color):
        _, py, pz = _pairs(w, color)
        return _roll(w, 0, -1) + _roll(w, 0, +1) * gate, py, pz

    b = b_ext
    for _ in range(t):
        r = torch.where(ok_r, problem.split_update(pairs(b, RED), fr_w,
                                                   geom), 0.0)
        b = torch.where(ok_b, problem.split_update(pairs(r, BLACK), fb_w,
                                                   geom), 0.0)
    return r, b


def timeskew_shard(b_ext, fr_w, fb_w, g0: int, t: int, problem,
                   geom: LevelGeometry, x_loc: int, b_out, r_out=None):
    """One chunk of the sharded time-skew engine: `t` sweeps of
    `timeskew_shard_plain`'s function, whose owned window [2t, 2t + x_loc)
    is written into `b_out` (and `r_out`, when given: the last chunk of a
    leg), (x_loc, Y/2, Z) halves.  On CUDA tensors the launches of
    csrc/timeskew.cu's shard mode that `shard_windows` lists (t // T of T =
    TIMESKEW_T sweeps, then one of t % T), each over the window the next
    one reads, the last one into the outputs; the inputs are not
    written."""
    XE, Y2, Z = _check_shard(b_ext, fr_w, fb_w, g0, t, geom, x_loc)
    outs = (b_out,) if r_out is None else (b_out, r_out)
    if any(tuple(o.shape) != (x_loc, Y2, Z) for o in outs):
        raise ValueError(f"shard outputs {[tuple(o.shape) for o in outs]}")
    on_cuda = _on_cuda(b_ext, fr_w, fb_w, *outs)
    if not on_cuda:
        r, b = timeskew_shard_plain(b_ext, fr_w, fb_w, g0, t, problem, geom,
                                    x_loc)
        b_out.copy_(b[2 * t:2 * t + x_loc])
        if r_out is not None:
            r_out.copy_(r[2 * t:2 * t + x_loc])
        return b_out, r_out
    _check_poisson(problem)
    if Z % 2 or XE * Y2 * Z >= 2**31:
        raise ValueError(f"halves {(XE, Y2, Z)}: the wavefront takes an even "
                         "Z and X * Y/2 * Z < 2^31 points")
    if any(a.data_ptr() % 8 for a in (b_ext, fr_w, fb_w, *outs)):
        raise ValueError("the wavefront kernel reads 8-byte aligned halves")
    (w0, w1, w2), inv_den = split_constants(geom)
    fn = build.load().lib.pdemg_timeskew_shard
    stream = _stream()
    wins = shard_windows(t, x_loc)
    tmp = [None, None]
    src = b_ext
    for i, (tk, lo, hi) in enumerate(wins):
        if i == len(wins) - 1:
            dst, r_dst, out_lo = b_out, r_out, lo
        else:
            if tmp[i % 2] is None:
                tmp[i % 2] = torch.empty_like(b_ext)
            dst, r_dst, out_lo = tmp[i % 2], None, 0
        k = _launch_k(Z, src, fr_w, fb_w, dst,
                      *(() if r_dst is None else (r_dst,)))
        lay = _timeskew_launch(XE, Y2, Z, tk, k, hi - lo)
        rc = fn(ctypes.byref(lay), src.data_ptr(), fr_w.data_ptr(),
                fb_w.data_ptr(), None if r_dst is None else r_dst.data_ptr(),
                dst.data_ptr(), XE, Y2, Z, tk, g0, geom.padded_shape[0], lo,
                hi, out_lo, w0, w1, w2, inv_den, stream)
        launches["timeskew_shard"] += 1
        build.check(rc, "timeskew_shard")
        src = dst
    return b_out, r_out


def shard_windows(t: int, x_loc: int, T: int = TIMESKEW_T):
    """The launches of a t-sweep shard chunk: [(sweeps, w_lo, w_hi)], the
    sweeps of `leg_launches` and the slab planes each launch writes, last
    launch first computed: the owned window [2t, 2t + x_loc), then each
    earlier launch's widened by the 2 x sweeps planes that the next one
    reads on either side."""
    ts = leg_launches(t, T)
    wins = [(2 * t, 2 * t + x_loc)]
    for tk in reversed(ts[1:]):
        lo, hi = wins[0]
        wins.insert(0, (lo - 2 * tk, hi + 2 * tk))
    return [(tk, lo, hi) for tk, (lo, hi) in zip(ts, wins)]


def timeskew_plan(geom: LevelGeometry) -> bool:
    """Whether the wavefront relaxes this level: JAX's gate
    (`timeskew_plan`, relax.py:3833-3855) without its TPU-only conditions
    (Z % 128, Y/2 % 8 and the VMEM ladder): the switch
    `PDE_MG_TIMESKEW` is "1" (the default; read at every call, as JAX
    reads it), and a 3D wrap level with even extents, X >= 8, and a
    half-plane of at least TIMESKEW_MIN_PLANE points."""
    if os.environ.get("PDE_MG_TIMESKEW", "1") != "1":
        return False
    if not (geom.wrap and geom.ndim == 3):
        return False
    X, Y, Z = geom.padded_shape
    if X % 2 or Y % 2 or Z % 2 or X < 8:
        return False
    return (Y // 2) * Z >= TIMESKEW_MIN_PLANE


def make_split_relax(problem, geom: LevelGeometry):
    """relax(v, f, nsweeps) -> v for one 3D wrap level: split v and f
    into halves, sweep, merge back into v's own storage (in place — the
    dense iterate is dead while the halves are live)."""
    _halves_shape(geom.padded_shape)

    def relax(v, f, nsweeps: int):
        r, b = split(v)
        fr, fb = split(f)
        relax_halves(r, b, fr, fb, nsweeps, problem, geom)
        return merge(r, b, out=v)

    return relax


def make_timeskew_relax(problem, geom: LevelGeometry):
    """relax(v, f, nsweeps) -> v for one 3D wrap level through the
    wavefront (the TPU kernels' `relax`, relax.py:1778-1782): split v's
    black half (the wavefront never reads red) and f, sweep, merge back
    into v's own storage in place."""
    _halves_shape(geom.padded_shape)

    def relax(v, f, nsweeps: int):
        _, b = split(v, red=False)
        fr, fb = split(f)
        r, b = timeskew_relax_halves(b, fr, fb, nsweeps, problem, geom)
        return merge(r, b, out=v)

    return relax
