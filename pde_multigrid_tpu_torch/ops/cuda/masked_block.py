"""Masked dense red-black sweeps on one shard's extended block: the CUDA
kernels of `csrc/masked_block.cu` and their plain PyTorch version.

Replaces the TPU kernel `pde_multigrid_tpu/ops/pallas/relax.py`
`make_masked_block_relax` (relax.py:792): t sweeps of JAX's `_sweeps`
(relax.py:129-137) on a block whose red/black masks (and the problem's
per-point coefficients, `pre`) arrive as inputs, because they depend on
the shard's global row offset.  `parallel/halo.py` runs it on the 3D wrap
Poisson levels the time-skew engine does not take.

On CUDA tensors a chunk of t sweeps is one cooperative launch of the
chunk kernel (JAX's one invocation a chunk: the block on chip, cut over
the card's SMs by `chunk_layout`) where that layout gives each CTA at
least CHUNK_MIN_PLANES planes (the 128^3 level's blocks on 1, 2 and 4
ranks); other blocks take the port's first form, 2t launches of the
one-colour kernel between the block and a scratch buffer (`form`,
`chunk_launches`), which the card runs faster there.  Both count in
`launches["masked_block"]`.  The wrapper serves Poisson with `pre`
empty (the HJB keep-mask variant is ROADMAP.md queue 2 item 40), runs
the plain version for CPU tensors, and raises for anything else; there
is no fallback from a CUDA tensor to the plain version.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from pde_multigrid_tpu_torch.grid import LevelGeometry
from pde_multigrid_tpu_torch.models.poisson import split_constants
from pde_multigrid_tpu_torch.ops.cuda import build
from pde_multigrid_tpu_torch.ops.cuda.relax import (
    _check_poisson,
    _on_cuda,
    _sm_count,
    _stream,
)

launches = {"masked_block": 0}

# the chunk kernel's limits (csrc/masked_block.cu): threads and dynamic
# shared memory a CTA, x planes a block (4 mask bits a plane of a thread's
# column in a 64-bit word), sweeps a launch, and the SMs of the card the
# layout is planned for (an H100 SXM's; the wrapper asks the device)
CHUNK_THREADS = 512
CHUNK_SMEM_BYTES = 232448
CHUNK_MAX_PLANES = 16
CHUNK_MAX_SWEEPS = 127
CHUNK_SMS = 132
# the chunk form runs where its layout gives a CTA at least this many
# planes: below, the faces' round trip through the L2 each half-sweep
# costs more than the one-colour launch it saves (chip_smoke.py times both
# forms on every block of the sharded rows; PERF.md section 6 row 6)
CHUNK_MIN_PLANES = 3


class MaskedChunkLayout(ctypes.Structure):
    """csrc/masked_block.cu `MaskedChunkLayout`: the chunk's launch
    geometry."""

    _fields_ = [(n, ctypes.c_int) for n in
                ("ctas", "planes", "rows", "xblocks", "yblocks", "threads",
                 "smem_bytes")]


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def masked_block_plain(v_ext, f_ext, pre, m_red, m_black, t: int, problem,
                       geom: LevelGeometry):
    """`t` sweeps of `v = v + m * (kernel_update(v, f) - v)`, red then
    black, on the whole block (JAX's `_sweeps`): the problem's rolls wrap
    every axis within the block.  A new tensor, in any float dtype."""
    v = v_ext
    for _ in range(t):
        v = v + m_red * (problem.kernel_update(v, f_ext, pre, geom) - v)
        v = v + m_black * (problem.kernel_update(v, f_ext, pre, geom) - v)
    return v


def chunk_layout(XB: int, Y: int, Z: int,
                 sms: int = CHUNK_SMS) -> dict | None:
    """The chunk kernel's launch geometry on an (XB, Y, Z) block with
    `sms` SMs, or None where it cannot hold the block: the block cut into
    blocks of "planes" x planes (at most CHUNK_MAX_PLANES) by "rows" y
    rows, every z, "xblocks" x "yblocks" of them, one CTA a block and at
    most one an SM ("ctas"); "threads" a CTA (a thread on a z quad of a
    row: as many rows as CHUNK_THREADS take, Z % 4 == 0) and "smem_bytes"
    (its block of v with a halo row either side of each plane's rows, and
    of f; the masks stay in device memory, the faces shared with the x
    and y neighbours go through it)."""
    if min(XB, Y) < 1 or Z < 4 or Z % 4 or sms < 1:
        return None
    zq = Z // 4
    if zq > CHUNK_THREADS:
        return None
    rows = min(Y, CHUNK_THREADS // zq)
    yblocks = -(-Y // rows)
    if yblocks > sms:
        return None
    planes = -(-XB // min(XB, sms // yblocks))
    smem = 4 * planes * Z * (2 * rows + 2)
    if planes > CHUNK_MAX_PLANES or smem > CHUNK_SMEM_BYTES:
        return None
    if yblocks > 1 and planes > rows:  # a thread's share of the halo rows
        return None
    xblocks = -(-XB // planes)
    return {"ctas": xblocks * yblocks, "planes": planes, "rows": rows,
            "xblocks": xblocks, "yblocks": yblocks,
            "threads": -(-rows * zq // 32) * 32, "smem_bytes": smem}


def form(shape, sms: int = CHUNK_SMS) -> str:
    """The form a chunk takes on the card on a block of `shape`: "chunk"
    (one launch a chunk) where `chunk_layout` holds the 3D block with at
    least CHUNK_MIN_PLANES planes a CTA, else "half-sweeps" (one launch a
    colour half-sweep)."""
    lay = chunk_layout(*shape, sms) if len(shape) == 3 else None
    return ("chunk" if lay and lay["planes"] >= CHUNK_MIN_PLANES
            else "half-sweeps")


def chunk_launches(shape, t: int, sms: int = CHUNK_SMS) -> int:
    """Kernel launches of a chunk of t sweeps on a block of `shape`."""
    if t < 1:
        return 0
    return (-(-t // CHUNK_MAX_SWEEPS) if form(shape, sms) == "chunk"
            else 2 * t)


@functools.lru_cache(maxsize=None)
def _chunk_launch(XB: int, Y: int, Z: int, sms: int) -> MaskedChunkLayout:
    return MaskedChunkLayout(
        *(chunk_layout(XB, Y, Z, sms)[n] for n, _ in
          MaskedChunkLayout._fields_))


# per (device, layout): the chunk kernel's outboxes (int64 words) and its
# two counters (int32), zero when made and never cleared (csrc/
# masked_block.cu: the launch counter in the words' epochs)
_CHUNK_STATE: dict = {}


def _chunk_state(lay: MaskedChunkLayout, Z: int, device):
    """(box, count) of the chunk launches of one layout on one device: the
    legs of a device share them (they run on one stream).  Made once
    outside a CUDA graph capture; a capture that finds none makes its own
    (zeroed by a captured fill, so every replay starts afresh)."""
    key = (device, tuple(getattr(lay, n) for n, _ in lay._fields_), Z)
    state = _CHUNK_STATE.get(key)
    if state is None:
        state = (torch.zeros(lay.ctas * 4 * (lay.rows + lay.planes) * Z,
                             dtype=torch.int64, device=device),
                 torch.zeros(2, dtype=torch.int32, device=device))
        if not torch.cuda.is_current_stream_capturing():
            _CHUNK_STATE[key] = state
    return state


def _chunk(v, f, m_red, m_black, t: int, geom: LevelGeometry,
           lay: MaskedChunkLayout) -> None:
    """t sweeps of the block v in place, in launches of at most
    CHUNK_MAX_SWEEPS."""
    XB, Y, Z = v.shape
    (w0, w1, w2), inv_den = split_constants(geom)
    box, count = (None, None)
    if lay.ctas > 1:
        box, count = (a.data_ptr() for a in _chunk_state(lay, Z, v.device))
    fn = build.load().lib.pdemg_masked_chunk
    while t > 0:
        n = min(t, CHUNK_MAX_SWEEPS)
        rc = fn(ctypes.byref(lay), v.data_ptr(), f.data_ptr(),
                m_red.data_ptr(), m_black.data_ptr(), box, count, XB, Y, Z,
                n, w0, w1, w2, inv_den, _stream())
        launches["masked_block"] += 1
        build.check(rc, "masked_block (chunk)")
        t -= n


def _half_sweeps(v, f, m_red, m_black, t: int, geom: LevelGeometry) -> None:
    """t sweeps of the block v in place: 2t launches of the one-colour
    kernel, one per colour, between v and one scratch buffer."""
    XB, Y, Z = v.shape
    (w0, w1, w2), inv_den = split_constants(geom)
    fn = build.load().lib.pdemg_masked_block
    stream = _stream()
    other = torch.empty_like(v)
    pf = f.data_ptr()
    for _ in range(t):
        for src, dst, m in ((v, other, m_red), (other, v, m_black)):
            rc = fn(src.data_ptr(), pf, m.data_ptr(), dst.data_ptr(), XB, Y,
                    Z, w0, w1, w2, inv_den, stream)
            launches["masked_block"] += 1
            build.check(rc, "masked_block")


def masked_block(v_ext, f_ext, pre, m_red, m_black, t: int, problem,
                 geom: LevelGeometry):
    """`masked_block_plain`'s `t` sweeps written back into `v_ext` (the
    block is the caller's scratch).  On CUDA tensors one launch of the
    chunk kernel where `form` (with the card's SMs) says so, else 2t
    launches of the one-colour kernel."""
    shape = tuple(v_ext.shape)
    if len(shape) != geom.ndim or any(
            tuple(a.shape) != shape for a in (f_ext, m_red, m_black)):
        raise ValueError("masked block operands differ in shape")
    if not _on_cuda(v_ext, f_ext, m_red, m_black):
        return v_ext.copy_(masked_block_plain(v_ext, f_ext, pre, m_red,
                                              m_black, t, problem, geom))
    _check_poisson(problem)
    if pre or geom.ndim != 3:
        raise ValueError("the masked block kernel serves 3D Poisson blocks "
                         "(no per-point coefficients)")
    if t < 1:
        return v_ext
    sms = _sm_count(v_ext.device.index)
    if form(shape, sms) == "chunk":
        _chunk(v_ext, f_ext, m_red, m_black, t, geom,
               _chunk_launch(*shape, sms))
    else:
        _half_sweeps(v_ext, f_ext, m_red, m_black, t, geom)
    return v_ext
