"""Build the port's CUDA kernels at first use and bind them with ctypes.

Each `csrc/*.cu` source compiles in its own nvcc process, all started
together, and one more nvcc call links the objects into one shared
library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false \
         -Xcompiler -fPIC -c -o <source>.o csrc/<source>.cu   # per source
    nvcc -gencode arch=compute_90a,code=sm_90a -shared -o libpdemg.so *.o

`--fmad=false` stops nvcc from contracting `a*b + c` into one fused
multiply-add.  PyTorch's separate elementwise ops round each product and
sum on its own, so with contraction off every kernel agrees with its plain
PyTorch version bit for bit (or to the last ulp where the order of a sum
differs); turning contraction back on is a later, separately toleranced
change.

The library lands in `_build/<hash>/` beside this file, keyed by a hash
of the sources (`*.cu` and the `*.cuh` they include) and the flags, so a
changed source rebuilds and an unchanged one loads in milliseconds.  A
failed build raises with nvcc's output.  Nothing here runs at import:
`load()` builds on its first call.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent / "_build"
LIB_NAME = "libpdemg.so"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *ARCH,
    "-std=c++17", "-O3", "--fmad=false",
    "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # per-kernel registers/spills into build.log
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# every pointer and the stream as c_void_p: without argtypes ctypes would
# pass Python ints as 32-bit C ints and cut the pointers
SIGNATURES = {
    "pdemg_split": (_P, _P, _P, _I, _I, _I, _P),
    "pdemg_merge": (_P, _P, _P, _I, _I, _I, _P),
    "pdemg_half_sweep": (_P, _P, _P, _I, _I, _I, _I, _F, _F, _F, _F, _P),
    "pdemg_error_half_sweep": (
        _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _F, _F, _P,
    ),
    # the error leg takes its launch geometry as a pointer to a host
    # struct (relax.ErrorLegLayout)
    "pdemg_error_leg": (
        _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _F, _F, _P,
    ),
    # the wavefront takes its launch geometry as a pointer to a host
    # struct (relax.TimeskewLayout)
    "pdemg_timeskew": (
        _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _F, _F, _P,
    ),
    "pdemg_timeskew_shard": (
        _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F,
        _F, _F, _P,
    ),
    "pdemg_timeskew_error": (
        _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _F, _F, _P,
    ),
    "pdemg_timeskew_clusters": (_P, _I, _I, _P),
    "pdemg_masked_block": (_P, _P, _P, _P, _I, _I, _I, _F, _F, _F, _F, _P),
    # the masked chunk takes its launch geometry as a pointer to a host
    # struct (masked_block.MaskedChunkLayout)
    "pdemg_masked_chunk": (
        _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _F, _F, _P,
    ),
    # the blocked kernel takes its launch geometry as a pointer to a host
    # struct (blocked3d.Blocked3DLayout)
    "pdemg_blocked3d": (_P, _P, _P, _P, _P, _P, _P, _F, _F, _F, _F, _P),
    "pdemg_residual_split": (_P, _P, _P, _P, _I, _I, _I, _F, _F, _F, _P),
    "pdemg_merge_fold": (_P, _P, _P, _I, _I, _I, _P),
    # the residual and the transfers take their launch geometry as a
    # pointer to a host struct (transfer.ResidualLayout,
    # transfer.RestrictLayout, transfer.ProlongLayout)
    "pdemg_residual": (_P, _P, _P, _P, _F, _F, _F, _P),
    "pdemg_residual_restrict": (_P, _P, _P, _P, _F, _F, _F, _P),
    "pdemg_prolong_blend": (_P, _P, _P, _P, _I, _P),
    # the 2D Lyapunov kernels take their constants as a pointer to a host
    # struct (relax2d.Lyap2DParams)
    "pdemg_split2d": (_P, _P, _P, _I, _I, _P),
    "pdemg_merge2d": (_P, _P, _P, _I, _I, _P),
    "pdemg_resident2d": (_P, _P, _I, _I, _I, _I, _I, _I, _P, _P),
    "pdemg_color_slab2d_shard": (
        _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P,
        _P,
    ),
    "pdemg_color_slab2d_leg": (
        _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P,
    ),
    # the 2D Poisson kernels take their constants as a pointer to a host
    # struct (relax2d.Poisson2DParams): the colour slab's chunk, the dense
    # leg (its layout resident.HJBLegLayout) and the slab (its layout
    # slab2d.HJBSlabLayout)
    "pdemg_color_slab2d_poisson": (
        _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P,
        _P,
    ),
    "pdemg_resident2d_poisson": (_P, _P, _I, _P, _P, _P),
    "pdemg_resident2d_poisson_clusters": (_P, _P),
    "pdemg_slab2d_poisson": (_P, _P, _P, _I, _P, _P, _P, _P, _P),
    # the reduced kernel its layout (reduced2d.Reduced2DLayout)
    "pdemg_reduced2d": (_P, _P, _P, _P, _P, _P, _P, _P, _P),
    # the HJB kernels take their fields as a pointer to a host struct
    # (resident.HJB2DParams), the leg its layout as another
    # (resident.HJBLegLayout)
    "pdemg_resident2d_hjb": (_P, _P, _I, _P, _P, _P),
    "pdemg_resident2d_hjb_clusters": (_P, _P),
    # the slab kernel: src, dst, f, the sweeps, its layout
    # (slab2d.HJBSlabLayout) and fields, and a leg's outboxes and counters
    "pdemg_slab2d": (_P, _P, _P, _I, _P, _P, _P, _P, _P),
    # the 1D whole-leg kernel: its layout as a pointer to a host struct
    # (relax1d.Relax1DLayout); Ode1D reads its coefficient fields, Poisson
    # takes a pointer to another (relax1d.Poisson1DParams)
    "pdemg_relax1d_ode": (_P, _P, _P, _P, _I, _P, _P),
    "pdemg_relax1d_poisson": (_P, _P, _I, _P, _P, _P),
    "pdemg_relax1d_clusters": (_P, _I, _P),
    # the stencil-operator kernels take the operator and the level as a
    # pointer to a host struct (stencilop.StencilOpParams)
    "pdemg_stencil_resident": (_P, _P, _P, _I, _I, _I, _P, _P),
    "pdemg_stencil_leg": (_P, _P, _P, _I, _I, _I, _I, _I, _P, _P),
    "pdemg_stencil_slab2d": (_P, _P, _P, _P, _I, _I, _I, _I, _P, _P),
    # the fused subtree V-cycle takes its levels as a pointer to a host
    # struct (subtree.SubtreeParams)
    "pdemg_subtree": (_P, _P, _P, _P),
    "pdemg_subtree_clusters": (_P, _P),
    # the whole-leg 3D resident kernel: v (or its halves r, b), f (or fr,
    # fb) and a pointer to a host struct (resident3d.Resident3DParams)
    "pdemg_resident3d": (_P, _P, _P, _P, _P, _P),
    "pdemg_resident3d_clusters": (_P, _P),
    # the padded 3D Poisson kernels take the constants as a pointer to a
    # host struct (padded3d.Poisson3DParams), the leg its layout as another
    # (padded3d.Padded3DLayout)
    "pdemg_padded3d": (_P, _P, _I, _P, _P, _P),
    "pdemg_padded3d_clusters": (_P, _P, _P),
    "pdemg_slab3d": (_P, _P, _P, _I, _P, _P),
    # a zebra line half-sweep: v, f, the dp scratch, the per-row constants,
    # a pointer to a host struct (zebra_line.ZebraLineParams) and ndim
    "pdemg_zebra_line": (_P, _P, _P, _P, _P, _I, _P),
}


class BuildError(RuntimeError):
    """nvcc failed or is missing; the message carries its output."""


class _Library:
    """The loaded kernels library and what it cost to get it."""

    def __init__(self, lib: ctypes.CDLL, path: Path, seconds: float,
                 built: bool):
        self.lib = lib
        self.path = path
        self.seconds = seconds
        self.built = built


_loaded: _Library | None = None


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    cands = [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise BuildError(
        "nvcc not found (looked on PATH and in /usr/local/cuda/bin); the "
        "CUDA kernels build only on a host with the CUDA toolkit"
    )


def _key() -> str:
    h = hashlib.sha256()
    for p in sorted([*sources(), *CSRC.glob("*.cuh")]):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _run_all(cmds: list[list[str]], logs: list[Path]) -> list[int]:
    """Start every command at once, each writing its output to its log;
    wait for all and return their exit codes."""
    procs = []
    for cmd, lg in zip(cmds, logs):
        with open(lg, "w") as fh:
            procs.append(subprocess.Popen(cmd, stdout=fh,
                                          stderr=subprocess.STDOUT))
    return [p.wait() for p in procs]


def _compile(out_dir: Path) -> None:
    out_dir.mkdir(parents=True, exist_ok=True)
    # private names (pid, then a temporary .so renamed into place):
    # concurrent processes never load a half-written library
    tag = str(os.getpid())
    nvcc = _nvcc()
    objs = [out_dir / f"{s.stem}.{tag}.o" for s in sources()]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)]
            for s, o in zip(sources(), objs)]
    logs = [o.with_suffix(".log") for o in objs]
    rcs = _run_all(cmds, logs)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    if not any(rcs):
        cmds.append([nvcc, *ARCH, "-shared", "-o", tmp, *map(str, objs)])
        logs.append(out_dir / f"link.{tag}.log")
        rcs += _run_all(cmds[-1:], logs[-1:])
    log = "".join(" ".join(c) + "\n" + lg.read_text()
                  for c, lg in zip(cmds, logs))
    (out_dir / "build.log").write_text(log)
    for p in (*objs, *logs):
        p.unlink(missing_ok=True)
    if any(rcs):
        os.unlink(tmp)
        raise BuildError(f"nvcc failed (exit codes {rcs}):\n{log}")
    os.replace(tmp, out_dir / LIB_NAME)


def load() -> _Library:
    """Build (if needed) and load the kernels library; cached for the
    process.  Raises BuildError when nvcc is missing or fails."""
    global _loaded
    if _loaded is not None:
        return _loaded
    t0 = time.perf_counter()
    out_dir = BUILD_ROOT / _key()
    path = out_dir / LIB_NAME
    built = not path.exists()
    if built:
        _compile(out_dir)
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _loaded = _Library(lib, path, time.perf_counter() - t0, built)
    return _loaded


def build_log() -> str:
    """nvcc's output of the build the loaded library came from."""
    lib = load()
    log = lib.path.parent / "build.log"
    return log.read_text() if log.exists() else ""


def check(rc: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if rc != 0:
        raise RuntimeError(f"CUDA launch of {what} failed: cudaError {rc}")
