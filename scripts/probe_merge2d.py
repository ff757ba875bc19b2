#!/usr/bin/env python3
"""Forms of the 2D merge converter (row 15) side by side on one card.

    python3 scripts/probe_merge2d.py [OUT_JSON]

Builds `scripts/probe_merge2d.cu` on its own (nvcc, sm_90a) beside the
package's kernels and, on every split level of the Lyapunov 4097^2 path
(4097^2 ... 513^2) and on an odd non-square shape, holds each form bitwise
against `relax2d.merge_colors_2d` and times it graph-replayed
(`chip_smoke.device_ms`) in two turns, the second in reverse order: the
package's `relax2d.from_halves`; `thread`, a thread per dense point (the
port's first form); `quads` with 1, 2, 4, 8 quads a thread and 4 or 8
CTAs an SM (the package's form: quads, 8 CTAs an SM, Q = 8 at 4097^2
and 1 below); `staged`,
R rows of both halves through shared memory.  Prints one PROBE JSON
line a form and shape, and writes them all to OUT_JSON (default
log/probe_merge2d.json).  Imports nothing of JAX; needs a CUDA
card.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

SHAPES = ((4097, 4097), (2049, 2049), (1025, 1025), (513, 513),
          (1025, 2047))


def build_probe() -> ctypes.CDLL:
    from pde_multigrid_tpu_torch.ops.cuda import build

    out = os.path.join(tempfile.mkdtemp(), "libprobe_merge2d.so")
    cmd = [build._nvcc(), *build.ARCH, "-std=c++17", "-O3", "--fmad=false",
           "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-shared", "-o", out,
           os.path.join(HERE, "probe_merge2d.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    sys.stderr.write(proc.stderr)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed: {proc.returncode}")
    lib = ctypes.CDLL(out)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.probe_merge_thread.argtypes = (P, P, P, I, I, P)
    lib.probe_merge_quads.argtypes = (P, P, P, I, I, I, I, P)
    lib.probe_merge_staged.argtypes = (P, P, P, I, I, I, P)
    return lib


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke as c
    from pde_multigrid_tpu_torch.ops.cuda import relax2d as R2

    out_path = sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        "log", "probe_merge2d.json")
    card = c.phase_card(torch)
    c.phase_build()
    lib = build_probe()
    rng = np.random.default_rng(2051)
    recs = []
    for X, Y in SHAPES:
        Y2 = (Y + 1) // 2
        r, b = (torch.tensor(rng.standard_normal((X, Y2)).astype(np.float32),
                             device="cuda") for _ in range(2))
        want = R2.merge_colors_2d(r, b, Y)
        v = torch.empty((X, Y), device="cuda")

        def ptrs():
            s = torch.cuda.current_stream().cuda_stream
            return r.data_ptr(), b.data_ptr(), v.data_ptr(), X, Y, s

        def call(fn, *a):
            def go():
                p = ptrs()
                rc = fn(*p[:5], *a, p[5])
                if rc:
                    raise RuntimeError(f"launch failed: {rc}")
            return go

        R = max(1, 4096 // Y2)
        forms = {"package": lambda: R2.from_halves(r, b, v),
                 "thread": call(lib.probe_merge_thread)}
        for Q in (1, 2, 4, 8):
            for per_sm in (4, 8):
                forms[f"quads Q={Q} ctas/SM={per_sm}"] = call(
                    lib.probe_merge_quads, Q, per_sm)
        for rr in (R, 2 * R):
            forms[f"staged R={rr}"] = call(lib.probe_merge_staged, rr)
        times = {k: [] for k in forms}
        for name, fn in forms.items():
            v.fill_(float("nan"))
            fn()
            torch.cuda.synchronize()
            if not torch.equal(v, want):
                raise SystemExit(f"{name} at {X}x{Y} not bitwise")
        for order in (list(forms), list(forms)[::-1]):
            for name in order:
                times[name].append(c.device_ms(torch, forms[name], 10))
        nbytes = r.nbytes + b.nbytes + v.nbytes
        for name, ts in times.items():
            rec = {"shape": [X, Y], "form": name, "ms": sum(ts) / 2,
                   "runs_ms": ts, "bound_ms": nbytes / c.HBM_BYTES_PER_S
                   * 1e3, "card": card}
            recs.append(rec)
            print("PROBE " + json.dumps(rec), flush=True)
        del r, b, v, want
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as fh:
        json.dump(recs, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
