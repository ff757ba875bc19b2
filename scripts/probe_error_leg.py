#!/usr/bin/env python3
"""Where a half-sweep of the bf16 error leg (row 10's whole-leg kernel,
`csrc/relax.cu` error_leg_kernel) spends its time, on the card.

    python3 scripts/probe_error_leg.py            # from the repo root

Builds three copies of `csrc/relax.cu` with nvcc beside the port's own
build: as it is, without the waits for the neighbours' face words
("nowait": every x and j neighbour outside the block reads as 0), and
without those waits and without writing the words ("alone": the update
and the block barrier only).  Times a 100-sweep leg and a 1-sweep leg of
each on the 128^3, 64^3 and (98, 64, 128) halves levels (CUDA graphs,
`chip_smoke.device_ms`), and prints per half-sweep (100 sweeps less 1,
over 198) in turns.  Only the full copy computes the leg's function (it
is held bitwise against `relax.error_sweeps_plain`); the other two time
its parts.  Needs a CUDA card and nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

WAIT = "const bool poll = h > 0;"
PUBLISH = "const bool pub = h + 1 < 2 * a.nsweeps;"


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke as c
    from pde_multigrid_tpu_torch.grid import build_geometries
    from pde_multigrid_tpu_torch.models import Poisson3D
    from pde_multigrid_tpu_torch.models.poisson import folded_constants
    from pde_multigrid_tpu_torch.ops.cuda import build
    from pde_multigrid_tpu_torch.ops.cuda import relax as R

    c.phase_card(torch)
    csrc = os.path.join(HERE, "pde_multigrid_tpu_torch/ops/cuda/csrc")
    src = open(os.path.join(csrc, "relax.cu")).read()
    if WAIT not in src or PUBLISH not in src:
        raise SystemExit("relax.cu no longer has the lines this probe edits")
    copies = {"full": src,
              "nowait": src.replace(WAIT, "const bool poll = false;"),
              "alone": src.replace(WAIT, "const bool poll = false;")
              .replace(PUBLISH, "const bool pub = false;")}
    out = tempfile.mkdtemp(prefix="probe_error_leg_")
    procs = {}
    for name, text in copies.items():
        cu = os.path.join(out, f"{name}.cu")
        with open(cu, "w") as fh:
            fh.write(text)
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-shared", "-I", csrc, "-o",
             os.path.join(out, f"{name}.so"), cu],
            stdout=subprocess.DEVNULL, stderr=subprocess.STDOUT)
    for name, proc in procs.items():
        if proc.wait() != 0:
            raise SystemExit(f"nvcc failed on the {name} copy")
    libs = {name: ctypes.CDLL(os.path.join(out, f"{name}.so"))
            for name in copies}
    prob = Poisson3D()
    dev = torch.device("cuda")
    rng = np.random.default_rng(7)
    for shape in ((129, 129, 129), (65, 65, 65), (99, 129, 129)):
        g = build_geometries(shape, prob.domain, 1, wrap=True)[0]
        X, Y, Z = g.padded_shape
        rr, rb = [torch.tensor(rng.standard_normal((X, Y // 2, Z)).astype(
            np.float32), device=dev).to(torch.bfloat16) for _ in range(2)]
        iso, (a0, a1, a2), inv_den = folded_constants(g)
        lay = R.error_leg_layout(X, Y // 2, Z, R._sm_count(dev.index))
        st = R.ErrorLegLayout(*(lay[f] for f, _ in R.ErrorLegLayout._fields_))
        box = torch.zeros(2 * lay["ctas"] * (lay["rows"] + lay["planes"]) * Z,
                          dtype=torch.int64, device=dev)
        bar = torch.zeros(2, dtype=torch.int32, device=dev)
        er, eb = torch.empty_like(rr), torch.empty_like(rb)
        times = {name: [] for name in copies}
        for turn in (*copies, *reversed(copies)):
            fn = libs[turn].pdemg_error_leg
            fn.argtypes = build.SIGNATURES["pdemg_error_leg"]

            def run(nsw, fn=fn):
                build.check(fn(ctypes.byref(st), er.data_ptr(),
                               eb.data_ptr(), rr.data_ptr(), rb.data_ptr(),
                               box.data_ptr(), bar.data_ptr(), X, Y // 2, Z,
                               nsw, int(iso), a0, a1, a2, inv_den,
                               torch.cuda.current_stream().cuda_stream),
                            "error_leg probe")

            if turn == "full" and not times[turn]:
                run(100)
                want = R.error_sweeps_plain(rr, rb, 100, prob, g)
                if not (torch.equal(er, want[0]) and torch.equal(eb, want[1])):
                    raise SystemExit(f"{shape}: the full copy is not bitwise")
            leg = c.device_ms(torch, lambda: run(100), 2)
            one = c.device_ms(torch, lambda: run(1), 20)
            times[turn].append((leg, (leg - one) / 198 * 1e3))
        print({"halves": (X, Y // 2, Z), "layout": lay,
               **{name: {"leg_ms": sum(t[0] for t in v) / len(v),
                         "us_per_half_sweep": sum(t[1] for t in v) / len(v)}
                  for name, v in times.items()}}, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
