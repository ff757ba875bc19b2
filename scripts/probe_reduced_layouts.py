#!/usr/bin/env python3
"""Row 18's kernel (csrc/reduced2d.cu) in each of its forms on one card:
f-less chunks on random halves of the 4097^2 Lyapunov plan's levels at
their T and the legs' remainder 4 (and 4097^2 at T = 1), with 16 warps a
CTA on a 48-row region and 32 warps on 64- and 96-row regions
(`reduced2d.make_layout`), each held bitwise against the plain version
and timed graph-replayed.  Prints one JSON line per launch: the data
behind `reduced2d.layout`'s choice.

    python3 scripts/probe_reduced_layouts.py

Imports nothing of JAX; needs a CUDA card."""

import ctypes
import json
import sys

import numpy as np
import torch

sys.path.insert(0, ".")
import chip_smoke as c  # noqa: E402
from pde_multigrid_tpu_torch.grid import build_geometries  # noqa: E402
from pde_multigrid_tpu_torch.models import Lyapunov2D  # noqa: E402
from pde_multigrid_tpu_torch.ops.cuda import build  # noqa: E402
from pde_multigrid_tpu_torch.ops.cuda import reduced2d as RD  # noqa: E402
from pde_multigrid_tpu_torch.ops.cuda import relax2d as R2  # noqa: E402
from pde_multigrid_tpu_torch.ops.cuda.relax import _stream  # noqa: E402

c.phase_card(torch)
c.phase_build()
lib = build.load().lib
prob = Lyapunov2D()
rng = np.random.default_rng(2045)
for n, T in ((4097, 1), (4097, 4), (4097, 8), (2049, 8), (2049, 4),
             (1025, 16), (1025, 4), (513, 16), (513, 4)):
    g = build_geometries((n, n), prob.domain, 1)[0]
    r, b = (torch.tensor(rng.standard_normal((n, (n + 1) // 2)).astype(
        np.float32), device="cuda") for _ in range(2))
    ko = (torch.empty_like(r), torch.empty_like(b))
    want = RD.reduced_slab2d_plain(r, b, None, None, T, prob, g)
    params = R2.lyap_params(prob, g)
    base = RD.layout(*r.shape, T)
    for rows, IX in ((16, 3), (32, 2), (32, 3)):
        if rows * IX - 2 * T < 16:
            continue
        lay = RD.make_layout(*r.shape, T, rows, IX)

        def run():
            rc = lib.pdemg_reduced2d(
                r.data_ptr(), b.data_ptr(), None, None, ko[0].data_ptr(),
                ko[1].data_ptr(), ctypes.byref(lay),
                ctypes.addressof(params), _stream())
            build.check(rc, "reduced2d")

        run()
        ok = all(map(torch.equal, ko, want))
        ms = c.device_ms(torch, run, 5)
        print(json.dumps({"n": n, "T": T, "warps": rows, "IX": IX,
                          "planned": lay.as_dict() == base.as_dict(),
                          "ctas": lay.tj * lay.tx, "bitwise": ok, "ms": ms}),
              flush=True)
