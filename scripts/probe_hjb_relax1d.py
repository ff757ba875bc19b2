#!/usr/bin/env python3
"""Layouts of the HJB leg kernel (`ops/cuda/resident.py`, row 1's HJB
form) and the 1D relax kernel (`ops/cuda/relax1d.py`, row 2) on the card.

    python3 scripts/probe_hjb_relax1d.py [OTHER_DIR ...]

For every level of the HJB 513^2 hierarchy (257^2 .. 3^2) and the 1D
levels of the ode1d row (Ode1D 8193, 4097), of Poisson(1) at 8193 (8192
stored) and a few of the preset's smaller Ode1D levels, each candidate
layout (`resident._hjb_layout`, `relax1d._layout`) is launched through
the C entry points, checked bitwise against the plain version at 1,
T - 1, T, T + 1 and the leg's sweeps (30 for HJB, 1000 for 1D), and a
leg is timed graph-replayed (`chip_smoke.device_ms`).  With OTHER_DIRs
(checkouts of other commits, the parent first), the default layouts'
legs of every tree are timed through their wrappers in child processes,
in turns: the others, this tree twice, the others backwards.  Prints one
`PROBE` JSON line a leg.
Needs a CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the default layouts' legs through the wrappers, run in a tree's root
LEGS = r"""
import json, sys, numpy as np, torch
sys.path.insert(0, ".")
import chip_smoke as c
from pde_multigrid_tpu_torch.grid import build_geometries
from pde_multigrid_tpu_torch.models import HJBMinTime, Ode1D, Poisson
from pde_multigrid_tpu_torch.ops.cuda import relax1d as R1
from pde_multigrid_tpu_torch.ops.cuda import resident as RS

c.phase_build()
rng = np.random.default_rng(7)
prob = HJBMinTime()
for g in build_geometries((513, 513), prob.domain)[1:]:
    v, f, _ = c._hjb_inputs(torch, rng, prob, g)
    ms = c.device_ms(torch, lambda: RS.resident_relax(v, f, 30, prob, g), 3)
    print("PROBE " + json.dumps({"side": sys.argv[1], "kernel": "hjb",
                                 "level": g.padded_shape[0], "ms": ms}))
for prob, n, wrap in ((Ode1D(), 8193, False), (Ode1D(), 4097, False),
                      (Poisson(1), 8193, True)):
    g = build_geometries((n,), prob.domain, 1, wrap=wrap)[0]
    v, f = (torch.tensor(rng.standard_normal(g.padded_shape).astype(
        np.float32), device="cuda") for _ in range(2))
    ms = c.device_ms(torch, lambda: R1.relax1d(v, f, 1000, prob, g), 3)
    print("PROBE " + json.dumps({"side": sys.argv[1], "kernel": prob.name,
                                 "level": n, "ms": ms}))
"""


FAILS = []


def ok(cond: bool, what: str) -> bool:
    """Record and print a failed check; go on with the next layout."""
    if not cond:
        FAILS.append(what)
        print(f"FAIL {what}", flush=True)
    return cond


def stream() -> int:
    import torch

    return torch.cuda.current_stream().cuda_stream


def probe_hjb(torch, c, rng):
    from pde_multigrid_tpu_torch.grid import build_geometries
    from pde_multigrid_tpu_torch.models import HJBMinTime
    from pde_multigrid_tpu_torch.ops.cuda import build
    from pde_multigrid_tpu_torch.ops.cuda import resident as RS

    lib = build.load().lib
    prob = HJBMinTime()
    for g in build_geometries((513, 513), prob.domain)[1:]:
        X, Y = g.padded_shape
        v, f, fixed = c._hjb_inputs(torch, rng, prob, g)
        params, _ = RS.hjb_fields(prob, g, v.device)
        cands = [RS._hjb_layout(X, Y, 1, 0, G) for G in range(1, 9)]
        cands += [RS._hjb_layout(X, Y, n, T, G) for n in (16, 15, 12, 8)
                  for T in (2, 4) for G in (1, 2, 3, 4)]
        default = RS.hjb_leg_layout(g).as_dict()
        ref = {}
        for lay in filter(None, cands):
            if lay.nctas > 1:
                n = ctypes.c_int(0)
                build.check(lib.pdemg_resident2d_hjb_clusters(
                    ctypes.byref(lay), ctypes.byref(n)), "clusters")
                if n.value < 1:
                    continue
            T = lay.T or 30
            good = True
            for ns in sorted({1, max(T - 1, 1), T, T + 1, 30}):
                if ns not in ref:
                    ref[ns] = RS.resident_relax_plain(v.clone(), f, ns, prob,
                                                      g)
                k = v.clone()
                build.check(lib.pdemg_resident2d_hjb(
                    k.data_ptr(), f.data_ptr(), ns, ctypes.byref(lay),
                    ctypes.byref(params), stream()), "hjb")
                torch.cuda.synchronize()
                good &= ok(torch.equal(k, ref[ns]) and
                           torch.equal(k[fixed], v[fixed]),
                           f"hjb {X}^2 {ns} sweeps {lay.as_dict()}")
            if not good:
                continue
            w = v.clone()

            def leg():
                lib.pdemg_resident2d_hjb(
                    w.data_ptr(), f.data_ptr(), 30, ctypes.byref(lay),
                    ctypes.byref(params), stream())

            ms = c.device_ms(torch, leg, 3)
            d = lay.as_dict()
            print("PROBE " + json.dumps({
                "kernel": "hjb", "level": X, "nctas": d["nctas"],
                "T": d["T"], "G": d["G"], "L": d["L"],
                "threads": d["threads"], "default": d == default,
                "ms": ms, "us_per_sweep": ms / 30 * 1e3}), flush=True)


def probe_1d(torch, c, rng):
    import numpy as np

    from pde_multigrid_tpu_torch.grid import build_geometries
    from pde_multigrid_tpu_torch.models import Ode1D, Poisson
    from pde_multigrid_tpu_torch.models.poisson import split_constants
    from pde_multigrid_tpu_torch.ops.cuda import build
    from pde_multigrid_tpu_torch.ops.cuda import relax1d as R1

    lib = build.load().lib
    for prob, n, wrap in ((Ode1D(), 8193, False), (Ode1D(), 4097, False),
                          (Poisson(1), 8193, True), (Ode1D(), 1025, False),
                          (Ode1D(), 513, False), (Ode1D(), 257, False),
                          (Ode1D(), 17, False), (Ode1D(), 3, False)):
        g = build_geometries((n,), prob.domain, 1, wrap=wrap)[0]
        (N,) = g.padded_shape
        last = g.shape[0] - 2
        ode = isinstance(prob, Ode1D)
        v, f = (torch.tensor(rng.standard_normal(N).astype(np.float32),
                             device="cuda") for _ in range(2))
        if wrap:
            v[0] = 0.0
        _, _, pre = R1._plain_fields(prob, g, v.dtype, v.device)
        w_, inv_den = split_constants(g)
        pp = R1.Poisson1DParams(w_[0], inv_den)
        default = R1.layout(g, prob).as_dict()
        cands = [R1._layout(N, last, wrap, not ode, K, 0, 1)
                 for K in R1.K_CHOICES]
        cands += [R1._layout(N, last, wrap, not ode, K, T, wpc)
                  for K in (4, 8) for T in (32, 64, 128)
                  for wpc in (1, 2, 3, 4)]
        seen, ref = set(), {}
        for lay in filter(None, cands):
            key = tuple(lay.as_dict().items())
            if key in seen:
                continue
            seen.add(key)

            def call(t, ns, lay=lay):
                if ode:
                    return lib.pdemg_relax1d_ode(
                        t.data_ptr(), f.data_ptr(), pre["a_e"].data_ptr(),
                        pre["a_f"].data_ptr(), ns, ctypes.byref(lay),
                        stream())
                return lib.pdemg_relax1d_poisson(
                    t.data_ptr(), f.data_ptr(), ns, ctypes.byref(lay),
                    ctypes.byref(pp), stream())

            if lay.nctas > 1:
                cl = ctypes.c_int(0)
                build.check(lib.pdemg_relax1d_clusters(
                    ctypes.byref(lay), int(not ode), ctypes.byref(cl)),
                    "clusters")
                if cl.value < 1:
                    continue
            good = True
            T = lay.T or 1000
            for ns in sorted({1, T - 1, T, T + 1, 1000}):
                if ns not in ref:
                    ref[ns] = R1.relax1d_plain(v.clone(), f, ns, prob, g)
                k = v.clone()
                build.check(call(k, ns), "relax1d")
                torch.cuda.synchronize()
                good &= ok(torch.equal(k, ref[ns]),
                           f"{prob.name} {n} {ns} sweeps {lay.as_dict()}")
            if not good:
                continue
            w = v.clone()
            ms = c.device_ms(torch, lambda: call(w, 1000), 3)
            d = lay.as_dict()
            print("PROBE " + json.dumps({
                "kernel": prob.name, "level": n, "nctas": d["nctas"],
                "wpc": d["wpc"], "K": d["K"], "T": d["T"],
                "default": d == default, "ms": ms,
                "us_per_sweep": ms / 1000 * 1e3}), flush=True)


def side(path: str, label: str) -> None:
    proc = subprocess.run([sys.executable, "-c", LEGS, label], cwd=path,
                          capture_output=True, text=True)
    sys.stderr.write(proc.stderr[-3000:])
    for ln in proc.stdout.splitlines():
        if ln.startswith("PROBE "):
            print(ln, flush=True)
    if proc.returncode != 0:
        raise SystemExit(f"side {label} ({path}) failed: rc "
                         f"{proc.returncode}")


def main() -> int:
    import numpy as np
    import torch

    sys.path.insert(0, HERE)
    import chip_smoke as c

    c.phase_card(torch)
    c.phase_build()
    rng = np.random.default_rng(2026)
    probe_hjb(torch, c, rng)
    probe_1d(torch, c, rng)
    others = [os.path.abspath(d) for d in sys.argv[1:]]
    if others:
        order = ([(f"P{i}", d) for i, d in enumerate(others)]
                 + [("C1", HERE), ("C2", HERE)]
                 + [(f"P{i}", d) for i, d in reversed(list(enumerate(others)))])
        for label, path in order:
            side(path, label)
    return 1 if FAILS else 0


if __name__ == "__main__":
    sys.exit(main())
