#!/usr/bin/env python3
"""Rows 18 and 19 level by level, on one card, in one or two checkouts.

    python3 scripts/probe_reduced_blocked.py [PARENT_DIR]

In each checkout (this one, and PARENT_DIR's in turns P, C, C, P when
given), in a process of its own with its own kernels build: the reduced
2D kernel (`reduced2d.reduced_chunk`, row 18) on random halves of every
level of the 4097^2 Lyapunov plan (4097^2 ... 513^2) at JAX's T, at the
remainder T = 4 and at 1, and on 129^2 at 1, 7, 8, 9 and 16 sweeps, with
and without f; the blocked 3D kernel (`blocked3d.blocked_chunk`, row 19)
on random halves of 256^3 at T = 1-4 and of 512^3 at T = 1.  Each launch
is held bitwise against its plain version (row 19 also against row 9's
half-sweep chain) and timed graph-replayed (f-less for row 18); each
side prints one `PROBE` JSON line of times and the SHA-256 of every
output.  Then, with PARENT_DIR, one line: whether both sides' outputs
are bitwise the same, and each side's mean time by launch.  Imports
nothing of JAX; needs a CUDA card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

SIDE = r"""
import hashlib, json, sys, torch
import numpy as np
sys.path.insert(0, ".")
import chip_smoke as c
from pde_multigrid_tpu_torch.grid import build_geometries
from pde_multigrid_tpu_torch.models import Lyapunov2D, Poisson3D
from pde_multigrid_tpu_torch.ops.cuda import blocked3d as BL
from pde_multigrid_tpu_torch.ops.cuda import reduced2d as RD
from pde_multigrid_tpu_torch.ops.cuda import relax as R

c.phase_card(torch)
c.phase_build()
if sys.argv[1] == "C1":  # the two kernels' registers and spills
    from pde_multigrid_tpu_torch.ops.cuda import build
    lines = build.build_log().splitlines()
    for i, ln in enumerate(lines):
        if "entry function" in ln and ("reduced2d" in ln or "blocked3d" in ln):
            print(ln.split("'")[1][-60:], *(x.strip() for x in lines[i + 2:i + 4]))
dev = torch.device("cuda")
rng = np.random.default_rng(2041)
ms, sha, bad = {}, hashlib.sha256(), []


def rand(*shape):
    return torch.tensor(rng.standard_normal(shape).astype(np.float32),
                        device=dev)


prob = Lyapunov2D()
cases = [(4097, (8, 4, 1)), (2049, (8, 4, 1)), (1025, (16, 4, 1)),
         (513, (16, 4, 1)), (129, (1, 7, 8, 9, 16))]
for n, ts in cases:
    g = build_geometries((n, n), prob.domain, 1)[0]
    r, b, fr, fb = (rand(n, (n + 1) // 2) for _ in range(4))
    ko = (torch.empty_like(r), torch.empty_like(b))
    for T in ts:
        for hf in ((fr, fb), (None, None)):
            RD.reduced_chunk(r, b, *hf, T, prob, g, ko)
            p = RD.reduced_slab2d_plain(r, b, *hf, T, prob, g)
            if not all(map(torch.equal, ko, p)):
                bad.append(f"reduced2d {n}^2 T={T} f={hf[0] is not None}")
            for t in ko:
                sha.update(t.cpu().numpy().tobytes())
        if n != 129:
            ms[f"reduced2d {n}^2 T={T}"] = c.device_ms(
                torch, lambda: RD.reduced_chunk(r, b, None, None, T, prob, g,
                                                ko), 5)
    del r, b, fr, fb, ko

prob = Poisson3D()
for n, ts in ((256, (1, 2, 3, 4)), (512, (1,))):
    g = build_geometries((n + 1,) * 3, prob.domain, 1, wrap=True)[0]
    hv = [rand(n, n // 2, n) for _ in range(4)]
    ko = (torch.empty_like(hv[0]), torch.empty_like(hv[1]))
    for T in ts:
        BL.blocked_chunk(*hv, T, prob, g, ko)
        torch.cuda.synchronize()
        ch = [a.clone() for a in hv[:2]]
        R.relax_halves(*ch, *hv[2:], T, prob, g)
        if not all(map(torch.equal, ko, ch)):
            bad.append(f"blocked3d {n}^3 T={T} vs row 9's chain")
        if n == 256:
            p = BL.blocked_slab3d_plain(*hv, T, prob, g)
            if not all(map(torch.equal, ko, p)):
                bad.append(f"blocked3d {n}^3 T={T} vs its plain version")
        for t in ko:
            sha.update(t.cpu().numpy().tobytes())
        ms[f"blocked3d {n}^3 T={T}"] = c.device_ms(
            torch, lambda: BL.blocked_chunk(*hv, T, prob, g, ko), 10)
    del hv, ko

print("PROBE " + json.dumps({"side": sys.argv[1], "ms": ms,
                             "sha256": sha.hexdigest(), "bad": bad}),
      flush=True)
"""


def run_side(path: str, label: str) -> dict:
    proc = subprocess.run([sys.executable, "-c", SIDE, label], cwd=path,
                          capture_output=True, text=True)
    sys.stderr.write(proc.stderr[-4000:])
    rec = None
    for ln in proc.stdout.splitlines():
        if ln.startswith("PROBE "):
            rec = json.loads(ln[6:])
            print(ln, flush=True)
        else:
            print(f"  [{label}] {ln}"[:400], flush=True)
    if proc.returncode != 0 or rec is None:
        raise SystemExit(f"side {label} ({path}) failed: rc "
                         f"{proc.returncode}")
    return rec


def main() -> int:
    change = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
    if len(sys.argv) < 2:
        rec = run_side(change, "C1")
        return 1 if rec["bad"] else 0
    parent = os.path.abspath(sys.argv[1])
    order = (("P1", parent), ("C1", change), ("C2", change), ("P2", parent))
    runs = {label: run_side(path, label) for label, path in order}
    keys = [k for k in runs["C1"]["ms"] if all(k in r["ms"] for r in
                                               runs.values())]
    print(json.dumps({
        "bitwise_vs_P1": {lb: r["sha256"] == runs["P1"]["sha256"]
                          for lb, r in runs.items()},
        "bad": {lb: r["bad"] for lb, r in runs.items() if r["bad"]},
        "mean_ms": {k: {s: sum(r["ms"][k] for lb, r in runs.items()
                               if lb[0] == s) / 2 for s in "PC"}
                    for k in keys}}), flush=True)
    return 0 if all(not r["bad"] for r in runs.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
