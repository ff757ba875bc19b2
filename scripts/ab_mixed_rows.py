#!/usr/bin/env python3
"""A/B of the port's mixed-precision 3D rows between two checkouts, on one
card, in turns.

    python3 scripts/ab_mixed_rows.py PARENT_DIR CHANGE_DIR [N ...]

Each side runs its own `chip_smoke.phase_main_path(torch, n, "mixed")`
(FMG(2, 100, 100), exact coarsest, through `MultigridSolver.solve()` on
"cuda": the solve with its gate and launch checks, then ms a step eager
and as one CUDA graph) for every n (default 129, 257, 513), in its own
process with its own kernels build, in the order PARENT, CHANGE, CHANGE,
PARENT.  Prints one `AB` JSON line per side and n (ms a step, error_linf,
the solution's SHA-256, the launch counts), then one line per n with the
mean graph and eager ms of each side and whether every solution is
bitwise the first parent run's; exits 1 if any side failed or a solution
differs.  Imports nothing of JAX; needs a CUDA card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

SIDE = r"""
import hashlib, json, sys, torch
sys.path.insert(0, ".")
import chip_smoke as c
c.phase_card(torch)
c.phase_build()
for n in map(int, sys.argv[2:]):
    counts, s, v = c.phase_main_path(torch, n, "mixed")
    sha = hashlib.sha256(v.cpu().numpy().tobytes()).hexdigest()
    print("AB " + json.dumps({"side": sys.argv[1], "n": n, "sha256": sha,
                              "summary": s, "counts": counts},
                             default=str), flush=True)
    del v
"""


def run_side(path: str, label: str, ns: list[int]) -> list[dict]:
    proc = subprocess.run([sys.executable, "-c", SIDE, label, *map(str, ns)],
                          cwd=path, capture_output=True, text=True)
    sys.stderr.write(proc.stderr[-4000:])
    rows = [json.loads(ln[3:]) for ln in proc.stdout.splitlines()
            if ln.startswith("AB ")]
    for ln in proc.stdout.splitlines():
        print(ln if ln.startswith("AB ") else f"  [{label}] {ln}"[:400])
    if proc.returncode != 0 or len(rows) != len(ns):
        raise SystemExit(f"side {label} ({path}) failed: rc "
                         f"{proc.returncode}")
    return rows


def main() -> int:
    if len(sys.argv) < 3:
        print(__doc__)
        return 2
    parent, change = (os.path.abspath(p) for p in sys.argv[1:3])
    ns = [int(n) for n in sys.argv[3:]] or [129, 257, 513]
    order = (("P1", parent), ("C1", change), ("C2", change), ("P2", parent))
    runs = {label: run_side(path, label, ns) for label, path in order}
    ok = True
    for i, n in enumerate(ns):
        ref = runs["P1"][i]["sha256"]
        same = {label: rows[i]["sha256"] == ref for label, rows in
                runs.items()}
        ok &= all(same.values())

        def mean(key, side):
            return sum(runs[lb][i]["summary"][key] for lb in runs
                       if lb[0] == side) / 2

        print(json.dumps({
            "n": n, "bitwise_vs_P1": same, "sha256_P1": ref,
            "graph_ms": {s: mean("graph_ms_per_step", s) for s in "PC"},
            "eager_ms": {s: mean("ms_per_step", s) for s in "PC"},
            "graph_ms_by_run": {lb: runs[lb][i]["summary"][
                "graph_ms_per_step"] for lb in runs},
            "error_linf": {lb: runs[lb][i]["summary"]["error_linf"]
                           for lb in runs}}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
