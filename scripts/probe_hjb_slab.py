#!/usr/bin/env python3
"""Layouts of the HJB slab kernel (row 3, csrc/slab2d.cu) side by side on
one card, at the HJB row's 513^2 level.

    python3 scripts/probe_hjb_slab.py [OUT_JSON]

For every layout `slab2d._slab_layout` gives the 513^2 level in tiles of
32 x 64 points -- a whole leg in one cooperative launch with T = 2, 4, 8
sweeps between halo refreshes and every row count L a segment the CTA
holds, and at most T sweeps a launch (T = 2, 4, 8: the second form, each
thread's points with their fields in registers, a launch every T sweeps)
-- holds a 30-sweep and a 7-sweep leg bitwise against
`slab2d.slab_relax_plain` (ring and pinned ball unchanged) and times the
30-sweep leg graph-replayed (`chip_smoke.device_ms`), in two turns, the
second in reverse order, beside `slab2d.slab_relax` (the plan's layout).
Then the plan's layout over T, 2T and 30 sweeps (one chunk, one
refresh, the leg).  Prints one PROBE JSON line a layout and writes them
all to OUT_JSON
(default log/probe_hjb_slab.json).  Imports nothing of JAX;
needs a CUDA card.
"""

from __future__ import annotations

import ctypes
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

NSWEEPS = 30


def leg(lay, v, f, nsweeps, params):
    """`nsweeps` sweeps of v on the layout `lay`, as slab2d.slab_relax
    launches them on its own layout: a new tensor."""
    import torch

    from pde_multigrid_tpu_torch.ops.cuda import build
    from pde_multigrid_tpu_torch.ops.cuda import slab2d as SL

    box = count = None
    if lay.leg and lay.ctas > 1:
        box, count = (a.data_ptr() for a in SL._leg_state(lay, v.device))
    per = SL.sweeps_per_launch(lay)
    bufs = [torch.empty_like(v), torch.empty_like(v)]
    src, done = v, 0
    while done < nsweeps:
        dst = bufs[0] if src is not bufs[0] else bufs[1]
        here = min(per, nsweeps - done)
        build.check(build.load().lib.pdemg_slab2d(
            src.data_ptr(), dst.data_ptr(), f.data_ptr(), here,
            ctypes.byref(lay), ctypes.byref(params), box, count,
            torch.cuda.current_stream().cuda_stream), "slab2d (probe)")
        src, done = dst, done + here
    return src


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke as c
    from pde_multigrid_tpu_torch.grid import build_geometries
    from pde_multigrid_tpu_torch.models import HJBMinTime
    from pde_multigrid_tpu_torch.ops.cuda import resident as RS
    from pde_multigrid_tpu_torch.ops.cuda import slab2d as SL

    out_path = sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        "log", "probe_hjb_slab.json")
    card = c.phase_card(torch)
    c.phase_build()
    prob = HJBMinTime()
    g = build_geometries((c.HJB_N,) * 2, prob.domain, 1)[0]
    X, Y = g.padded_shape
    v, f, fixed = c._hjb_inputs(torch, np.random.default_rng(2052), prob, g)
    params, _ = RS.hjb_fields(prob, g, v.device)
    lays = {}
    for T in (2, 4, 8):
        for L in SL.SLAB_ROWS:
            lay = SL._slab_layout(X, Y, 32, 64, T, True, L)
            if lay is not None:
                lays[f"leg T={T} L={L}"] = lay
        lay = SL._slab_layout(X, Y, 32, 64, T, False)
        if lay is not None:
            lays[f"launch a T={T}"] = lay
    forms = {name: (lambda lay=lay: leg(lay, v, f, NSWEEPS, params))
             for name, lay in lays.items()}
    forms["slab_relax"] = lambda: SL.slab_relax(v, f, NSWEEPS, prob, g)
    want = {ns: SL.slab_relax_plain(v, f, ns, prob, g) for ns in (7, NSWEEPS)}
    for name, lay in lays.items():
        for ns, w in want.items():
            got = leg(lay, v, f, ns, params)
            if not (torch.equal(got, w) and torch.equal(got[fixed],
                                                        v[fixed])):
                raise SystemExit(f"{name}: {ns} sweeps not bitwise: max "
                                 f"diff {float((got - w).abs().max())!r}")
    times = {k: [] for k in forms}
    for order in (list(forms), list(forms)[::-1]):
        for name in order:
            times[name].append(c.device_ms(torch, forms[name], 3))
    # the plan's layout by sweep count: one chunk (T), one refresh (2T),
    # the leg: what a refresh costs beside a chunk's sweeps
    plan = SL.slab_layout(g)
    split = {ns: c.device_ms(torch, lambda ns=ns: SL.slab_relax(
        v, f, ns, prob, g), 3) for ns in (plan.T, 2 * plan.T, NSWEEPS)}
    print("PROBE " + json.dumps({"form": "slab_relax by sweeps",
                                 "ms": split, "card": card}), flush=True)
    cost = c._hjb_leg_cost(g, NSWEEPS)
    recs = []
    for name, ts in times.items():
        lay = lays.get(name, SL.slab_layout(g))
        rec = {"form": name, "ms": sum(ts) / 2, "runs_ms": ts,
               "layout": lay.as_dict(), **c.bound(*cost), "card": card}
        recs.append(rec)
        print("PROBE " + json.dumps(rec), flush=True)
    recs.append({"form": "slab_relax by sweeps", "ms": split, "card": card})
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as fh:
        json.dump(recs, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
