#!/usr/bin/env python3
"""Row 27, the 3D residual (csrc/transfer.cu), by layout, on one card.

    python3 scripts/probe_residual.py [--quick]

On every level of the 513^3 path and of FAS 257^3 (512^3 ... 2^3), on two
non-cubic levels and on one whose extents are not powers of two, with f
and f-less: the package's layout (`transfer.residual_layout`) equal to the
plain version bit for bit (the f-less one also to residual_plain(v, 0)),
and the point form bitwise the walk; then each timed graph-replayed at the
package's layout, at other tile rows TJ and band counts of the walk
(`transfer.residual_walk_layout`) and in the point form, beside the byte
bound; prints one JSON line a level and writes them all to
chiprun_out/probe_residual.json.  `--quick` checks every level and times
nothing (the first call after a change).  These are the data behind
`transfer.residual_layout`'s choices.  Imports nothing of JAX; needs a
CUDA card.
"""

from __future__ import annotations

import ctypes
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import chip_smoke as c  # noqa: E402

LEVELS = [(n,) * 3 for n in (512, 256, 128, 64, 32, 16, 8, 4, 2)] + [
    (64, 32, 128), (8, 4, 16), (24, 12, 20)]


def launch(torch, v, f, out, lay, geom):
    from pde_multigrid_tpu_torch.models.poisson import inv_h2
    from pde_multigrid_tpu_torch.ops.cuda import build

    w0, w1, w2 = inv_h2(geom)
    rc = build.load().lib.pdemg_residual(
        v.data_ptr(), None if f is None else f.data_ptr(), out.data_ptr(),
        ctypes.byref(lay), w0, w1, w2,
        torch.cuda.current_stream().cuda_stream)
    build.check(rc, "residual")
    return out


def bits(torch, a):
    return a.contiguous().view(torch.int32)


def main() -> int:
    import numpy as np
    import torch

    from pde_multigrid_tpu_torch.grid import build_geometries, wrap_interior
    from pde_multigrid_tpu_torch.models import Poisson3D
    from pde_multigrid_tpu_torch.ops.cuda import transfer as T

    quick = "--quick" in sys.argv
    c.phase_card(torch)
    c.phase_build()
    prob = Poisson3D()
    rng = np.random.default_rng(2059)
    recs = []
    for shape in LEVELS:
        g = build_geometries(tuple(n + 1 for n in shape), ((0.0, 1.0),) * 3,
                             1, wrap=True)[0]
        v = torch.tensor((rng.standard_normal(shape) * wrap_interior(shape))
                         .astype(np.float32), device="cuda")
        f = torch.tensor(rng.standard_normal(shape).astype(np.float32),
                         device="cuda")
        out = torch.empty_like(v)
        rec = {"level": shape}
        for with_f in (True, False):
            fx = f if with_f else None
            key = "f" if with_f else "f_less"
            p = T.residual_plain(v, f if with_f else torch.zeros_like(v),
                                 prob, g)
            k = (T.residual(v, f, prob, g) if with_f
                 else T.residual_zero_f(v, prob, g))
            lay = T.residual_layout(shape, with_f)
            pt = launch(torch, v, fx, torch.empty_like(v),
                        T.residual_point_layout(shape, with_f), g)
            ok = bool(torch.equal(bits(torch, k), bits(torch, p)))
            ok_pt = bool(torch.equal(bits(torch, pt), bits(torch, k)))
            r = {"layout": lay.as_dict(), "bitwise_plain": ok,
                 "point_bitwise": ok_pt}
            if not ok:
                r["max_err"] = float((k - p).abs().max())
            if not quick:
                t = {}
                cands = set()
                if lay.form == T.WALK:
                    cands.add((lay.TJ, lay.gy))
                for TJ in (1, 2, 4, 8, 16, 32, 64):
                    for bands in (1, 2, 4, 8, 16, 32, 64, 128, 256, 512):
                        if TJ <= shape[1] and bands <= shape[0]:
                            cands.add((TJ, bands))
                for TJ, bands in sorted(cands):
                    wl = T.residual_walk_layout(shape, with_f, TJ, bands)
                    # one wave or more of CTAs, and one CTA a level
                    ctas = (shape[1] // TJ) * bands if wl else 0
                    if wl is None or not (64 <= ctas <= 1024 or ctas == 1
                                          or shape[0] <= 64):
                        continue
                    got = launch(torch, v, fx, out, wl, g)
                    name = f"TJ{TJ} b{bands}"
                    if not torch.equal(bits(torch, got), bits(torch, k)):
                        t[name] = "NOT BITWISE"
                        continue
                    t[name] = c.device_ms(
                        torch, lambda wl=wl: launch(torch, v, fx, out, wl,
                                                    g), 10)
                pl = T.residual_point_layout(shape, with_f)
                t["point"] = c.device_ms(
                    torch, lambda: launch(torch, v, fx, out, pl, g), 10)
                t["package"] = c.device_ms(
                    torch, (lambda: T.residual(v, f, prob, g)) if with_f
                    else (lambda: T.residual_zero_f(v, prob, g)), 10)
                t["bound"] = ((3 if with_f else 2) * v.nbytes
                              / c.HBM_BYTES_PER_S * 1e3)
                r["ms"] = t
            rec[key] = r
        recs.append(rec)
        print("PROBE " + json.dumps(rec), flush=True)
        del v, f, out
        torch.cuda.empty_cache()
    os.makedirs("chiprun_out", exist_ok=True)
    with open("chiprun_out/probe_residual.json", "w") as fh:
        json.dump(recs, fh, indent=1)
    bad = [r["level"] for r in recs
           if not all(r[k]["bitwise_plain"] and r[k]["point_bitwise"]
                      for k in ("f", "f_less"))]
    bad += [r["level"] for r in recs for k in ("f", "f_less")
            if "NOT BITWISE" in r[k].get("ms", {}).values()]
    print(json.dumps({"ok": not bad, "not_bitwise": bad}))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
