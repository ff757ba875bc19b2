#!/usr/bin/env python3
"""Rows 25 and 26 (csrc/transfer.cu) by layout, on one card.

    python3 scripts/probe_transfer.py [--quick]

On every fine level of the 513^3 path (512^3 ... 4^3) and on two
non-cubic pairs, in both modes: the package's layout of each kernel
equal to its plain version (and the point form of row 25 bitwise the
walk), then the walk timed graph-replayed at the package's layout,
at other tile rows TJ and band counts, and in the point form, beside the
cell form of row 26; prints one JSON line a level and writes them all to
chiprun_out/probe_transfer.json.  `--quick` checks every level and times
nothing (the first call after a change).  These are the data behind
`transfer.restrict_layout`'s choices.  Imports nothing of JAX; needs a
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

LEVELS = [(n, n, n) for n in (512, 256, 128, 64, 32, 16, 8, 4)] + [
    (8, 4, 16), (64, 32, 128)]


def launch(torch, v, f, out, lay, geom):
    from pde_multigrid_tpu_torch.models.poisson import inv_h2
    from pde_multigrid_tpu_torch.ops.cuda import build

    w0, w1, w2 = inv_h2(geom)
    rc = build.load().lib.pdemg_residual_restrict(
        v.data_ptr(), f.data_ptr(), out.data_ptr(), ctypes.byref(lay), w0,
        w1, w2, torch.cuda.current_stream().cuda_stream)
    build.check(rc, "residual_restrict")
    return out


def bits(torch, a):
    return a.contiguous().view(torch.int32)


def main() -> int:
    import numpy as np
    import torch

    from pde_multigrid_tpu_torch.grid import wrap_interior
    from pde_multigrid_tpu_torch.models import Poisson3D
    from pde_multigrid_tpu_torch.ops.cuda import transfer as T

    quick = "--quick" in sys.argv
    c.phase_card(torch)
    c.phase_build()
    prob = Poisson3D()
    rng = np.random.default_rng(2055)
    recs = []
    for shape in LEVELS:
        cshape = tuple(n // 2 for n in shape)
        gf = _geom(shape)
        gc = _geom(cshape)
        v = torch.tensor((rng.standard_normal(shape) * wrap_interior(shape))
                         .astype(np.float32), device="cuda")
        f = torch.tensor(rng.standard_normal(shape).astype(np.float32),
                         device="cuda")
        cc = torch.tensor((rng.standard_normal(cshape)
                           * wrap_interior(cshape)).astype(np.float32),
                          device="cuda")
        rec = {"fine": shape}
        for wr in (True, False):
            key = "residual_restrict" if wr else "restrict"
            src = v if wr else f  # restrict alone on f: boundary not zero
            p = T.residual_restrict_plain(src, f, prob, gf, gc, wr)
            k = T.residual_restrict(src, f, prob, gf, gc, with_residual=wr)
            lay = T.restrict_layout(shape, wr)
            pt = launch(torch, src, f, torch.empty_like(p),
                        T.point_layout(shape, wr), gf)
            # against the plain version by value (torch.equal, as
            # chip_smoke.py: the plain version's boundary injection may
            # carry a zero of the other sign), against the point form by
            # bits
            ok = bool(torch.equal(k, p))
            ok_pt = bool(torch.equal(bits(torch, pt), bits(torch, k)))
            r = {"layout": lay.as_dict(), "bitwise_plain": ok,
                 "point_bitwise_walk": ok_pt}
            if not (ok and ok_pt):
                r["max_err"] = float((k - p).abs().max())
            if not quick:
                out = torch.empty_like(p)
                t = {}
                cands = {(lay.TJ, lay.grid_y)}
                Yc, Xc = cshape[1], cshape[0]
                for TJ in (1, 2, 4, 8):
                    for bands in (1, 2, 4, 8, 16, 32, 64):
                        if bands <= Xc and TJ <= Yc:
                            cands.add((TJ, bands))
                for TJ, bands in sorted(cands):
                    wl = T.walk_layout(shape, wr, TJ, bands)
                    if wl is None:
                        continue
                    got = launch(torch, src, f, out, wl, gf)
                    if not torch.equal(bits(torch, got), bits(torch, k)):
                        t[f"TJ{TJ} b{bands}"] = "NOT BITWISE"
                        continue
                    t[f"TJ{TJ} b{bands}"] = c.device_ms(
                        torch, lambda wl=wl: launch(torch, src, f, out,
                                                    wl, gf), 10)
                pl = T.point_layout(shape, wr)
                t["point"] = c.device_ms(
                    torch, lambda: launch(torch, src, f, out, pl, gf), 10)
                t["package"] = c.device_ms(
                    torch, lambda: T.residual_restrict(
                        src, f, prob, gf, gc, with_residual=wr), 10)
                nb = (2 if wr else 1) * v.nbytes + p.nbytes
                t["bound"] = nb / c.HBM_BYTES_PER_S * 1e3
                r["ms"] = t
            rec[key] = r
        pr = {}
        for mode in ("add", "replace"):
            p = T.prolong_blend_plain(cc, v, mode)
            k = T.prolong_blend(cc, v, mode, gc, gf)
            w = v.clone()
            T.prolong_blend(cc, w, mode, gc, gf, out=w)
            pr[mode] = bool(torch.equal(k, p)
                            and torch.equal(bits(torch, w), bits(torch, k)))
        pr["layout"] = T.prolong_layout(shape).as_dict()
        if not quick:
            dst = torch.empty_like(v)
            pr["ms"] = {
                "cell": c.device_ms(torch, lambda: T.prolong_blend(
                    cc, v, "add", gc, gf, out=dst), 10),
                "bound": (2 * v.nbytes + cc.nbytes) / c.HBM_BYTES_PER_S
                * 1e3}
        rec["prolong_blend"] = pr
        recs.append(rec)
        print("PROBE " + json.dumps(rec), flush=True)
        del v, f, cc
        torch.cuda.empty_cache()
    os.makedirs("chiprun_out", exist_ok=True)
    with open("chiprun_out/probe_transfer.json", "w") as fh:
        json.dump(recs, fh, indent=1)
    bad = [r["fine"] for r in recs
           if not all(r[k]["bitwise_plain"] and r[k]["point_bitwise_walk"]
                      for k in ("residual_restrict", "restrict"))
           or not (r["prolong_blend"]["add"]
                   and r["prolong_blend"]["replace"])]
    print(json.dumps({"ok": not bad, "not_bitwise": bad}))
    return 1 if bad else 0


def _geom(shape):
    from pde_multigrid_tpu_torch.grid import build_geometries

    return build_geometries(tuple(n + 1 for n in shape),
                            ((0.0, 1.0),) * 3, 1, wrap=True)[0]


if __name__ == "__main__":
    sys.exit(main())
