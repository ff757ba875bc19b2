"""Port parity of the whole-leg 3D resident kernel's plain versions
(`ops/cuda/resident3d.py`, what its wrappers run for CPU tensors) against
the JAX package's Pallas kernels in interpret mode, and its plan.

  * `merged_resident_plain` against `make_merged_resident_relax` (row 4)
    and the halves form `split_merged_plain` against
    `make_split_merged_relax` (row 5) on the 16^3 and 32^3 levels of 17^3
    and 33^3, nu = 1 and 3; the dense form against `make_resident_relax`
    (row 1) on 8^3, 4^3 and 2^3: float32 within 2 ulp of the largest value
    (XLA's CPU backend contracts `upd - v` with the product forming upd
    into one fused multiply-add; on the card, built with --fmad=false,
    the kernel equals these plain versions bit for bit);
  * both forms bitwise the port's row-9 chain (split, half-sweeps, merge)
    in float32 on every level of 33^3, and the dense form against JAX's
    `relax_rbgs` in float64 to 1e-12;
  * the plan: on every level of 33^3, 129^3 and 257^3 the tier JAX's
    `plan_relax` picks;
  * the wrappers' refusals, and no launch for CPU tensors.

The kernel itself runs only on the card; `chip_smoke.py`
(`phase_kernels_resident3d`) holds it against these plain versions and
the row-9 chain there."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pde_multigrid_tpu import grid as JG
from pde_multigrid_tpu.models import Poisson as JPoisson
from pde_multigrid_tpu.ops import stencil as JS
from pde_multigrid_tpu.ops.pallas import relax as JR
from pde_multigrid_tpu_torch import grid as TG
from pde_multigrid_tpu_torch.models import Poisson as TPoisson
from pde_multigrid_tpu_torch.ops import stencil
from pde_multigrid_tpu_torch.ops.cuda import relax as R
from pde_multigrid_tpu_torch.ops.cuda import resident3d as RS3
from pde_multigrid_tpu_torch.ops.cuda.dispatch import CudaKernels

F32 = jnp.dtype("float32")
DOM = ((0.0, 1.0),) * 3


def _level(n, seed, l=0, dtype=np.float32):
    """Level l of both packages' n^3 wrap hierarchies and (v, f) on it,
    v with the wrap invariant (stored planes 0 zero)."""
    jg = JG.build_geometries((n,) * 3, DOM, wrap=True)[l]
    tg = TG.build_geometries((n,) * 3, DOM, wrap=True)[l]
    rng = np.random.default_rng(seed)
    shape = tg.padded_shape
    v = (rng.standard_normal(shape) * TG.wrap_interior(shape)).astype(dtype)
    f = rng.standard_normal(shape).astype(dtype)
    return jg, tg, v, f


def _ulp(*arrays):
    return np.spacing(np.float32(max(np.abs(a).max() for a in arrays)))


@pytest.fixture(autouse=True)
def _no_launches():
    """CPU tensors never launch a kernel: every counter stays at zero."""
    RS3.reset_launches()
    R.reset_launches()
    yield
    assert not any(RS3.launches.values()) and not any(R.launches.values())


# ------------------------------------------------- vs the Pallas kernels


@pytest.mark.parametrize("n", [17, 33])
def test_merged_forms_match_the_interpreted_kernels(n):
    """Rows 4 and 5: the dense plain version (and its wrapper on CPU
    tensors, in place) against make_merged_resident_relax, the halves
    form against make_split_merged_relax (whose relax splits and merges
    around its kernel), nu = 1 and 3, within 2 ulp."""
    jg, tg, v, f = _level(n, seed=n)
    prob = TPoisson(3)
    merged = JR.make_merged_resident_relax(JPoisson(3), jg, F32,
                                           interpret=True)
    split = JR.make_split_merged_relax(JPoisson(3), jg, F32, interpret=True)
    vt, ft = torch.tensor(v), torch.tensor(f)
    fr, fb = R.split_colors(ft)
    for ns in (1, 3):
        got = RS3.merged_resident_plain(vt, ft, ns, prob, tg)
        want = np.asarray(merged(jnp.asarray(v), jnp.asarray(f), ns))
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=2 * _ulp(v, want))
        vw = vt.clone()
        assert RS3.merged_resident_relax(vw, ft, ns, prob, tg) is vw
        assert torch.equal(vw, got)
        r, b = R.split_colors(vt)
        ro, bo = RS3.split_merged_relax(r, b, fr, fb, ns, prob, tg)
        assert ro is r and bo is b
        want = np.asarray(split(jnp.asarray(v), jnp.asarray(f), ns))
        np.testing.assert_allclose(R.merge_colors(r, b).numpy(), want,
                                   rtol=0, atol=2 * _ulp(v, want))


@pytest.mark.parametrize("n", [9, 5, 3])
def test_resident3d_matches_the_interpreted_resident_kernel(n):
    """Row 1's 3D mode (8^3, 4^3, 2^3, one CTA) against
    make_resident_relax on the same level, nu = 1 and 3, within 2 ulp;
    2^3 (X = 2) reads both x neighbours on plane 0."""
    jg, tg, v, f = _level(n, seed=100 + n)
    fn = JR.make_resident_relax(JPoisson(3), jg, F32, interpret=True)
    assert RS3.one_cta(tg) and not RS3.merged_gate(tg)
    for ns in (1, 3):
        got = RS3.resident3d_relax(torch.tensor(v), torch.tensor(f), ns,
                                   TPoisson(3), tg)
        want = np.asarray(fn(jnp.asarray(v), jnp.asarray(f), ns))
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=2 * _ulp(v, want))


# ------------------------------------------------ vs the port and JAX jnp


def test_bitwise_against_the_row9_chain():
    """Every level of 33^3 (32^3 ... 2^3), nu = 1, 2, 3: the dense form
    equals the row-9 relax (split, half-sweeps, merge) bit for bit, and
    the halves form equals relax_halves on the same halves: the same
    per-point operations, pair sums added in either order."""
    prob = TPoisson(3)
    for l in range(5):
        _, tg, v, f = _level(33, seed=40 + l, l=l)
        vt, ft = torch.tensor(v), torch.tensor(f)
        row9 = R.make_split_relax(prob, tg)
        for ns in (1, 2, 3):
            chain = row9(vt.clone(), ft, ns)
            assert torch.equal(
                RS3.merged_resident_plain(vt, ft, ns, prob, tg), chain), (
                tg.padded_shape, ns)
            r, b = R.split_colors(vt)
            fr, fb = R.split_colors(ft)
            got = RS3.split_merged_plain(r, b, fr, fb, ns, prob, tg)
            R.relax_halves(r, b, fr, fb, ns, prob, tg)
            assert torch.equal(got[0], r) and torch.equal(got[1], b)


def test_float64_against_relax_rbgs():
    """In float64 the dense form is JAX's relax_rbgs with Poisson's
    relax_update on the 32^3 and 8^3 levels of 33^3, nu = 3, to 1e-12
    relative (the update's constants fold otherwise)."""
    for l in (0, 2):
        jg, tg, v, f = _level(33, seed=7 + l, l=l, dtype=np.float64)
        aux = JG.base_aux(jg, jnp.float64)
        jp = JPoisson(3)
        want = np.asarray(JS.relax_rbgs(
            lambda vv, ff: jp.relax_update(vv, ff, jg, aux), jnp.asarray(v),
            jnp.asarray(f), aux["m_red"], aux["m_black"], 3))
        got = RS3.merged_resident_plain(torch.tensor(v), torch.tensor(f), 3,
                                        TPoisson(3), tg)
        assert got.dtype == torch.float64
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12,
                                   atol=1e-12 * np.abs(want).max())


# --------------------------------------------------------------- plan

_JAX_TIER = {
    "make_merged_resident_relax": "merged_resident",
    "make_resident_relax": "resident3d",
    "make_split_timeskew_relax": "timeskew",
    "make_split_timeskew_relax_jb": "timeskew",
    "make_split_slab_relax": "half_sweep",
}


@pytest.mark.parametrize("n", [33, 129, 257])
def test_plan_pins_match_jax_plan_relax(n):
    """Each level of the n^3 hierarchy relaxed to 2^3 takes the tier JAX's
    plan_relax gives it: the merged kernel on 64^3, 32^3, 16^3, the
    resident kernel on 8^3, 4^3, 2^3, the wavefront on 256^3, the
    half-sweeps on 128^3 (JAX's slab kernel)."""
    jg = JG.build_geometries((n,) * 3, DOM, wrap=True)
    tg = TG.build_geometries((n,) * 3, DOM, wrap=True)
    k = CudaKernels(TPoisson(3), tg, torch.float32)
    want = [_JAX_TIER[JR.plan_relax(JPoisson(3), g, F32, interpret=True)
                      .__qualname__.split(".")[0]] for g in jg]
    assert k.tiers == want
    sizes = {t: [g.padded_shape[0] for g, u in zip(tg, k.tiers) if u == t]
             for t in set(k.tiers)}
    assert sizes["merged_resident"] == [s for s in (64, 32, 16) if s < n]
    assert sizes["resident3d"] == [8, 4, 2]


def test_gate_and_layout():
    """The kernel holds 64^3, 32^3 and 16^3 as x-slabs over the 16-CTA
    cluster (4, 2 and 1 planes a CTA), each CTA's v and f halves followed
    by the 2 colours x 2 sides of halo planes (a half's plane each) inside
    the 227 KB less the halo mbarriers, and 8^3 and below on one CTA
    without halo planes; a thread per (run of planes, z-pair): runs of up
    to 4 planes on the cluster, of one plane on one CTA, and on 2^3 a point
    a thread (the port's first form, faster there on the card);
    128^3 (whose v alone would fit 16 CTAs) and non-power-of-two extents
    not at all."""
    tg = TG.build_geometries((257,) * 3, DOM, wrap=True)
    lays = {g.padded_shape[0]: RS3.layout(g) for g in tg}
    assert lays[256] is None and lays[128] is None
    assert lays[64] == {"nctas": 16, "smem_bytes": 163840, "threads": 512,
                        "halo": (32768, 2048), "run": 4}
    assert lays[32] == {"nctas": 16, "smem_bytes": 24576, "threads": 256,
                        "halo": (4096, 512), "run": 4}
    assert lays[16] == {"nctas": 16, "smem_bytes": 4096, "threads": 64,
                        "halo": (512, 128), "run": 4}
    for s in (64, 32, 16):
        held = s**3 // 16
        off, plane = lays[s]["halo"]
        assert off == 2 * held and plane == s * s // 2 and plane % 4 == 0
        assert lays[s]["smem_bytes"] == 4 * (off + 4 * plane)
        assert lays[s]["smem_bytes"] <= RS3.MAX_SMEM_BYTES == 232448 - 16
    assert all(lays[s] == {"nctas": 1, "smem_bytes": 8 * s**3,
                           "threads": max(32, s**3 // 4), "halo": (0, 0),
                           "run": 1}
               for s in (8, 4))
    assert lays[2] == {"nctas": 1, "smem_bytes": 64, "threads": 32,
                       "halo": (0, 0), "run": 0}  # a point a thread
    assert [RS3.one_cta(g) for g in tg] == [False] * 5 + [True] * 3
    odd = TG.LevelGeometry(shape=(97,) * 3, spacing=(0.1,) * 3,
                           origin=(0.0,) * 3, domain=DOM, wrap=True)
    assert odd.padded_shape == (96,) * 3 and RS3.merged_gate(odd)
    assert not RS3.fits(odd)
    k = CudaKernels(TPoisson(3), [odd], torch.float32)
    assert k.tiers == ["half_sweep"]


def test_refusals():
    """Non-contiguous (the FAS injection's strided view, F1), another
    dtype, a wrong shape, a level outside a mode's gate, a level the
    kernel cannot hold, a 2D level and negative sweeps raise; nsweeps = 0
    leaves v as it is."""
    _, tg, v, f = _level(33, seed=5)
    _, g8, v8, f8 = _level(33, seed=6, l=2)
    g64 = TG.build_geometries((65,) * 3, DOM, wrap=True)[0]
    prob = TPoisson(3)
    vt, ft = torch.tensor(v), torch.tensor(f)
    big = torch.zeros((64, 64, 64))
    fine = torch.zeros((64, 64, 64))
    with pytest.raises(ValueError, match="contiguous"):
        RS3.merged_resident_relax(stencil.inject(fine, (32, 32, 32)), ft, 1,
                                  prob, tg)
    with pytest.raises(TypeError):
        RS3.merged_resident_relax(vt.double(), ft.double(), 1, prob, tg)
    with pytest.raises(ValueError, match="operands"):
        RS3.merged_resident_relax(vt[:16].contiguous(), ft, 1, prob, tg)
    with pytest.raises(ValueError, match="merged gate"):
        RS3.merged_resident_relax(torch.tensor(v8), torch.tensor(f8), 1,
                                  prob, g8)
    with pytest.raises(ValueError, match="one CTA"):
        RS3.resident3d_relax(big, big, 1, prob, g64)
    with pytest.raises(ValueError, match="one CTA"):
        RS3.resident3d_relax(vt, ft, 1, prob, tg)  # 32^3: a cluster's
    _, g16, v16, f16 = _level(33, seed=7, l=1)
    with pytest.raises(ValueError, match="one CTA"):  # 16^3: a cluster's
        RS3.resident3d_relax(torch.tensor(v16), torch.tensor(f16), 1, prob,
                             g16)
    with pytest.raises(ValueError, match="nsweeps"):
        RS3.merged_resident_relax(vt, ft, -1, prob, tg)
    g2 = TG.build_geometries((17, 17), DOM[:2], wrap=True)[0]
    with pytest.raises(ValueError):
        RS3.merged_resident_relax(vt, ft, 1, prob, g2)
    r, b = R.split_colors(vt)
    with pytest.raises(ValueError, match="operands"):
        RS3.split_merged_relax(r, b, vt, ft, 1, prob, tg)
    v0 = vt.clone()
    assert torch.equal(RS3.merged_resident_relax(v0, ft, 0, prob, tg), vt)


def test_refused_cluster_raises(monkeypatch):
    """Where the card runs no 16-CTA cluster of a split level's launch
    (cudaOccupancyMaxActiveClusters 0), the leg raises before any kernel
    is launched: no fallback to one CTA or to the plain version.  The
    card is asked once per launch shape, and a refusal is not
    remembered; a level on one CTA asks nothing."""
    asked = []

    def clusters(params, out):
        asked.append(params._obj.lev.nctas)
        out._obj.value = 0
        return 0

    lib = type("Lib", (), {"pdemg_resident3d_clusters":
                           staticmethod(clusters)})
    monkeypatch.setattr(RS3.build, "load",
                        lambda: type("L", (), {"lib": lib}))
    g64 = TG.build_geometries((65,) * 3, DOM, wrap=True)[0]
    v = torch.zeros(g64.padded_shape)
    for _ in range(2):
        with pytest.raises(RuntimeError, match="no cluster of 16 CTAs"):
            RS3._launch("merged_resident", v, None, v, None, 1,
                        TPoisson(3), g64, False)
    assert asked == [16, 16]
    assert not any(RS3.launches.values())
