"""Row 10 on Hopper: the error sweeps of the bf16 defect path
(`relax.error_leg`, one launch a leg with the four halves in shared
memory; `relax.error_timeskew`, the wavefront's error mode, TIMESKEW_T
sweeps a launch; `relax.error_chain`, a launch a half-sweep where neither
fits) -- their layouts, the per-level plan, the launch counts a step of
the bench's mixed rows, and the wrappers on CPU tensors (the one plain
version, `relax.error_sweeps_plain`) against the JAX package's
interpreted `make_split_resident_sweeps`.

The kernels themselves run only on the card: `chip_smoke.py` holds each
bitwise against `error_sweeps_plain` (--fmad=false, the same order).
Against JAX the tolerance is the one of tests/test_torch_defect.py,
2^-7 of max|e|: XLA's CPU backend contracts products into fused
multiply-adds, which moves an f32 value by an ulp and may flip a bf16
rounding."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pde_multigrid_tpu import grid as JG
from pde_multigrid_tpu.models import Poisson as JPoisson
from pde_multigrid_tpu.ops.pallas import relax as JR
from pde_multigrid_tpu_torch import grid as TG
from pde_multigrid_tpu_torch.models import Poisson as TPoisson
from pde_multigrid_tpu_torch.ops.cuda import defect as D
from pde_multigrid_tpu_torch.ops.cuda import relax as R
from pde_multigrid_tpu_torch.ops.cuda.dispatch import CudaKernels

DOM = ((0.0, 1.0),) * 3
FORMS = {"leg": R.error_leg, "wavefront": R.error_timeskew,
         "chain": R.error_chain}


@pytest.fixture(autouse=True)
def _no_launches():
    """CPU tensors never launch a kernel: every counter stays at zero."""
    for mod in (R, D):
        mod.reset_launches()
    yield
    for mod in (R, D):
        assert not any(mod.launches.values()), mod.launches


def _geom(shape, domain=DOM):
    return TG.build_geometries(shape, domain, 1, wrap=True)[0]


def _blocks(lay, X, Y2):
    """The blocks of a leg layout, CTA by CTA: (x0, planes, j0, rows), as
    csrc/relax.cu error_leg_kernel derives them (CTA c = bx * yblocks +
    by, the last block along each axis cut at the level's edge)."""
    out = []
    for c in range(lay["ctas"]):
        bx, by = divmod(c, lay["yblocks"])
        x0, j0 = bx * lay["planes"], by * lay["rows"]
        out.append((x0, min(lay["planes"], X - x0), j0,
                    min(lay["rows"], Y2 - j0)))
    return out


def _halves(g, seed):
    """bf16 residual halves of `g`, random everywhere (boundary planes
    included: every form must ignore r there)."""
    rng = np.random.default_rng(seed)
    shape = R._halves_shape(g.padded_shape)
    return [torch.tensor(rng.standard_normal(shape).astype(np.float32))
            .to(torch.bfloat16) for _ in range(2)]


# ------------------------------------------------------------ (a) layout


@pytest.mark.parametrize("shape", [(128, 64, 128), (64, 32, 64),
                                   (10, 13, 38), (64, 65, 100), (2, 1, 2),
                                   (98, 64, 128), (4, 4, 1024)])
def test_error_leg_layout_pins(shape):
    """The leg's launch on the H100's 132 SMs: at most one CTA an SM, each
    owning a block of at most 4 x planes by `rows` j rows (every z), the
    blocks covering every (x, j) once, within 227 KB of shared memory a
    CTA (its block of er and eb with a halo row either side of each
    plane's rows, and of rr and rb, 2 B a point), the threads a whole
    number of warps, one a z pair of a row."""
    X, Y2, Z = shape
    lay = R.error_leg_layout(X, Y2, Z)
    assert lay is not None
    assert lay["ctas"] <= R.ERROR_LEG_SMS == 132
    assert 1 <= lay["planes"] <= R.ERROR_LEG_MAX_PLANES == 4
    assert lay["yblocks"] == -(-Y2 // lay["rows"])
    assert lay["ctas"] == -(-X // lay["planes"]) * lay["yblocks"]
    assert lay["smem_bytes"] == 2 * lay["planes"] * Z * (
        2 * (lay["rows"] + 2) + 2 * lay["rows"])
    assert lay["smem_bytes"] <= R.ERROR_LEG_SMEM_BYTES == 232448
    zh = Z // 2
    assert lay["threads"] % 32 == 0 and lay["threads"] <= 1024
    assert lay["rows"] * zh <= lay["threads"] < lay["rows"] * zh + 32
    owned = np.zeros((X, Y2), dtype=int)
    for x0, npl, j0, nr in _blocks(lay, X, Y2):
        assert npl >= 1 and nr >= 1
        owned[x0:x0 + npl, j0:j0 + nr] += 1
    assert (owned == 1).all()


def test_error_leg_layout_128_and_refusals():
    """128^3: 4 x 32 blocks of 4 planes by 16 rows, 1024 threads, 68 KB
    a CTA; 98 planes take all 132 SMs in blocks of 3.  With fewer SMs the
    blocks take more planes until they pass 4 (100 SMs: 6).  Refused:
    256^3 and 512^3 (a block's row of 128 / 256 z pairs leaves 8 / 4 rows
    a CTA, 16 / 64 blocks along j, more than 4 planes a block), odd Z, a
    z row of more pairs than a CTA has threads, more than 4 planes a
    block, blocks of one row (Z = 2048)."""
    assert R.error_leg_layout(128, 64, 128) == {
        "ctas": 128, "planes": 4, "rows": 16, "yblocks": 4,
        "threads": 1024, "smem_bytes": 69632}
    assert R.error_leg_layout(64, 32, 64) == {
        "ctas": 64, "planes": 1, "rows": 32, "yblocks": 1,
        "threads": 1024, "smem_bytes": 16896}
    lay = R.error_leg_layout(98, 64, 128)
    assert (lay["ctas"], lay["planes"]) == (132, 3)
    assert _blocks(lay, 98, 64)[-1] == (96, 2, 48, 16)
    assert R.error_leg_layout(128, 64, 128, sms=100) is None
    for shape in ((256, 128, 256), (512, 256, 512), (8, 4, 7),
                  (2, 1, 2050), (0, 1, 2), (600, 2, 4), (2, 4, 2048)):
        assert R.error_leg_layout(*shape) is None, shape


# -------------------------------------------------------------- (b) plan


@pytest.mark.parametrize("shape,form", [
    ((3, 3, 3), "leg"), ((17, 17, 17), "leg"), ((65, 65, 65), "leg"),
    ((129, 129, 129), "leg"), ((11, 27, 39), "leg"),
    ((65, 131, 101), "leg"), ((257, 257, 257), "wavefront"),
    ((513, 513, 513), "wavefront"), ((257, 129, 257), "wavefront"),
    ((1025, 1025, 1025), "chain"), ((257, 257, 259), "chain"),
])
def test_error_form_pins(shape, form):
    """Which kernel relaxes a defect level: the leg wherever its halves fit
    (128^3 and below, odd-tiled shapes), the wavefront's error mode above
    (256^3, 512^3: its 16-CTA tile at T = 4, k = 4), the chain where
    neither fits (1024^3: a row of the half-plane is too wide for the
    wavefront's tile; Z % 4 != 0 past the leg's shared memory)."""
    g = _geom(shape)
    assert R.error_form(g) == form
    assert D.plan_defect_relax(TPoisson(3), g, torch.float32).form == form


def test_error_form_refusals():
    """No form off even 3D wrap levels, and no defect plan there."""
    g2 = TG.build_geometries((17, 17), ((0.0, 1.0),) * 2, wrap=True)[0]
    gp = TG.build_geometries((17,) * 3, DOM, wrap=False)[0]
    assert R.error_form(g2) is None and R.error_form(gp) is None
    assert D.plan_defect_relax(TPoisson(3), gp, torch.float32) is None


def _kernels(n):
    geoms = TG.build_geometries((n,) * 3, DOM, {129: 2, 257: 3, 513: 4}[n],
                                wrap=True)
    return geoms, CudaKernels(TPoisson(3), geoms, torch.float32,
                              range(len(geoms) - 1), mixed=True)


@pytest.mark.parametrize("n,forms,per_step", [
    (129, ["leg"], 4),
    (257, ["wavefront", "leg"], 8 + 100),
    (513, ["wavefront", "wavefront", "leg"], 12 + 300),
])
def test_mixed_rows_plan_and_launches_a_step(n, forms, per_step):
    """The bench's mixed rows, FMG(2, 100, 100) exact coarsest: 128^3
    takes the leg (one launch a leg), 256^3 and 512^3 the wavefront's
    error mode (ceil(nu / 4) launches a leg), the exact level no plan.
    Level l relaxes 2 nu0 (l + 1) legs a step, so row 10 launches 4, 108
    and 312 times a step at nu = 100 (800, 2400 and 4800 half-sweeps
    before)."""
    geoms, k = _kernels(n)
    plans = k._defect[:-1]
    assert [d.form for d in plans] == forms and k._defect[-1] is None
    for d in plans:
        for nu in (*range(1, 10), 100, 3000):
            want = 1 if d.form == "leg" else -(-nu // R.TIMESKEW_T)
            assert d.launches(nu) == want
            assert R.error_launches(d.form, nu) == want
    nu0, nu = 2, 100
    total = sum(2 * nu0 * (l + 1) * d.launches(nu)
                for l, d in enumerate(plans))
    assert total == per_step
    assert [len(R.leg_launches(nu)), R.TIMESKEW_T] == [25, 4]


# --------------------------------------------------- (c) wrappers on CPU


@pytest.mark.parametrize("nsweeps", [1, 2, 5, 9])
@pytest.mark.parametrize("shape", [(17, 17, 17), (33, 33, 33),
                                   (11, 27, 39)])
@pytest.mark.parametrize("form", sorted(FORMS))
def test_wrappers_on_cpu_are_the_plain_version(form, shape, nsweeps):
    """Each form's wrapper on CPU tensors is `error_sweeps_plain`, bitwise
    (and launches nothing), as is the per-level dispatcher."""
    g = _geom(shape)
    rr, rb = _halves(g, seed=sum(shape) + nsweeps)
    want = R.error_sweeps_plain(rr, rb, nsweeps, TPoisson(3), g)
    for fn in (FORMS[form], R.error_sweeps):
        got = fn(rr, rb, nsweeps, TPoisson(3), g)
        assert all(a.dtype == torch.bfloat16 for a in got)
        assert all(torch.equal(a.view(torch.int16), b.view(torch.int16))
                   for a, b in zip(got, want))


def _sweeps_from(eb, rr, rb, nsweeps, prob, g):
    """nsweeps red-then-black error half-sweeps from the black half eb
    (None: e = 0), the red half never read: one launch of the
    wavefront's error mode."""
    first = eb is None
    er = torch.zeros_like(rr)
    eb = torch.zeros_like(rb) if first else eb.clone()
    for s in range(nsweeps):
        R.error_half_sweep_plain(er, eb, rr, R.RED, prob, g,
                                 v_zero=first and s == 0)
        R.error_half_sweep_plain(eb, er, rb, R.BLACK, prob, g)
    return er, eb


@pytest.mark.parametrize("nsweeps", [1, 3, 4, 5, 8, 9])
def test_wavefront_chain_carries_the_black_half_only(nsweeps):
    """The wavefront's leg is leg_launches(nu) launches, each from the
    previous launch's black half alone (its red output is dropped but on
    the last): the chain is bitwise one run of nu sweeps, because a red
    half-sweep reads only black and every write is where(ok, upd, 0)."""
    g = _geom((17, 33, 17))
    prob = TPoisson(3)
    rr, rb = _halves(g, seed=40 + nsweeps)
    eb = None
    for t in R.leg_launches(nsweeps):
        er, eb = _sweeps_from(eb, rr, rb, t, prob, g)
    want = R.error_sweeps_plain(rr, rb, nsweeps, prob, g)
    assert torch.equal(er, want[0]) and torch.equal(eb, want[1])
    assert sum(R.leg_launches(nsweeps)) == nsweeps


def test_wrapper_refusals():
    """float32 halves (the kernels take bf16), halves that do not match
    the level, a level that is not 3D wrap; no sweep gives zeros."""
    g = _geom((17, 17, 17))
    rr, rb = _halves(g, seed=3)
    gp = TG.build_geometries((17,) * 3, DOM, wrap=False)[0]
    for fn in (*FORMS.values(), R.error_sweeps):
        with pytest.raises(TypeError, match="bfloat16"):
            fn(rr.float(), rb.float(), 2, TPoisson(3), g)
        with pytest.raises(ValueError):
            fn(rr[:-2], rb[:-2], 2, TPoisson(3), g)
        with pytest.raises(ValueError):
            fn(rr, rb, 2, TPoisson(3), gp)
        er, eb = fn(rr, rb, 0, TPoisson(3), g)
        assert not er.any() and not eb.any()


# ------------------------------------------------------------- (d) JAX


@pytest.mark.parametrize("nsweeps", [1, 2, 5, 9])
def test_forms_match_jax_resident_sweeps(nsweeps):
    """Each form on CPU tensors against the interpreted
    make_split_resident_sweeps (bf16 storage, f32 compute, from e = 0) at
    33^3, within 2^-7 of max|e|."""
    jg = JG.build_geometries((33,) * 3, DOM, wrap=True)[0]
    g = _geom((33, 33, 33))
    rr, rb = _halves(g, seed=60 + nsweeps)
    fn = JR.make_split_resident_sweeps(
        JPoisson(3), jg, jnp.bfloat16, 8, interpret=True,
        compute_dtype=jnp.float32)
    want = fn(None, None, *(jnp.asarray(a.float().numpy()).astype(
        jnp.bfloat16) for a in (rr, rb)), nsweeps, v_zero=True)
    want = [np.asarray(w.astype(jnp.float32)) for w in want]
    scale = max(np.abs(w).max() for w in want)
    for form in FORMS.values():
        got = form(rr, rb, nsweeps, TPoisson(3), g)
        for a, w in zip(got, want):
            assert np.max(np.abs(a.float().numpy() - w)) <= 2.0 ** -7 * scale
