"""Port parity of the per-shard relax chunks of the sharded solve: the
time-skew chunk (`ops/cuda/relax.py` `timeskew_shard_plain`, which the
wrapper `timeskew_shard` runs for CPU tensors) against the JAX package's
`make_split_timeskew_relax_shard`, and the masked block
(`ops/cuda/masked_block.py` `masked_block_plain`, run by `masked_block`)
against `make_masked_block_relax`, both in interpret mode, with the
inputs `parallel/halo.py` gives them; the masks of `parallel/halo.py`
`coords_and_masks` against JAX's `_coords_and_masks`; the wrappers on CPU
tensors and their refusals.

Tolerances.  The time-skew chunk is bitwise (random slabs, halo planes
included).  The masked block: within 2 ulp of the largest value the
sweeps read or write, because XLA's CPU backend, which runs the
interpreted kernel, contracts a product into the following sum (one fused
multiply-add); on the card, with --fmad=false, the kernel equals the plain
version bit for bit (`chip_smoke.py`)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pde_multigrid_tpu import grid as JG
from pde_multigrid_tpu.models import HJBMinTime as JHJB
from pde_multigrid_tpu.models import Poisson as JPoisson
from pde_multigrid_tpu.ops.pallas import relax as JR
from pde_multigrid_tpu_torch import grid as TG
from pde_multigrid_tpu_torch.models import HJBMinTime as THJB
from pde_multigrid_tpu_torch.models import Poisson as TPoisson
from pde_multigrid_tpu_torch.ops.cuda import masked_block as MB
from pde_multigrid_tpu_torch.ops.cuda import relax as R
from pde_multigrid_tpu_torch.parallel import halo

F32 = jnp.dtype("float32")
DOM = ((0.0, 1.0),) * 3


def _geoms(n):
    return (JG.build_geometries((n,) * 3, DOM, wrap=True)[0],
            TG.build_geometries((n,) * 3, DOM, wrap=True)[0])


@pytest.fixture(autouse=True)
def _no_launches():
    """CPU tensors never launch a kernel: every counter stays at zero."""
    R.reset_launches()
    MB.reset_launches()
    yield
    assert not any(R.launches.values()) and not any(MB.launches.values())


@pytest.mark.parametrize("n,ranks", [(17, 2), (17, 4), (33, 2), (33, 4)])
@pytest.mark.parametrize("t", [1, 2])
def test_timeskew_shard_plain_matches_pallas(n, ranks, t):
    """timeskew_shard_plain against the interpreted
    make_split_timeskew_relax_shard on shards 0, 1 and n - 1 of a level
    split over `ranks`: b_ext, fr_w, fb_w random on all XE = x_loc + 4t
    planes, g0 = i x_loc - 2t as halo.py:309 passes it; the whole slab
    compares, bitwise."""
    jg, tg = _geoms(n)
    X, Y, Z = jg.padded_shape
    x_loc = X // ranks
    XE = x_loc + 4 * t
    chunk = JR.make_split_timeskew_relax_shard(JPoisson(3), jg, F32, t,
                                               x_loc, interpret=True)
    for i in sorted({0, 1, ranks - 1}):
        rng = np.random.default_rng(100 * n + 10 * ranks + 3 * t + i)
        b, fr, fb = (rng.standard_normal((XE, Y // 2, Z)).astype(np.float32)
                     for _ in range(3))
        g0 = i * x_loc - 2 * t
        want = [np.asarray(a) for a in chunk(jnp.asarray(b), jnp.asarray(fr),
                                             jnp.asarray(fb), g0)]
        got = R.timeskew_shard_plain(torch.tensor(b), torch.tensor(fr),
                                     torch.tensor(fb), g0, t, TPoisson(3),
                                     tg, x_loc)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("n", [17, 33])
@pytest.mark.parametrize("t", [1, 2, 4])
def test_masked_block_plain_matches_pallas(n, t):
    """masked_block_plain against the interpreted make_masked_block_relax
    on the extended blocks of the first and the last shard of two (halo
    2T = 8), with JAX's masks; within 2 ulp."""
    jg, tg = _geoms(n)
    X, Y, Z = jg.padded_shape
    x_loc, h = X // 2, 8
    shape = (x_loc + 2 * h, Y, Z)
    block = JR.make_masked_block_relax(JPoisson(3), jg, F32, shape, (),
                                       interpret=True)
    rng = np.random.default_rng(n + t)
    v, f = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    for row0 in (-h, x_loc - h):
        pre, mr, mb = JR._coords_and_masks(JPoisson(3), jg, shape, row0, F32)
        want = np.asarray(block(jnp.asarray(v), jnp.asarray(f), pre, mr, mb,
                                t))
        got = MB.masked_block_plain(
            torch.tensor(v), torch.tensor(f), {}, torch.tensor(np.asarray(mr)),
            torch.tensor(np.asarray(mb)), t, TPoisson(3), tg).numpy()
        ulp = np.spacing(np.float32(max(np.abs(v).max(), np.abs(want).max())))
        np.testing.assert_allclose(got, want, rtol=0, atol=2 * ulp)


@pytest.mark.parametrize("case", ["poisson3d", "poisson2d", "hjb"])
def test_coords_and_masks_match_jax(case):
    """coords_and_masks equals JAX's _coords_and_masks: masks bitwise and
    the problem's coefficients, for blocks reaching past both ends of the
    level (rows below 0 and beyond the last), in wrap and padded storage,
    with HJB's keep mask."""
    if case == "poisson3d":
        jp, tp, shp, wrap, rows = JPoisson(3), TPoisson(3), (17,) * 3, True, (
            -4, 0, 12)
    elif case == "poisson2d":
        jp, tp, shp, wrap, rows = JPoisson(2), TPoisson(2), (33, 33), False, (
            -2, 5, 30)
    else:
        jp, tp, shp, wrap, rows = JHJB(), THJB(), (33, 33), False, (-4, 9, 29)
    jg = JG.build_geometries(shp, jp.domain, wrap=wrap)[0]
    tg = TG.build_geometries(shp, tp.domain, wrap=wrap)[0]
    shape = (8,) + tuple(jg.padded_shape[1:])
    for row0 in rows:
        jpre, jmr, jmb = JR._coords_and_masks(jp, jg, shape, row0, F32)
        tpre, tmr, tmb = halo.coords_and_masks(tp, tg, shape, row0,
                                               torch.float32)
        np.testing.assert_array_equal(tmr.numpy(), np.asarray(jmr))
        np.testing.assert_array_equal(tmb.numpy(), np.asarray(jmb))
        assert sorted(tpre) == sorted(jpre)
        for k in jpre:
            np.testing.assert_allclose(
                np.broadcast_to(tpre[k].numpy(), np.shape(jpre[k])),
                np.asarray(jpre[k]), rtol=1e-6, atol=1e-6)


def test_timeskew_shard_wrapper_writes_the_owned_window():
    """On CPU tensors the wrapper writes the plain version's owned window
    [2t, 2t + x_loc) into b_out (and r_out when given), never into its
    inputs; float64, odd offsets and wrong shapes raise."""
    _, tg = _geoms(17)
    X, Y, Z = tg.padded_shape
    x_loc, t = 8, 2
    rng = np.random.default_rng(7)
    b, fr, fb = (torch.tensor(rng.standard_normal(
        (x_loc + 4 * t, Y // 2, Z)).astype(np.float32)) for _ in range(3))
    ins = [a.clone() for a in (b, fr, fb)]
    bo, ro = torch.zeros(x_loc, Y // 2, Z), torch.zeros(x_loc, Y // 2, Z)
    R.timeskew_shard(b, fr, fb, 4, t, TPoisson(3), tg, x_loc, bo, ro)
    pr, pb = R.timeskew_shard_plain(b, fr, fb, 4, t, TPoisson(3), tg, x_loc)
    assert torch.equal(bo, pb[2 * t:2 * t + x_loc])
    assert torch.equal(ro, pr[2 * t:2 * t + x_loc])
    assert all(torch.equal(a, c) for a, c in zip(ins, (b, fr, fb)))
    bo.zero_()
    R.timeskew_shard(b, fr, fb, 4, t, TPoisson(3), tg, x_loc, bo)
    assert torch.equal(bo, pb[2 * t:2 * t + x_loc])
    with pytest.raises(ValueError, match="even"):
        R.timeskew_shard(b, fr, fb, 3, t, TPoisson(3), tg, x_loc, bo)
    with pytest.raises(ValueError):
        R.timeskew_shard(b[1:], fr[1:], fb[1:], 4, t, TPoisson(3), tg,
                         x_loc, bo)
    with pytest.raises(TypeError):
        R.timeskew_shard(*(a.double() for a in (b, fr, fb)), 4, t,
                         TPoisson(3), tg, x_loc, bo.double())


def test_masked_block_wrapper_writes_back():
    """On CPU tensors the wrapper leaves the plain version's t sweeps in
    v_ext; float64 and mismatched shapes raise."""
    _, tg = _geoms(17)
    X, Y, Z = tg.padded_shape
    shape = (X // 2 + 8, Y, Z)
    pre, mr, mb = halo.coords_and_masks(TPoisson(3), tg, shape, -4,
                                        torch.float32)
    rng = np.random.default_rng(8)
    v, f = (torch.tensor(rng.standard_normal(shape).astype(np.float32))
            for _ in range(2))
    want = MB.masked_block_plain(v, f, pre, mr, mb, 3, TPoisson(3), tg)
    got = v.clone()
    assert MB.masked_block(got, f, pre, mr, mb, 3, TPoisson(3), tg) is got
    assert torch.equal(got, want)
    with pytest.raises(TypeError):
        MB.masked_block(v.double(), f.double(), pre, mr.double(),
                        mb.double(), 1, TPoisson(3), tg)
    with pytest.raises(ValueError, match="shape"):
        MB.masked_block(v[1:], f, pre, mr, mb, 1, TPoisson(3), tg)


# ------------------------------------------------ the masked block's form


class _Ranks:
    """A mesh of `n` ranks seen from rank 0, for plans (no collective)."""

    def __init__(self, n):
        self.n, self.rank, self.device = n, 0, torch.device("cpu")


def _masked_blocks(size, n, scheme):
    """The extended blocks (x_loc + 4T, Y, Z) of the masked-block levels of
    the size^3 row's hierarchy (to 64^3, solved exactly, in the correction
    scheme; relaxed to 2^3 in FAS) sharded over n ranks, as the sharded
    tier plans them."""
    from pde_multigrid_tpu_torch.parallel.sharded import ShardedKernels

    geoms = TG.build_geometries((size,) * 3, DOM, wrap=True)
    relaxed = range(len(geoms))
    if scheme == "cs":
        geoms = [g for g in geoms if g.padded_shape[0] >= 64]
        relaxed = range(len(geoms) - 1)
    k = ShardedKernels(TPoisson(3), geoms, _Ranks(n), torch.float32,
                       relaxed_levels=relaxed, scheme=scheme)
    return [(g.padded_shape[0] // n + 4 * fn.T,) + g.padded_shape[1:]
            for g, fn, e in zip(geoms, k._relax, k.plan)
            if e == "masked-block"]


@pytest.mark.parametrize("size,scheme,blocks", [
    (257, "cs", {1: [(144, 128, 128)], 2: [(80, 128, 128)],
                 4: [(48, 128, 128)]}),
    (65, "fas", {1: [(80, 64, 64), (48, 32, 32), (32, 16, 16),
                     (24, 8, 8), (12, 4, 4), (6, 2, 2)],
                 2: [(48, 64, 64), (32, 32, 32), (24, 16, 16),
                     (12, 8, 8)],
                 4: [(32, 64, 64), (24, 32, 32), (12, 16, 16)]}),
])
def test_masked_block_form_on_the_rows_blocks(size, scheme, blocks):
    """Every masked-block level of the sharded 257^3 row (exact coarsest)
    and of the sharded FAS 65^3 row (relaxed to 2^3), over 1, 2 and 4
    ranks: the chunk form (one launch a chunk of t = 1 ... 4 sweeps) where
    its layout gives a CTA at least CHUNK_MIN_PLANES planes, the 128^3
    level's blocks on 1, 2 and 4 ranks (9, 5 and 3 planes a CTA, 128 CTAs
    of 512 threads); the one-colour form (2t launches) on the FAS row's
    blocks, 1 or 2 planes a CTA (where the chunk's layout exists it
    covers the block once in whole blocks of planes x rows, every z, one
    CTA an SM of the 132, within the kernel's threads, shared memory and
    planes)."""
    for n, want in blocks.items():
        got = _masked_blocks(size, n, scheme)
        assert got == want, (n, got)
        for shape in got:
            XB, Y, Z = shape
            chunk = size == 257
            assert MB.form(shape) == ("chunk" if chunk else "half-sweeps")
            assert [MB.chunk_launches(shape, t) for t in (0, 1, 2, 3, 4)] == (
                [0, 1, 1, 1, 1] if chunk else [0, 2, 4, 6, 8])
            lay = MB.chunk_layout(*shape)
            if lay is None:
                assert Z % 4  # the (6, 2, 2) block: z quads do not fit
                continue
            P, J = lay["planes"], lay["rows"]
            assert (P >= MB.CHUNK_MIN_PLANES) == chunk
            assert (lay["xblocks"] - 1) * P < XB <= lay["xblocks"] * P
            assert (lay["yblocks"] - 1) * J < Y <= lay["yblocks"] * J
            assert lay["ctas"] == lay["xblocks"] * lay["yblocks"] <= 132
            assert lay["threads"] == -(-J * Z // 4 // 32) * 32 <= 512
            assert P <= MB.CHUNK_MAX_PLANES
            assert lay["yblocks"] == 1 or P <= J
            assert lay["smem_bytes"] == 4 * P * Z * (2 * J + 2) <= 232448
            if chunk:
                assert (lay["ctas"], lay["threads"]) == (128, 512)
                assert P == {1: 9, 2: 5, 4: 3}[n]


def test_masked_block_form_elsewhere():
    """Blocks the chunk's layout cannot hold keep the one-colour launches,
    2t a chunk: more than CHUNK_MAX_PLANES planes a CTA (the 256^3
    level's one-rank block), Z not a multiple of 4, fewer SMs than y
    blocks; a chunk of more than CHUNK_MAX_SWEEPS sweeps is split."""
    for shape, sms in (((272, 256, 256), 132), ((17, 28, 38), 132),
                       ((48, 64, 2048), 1)):
        assert MB.chunk_layout(*shape, sms) is None
        assert MB.form(shape, sms) == "half-sweeps"
        assert [MB.chunk_launches(shape, t, sms) for t in (1, 2, 3, 4)] == [
            2, 4, 6, 8]
    assert MB.chunk_layout(16, 4, 8, 1) == {
        "ctas": 1, "planes": 16, "rows": 4, "xblocks": 1, "yblocks": 1,
        "threads": 32, "smem_bytes": 4 * 16 * 8 * 10}
    assert MB.form((16, 4, 8), 1) == "chunk"
    assert MB.chunk_launches((144, 128, 128), 300) == 3
