"""Halo-exchange relaxation on sharded levels (PyTorch port of
`pde_multigrid_tpu.parallel.halo`).

Each rank owns a contiguous slab of x_loc x-planes of a level.  A relax
leg of nsweeps red-black sweeps runs as chunks of T sweeps; before each
chunk the rank takes 2T-plane halos from its ring neighbours
(`Mesh.exchange`) and sweeps its extended slab.  Edge corruption advances
two planes per red+black sweep, so after T sweeps the owned planes are
exact (the trapezoid argument of the JAX package's slab kernels).  The
ring's wraparound halos at the domain ends carry the wrap neighbours,
which the global interior masks treat as the stored zero plane does.
The RHS halos are exchanged once per leg (f is constant).  Schedule: JAX's
serial exchange -> chunk (`local_relax_timeskew`, `local_relax_serial`);
JAX's default for the masked-block engine, the overlap of the exchange
with interior sweeps, gives the same values and is ROADMAP.md queue 2
item 41.

Three engines, chosen per level by `plan_engine`, a function of the
shapes that is the same on either device:

  * "timeskew" (3D wrap levels with `split_update`, no keep mask, x_loc
    and Y even, a half-plane Y/2 * Z of at least
    `relax.TIMESKEW_MIN_PLANE`): the time-skewed wavefront per chunk on
    the color-split halves (`relax.timeskew_shard`, csrc/timeskew.cu),
    only the black halo exchanged;
  * "split2d" (padded 2D levels of a problem with `split_update2d` and
    the one-sided stencil `split2d_x_offsets == (+1,)`, no keep mask:
    Lyapunov): per leg v and f split into halves (`relax2d.to_halves`),
    the f halves' 2T-row high halo taken once; per chunk of t sweeps the
    r and b halos (2t rows, from the right neighbour only) and one launch
    of the per-shard color slab (`relax2d.color_slab2d_shard`,
    csrc/color_slab2d_shard.cu), ping-ponging between two ext buffers;
    one merge at the end (JAX's `local_relax_split2d`, halo.py:326-363).
    On a one-rank ring (every level of `--mesh 1`, every replicated level
    on more ranks) no halo is taken: the shard's last row is the level's
    boundary or padding, so no interior point reads past it and the chunk
    reads those rows as 0 (`one_rank=True`); and where the level fits on
    chip (`relax2d.leg_layout`: 257^2 and below) a whole leg is one launch
    (`relax2d.color_slab2d_leg`) instead of ceil(nsweeps / T) chunks.  The
    owned rows are bitwise the chunked schedule's (the trapezoid argument),
    so every number of ranks still gives the same solution; JAX chunks
    every leg in T sweeps (ROADMAP.md, "Observed").
    A shard whose first global row is odd holds the global colours
    swapped in the port's local split, so its halves are swapped at the
    split and the merge: every exchanged halo is in the global colour
    convention;
  * "masked-block" (every other level): t dense masked sweeps of the
    problem's `kernel_update` on the halo-extended block
    (`masked_block.masked_block`, csrc/masked_block.cu: one launch a chunk
    on the blocks its chunk form holds with enough planes a CTA, the
    128^3 level's on 1, 2 and 4 ranks; else one launch a colour
    half-sweep), masks from the global row offset, built once per level
    and rank.

JAX's TPU gates are left out: the lane alignment (Z % 128, Y/2 % 8, and
x_loc % 8 with the 8-row halo rounding of the 2D engine), the VMEM budget
that sends a block to jnp sweeps (halo.py:233-235), and the 2D engine's
hardware floor SPLIT2D_MIN_Y2 = 256 (relax.py:3751, a TPU crossover; its
interpret mode engages at any size); the masked-block and color-slab
kernels serve any block (ROADMAP.md queue 3, "Observed").
What a shard computes from its halos is kept apart from how they arrive:
`mesh` is anything with `rank`, `n` and `exchange(arr, h)`, so the tests
run every shard of a ring in one process.
"""

from __future__ import annotations

import torch

from pde_multigrid_tpu_torch.grid import LevelGeometry
from pde_multigrid_tpu_torch.ops import split2d
from pde_multigrid_tpu_torch.ops.cuda import masked_block as MB
from pde_multigrid_tpu_torch.ops.cuda import relax as R
from pde_multigrid_tpu_torch.ops.cuda import relax2d as R2


def coords_and_masks(problem, geom: LevelGeometry, shape, row0: int, dtype,
                     device="cpu"):
    """(pre, m_red, m_black) for a local array of `shape` whose axis-0 rows
    start at global row `row0` (JAX's `relax._coords_and_masks`,
    relax.py:92-126): the problem's per-point coefficients from the
    clipped coordinates, and the red/black interior masks (times the
    problem's keep mask, where it has one) in `dtype`."""
    nd = len(shape)
    gidx = []
    for d in range(nd):
        view = [1] * nd
        view[d] = shape[d]
        gidx.append(torch.arange(shape[d], device=device).reshape(view))
    gidx[0] = gidx[0] + row0
    coords = []
    for d in range(nd):
        lo, hi = geom.domain[d]
        x = (torch.tensor(geom.origin[d], dtype=dtype, device=device)
             + gidx[d].to(dtype)
             * torch.tensor(geom.spacing[d], dtype=dtype, device=device))
        coords.append(torch.clamp(x, min(lo, hi), max(lo, hi)))
    interior = None
    for d in range(nd):
        ok = (gidx[d] >= 1) & (gidx[d] <= geom.shape[d] - 2)
        interior = ok if interior is None else interior & ok
    par = sum(gidx) % 2
    m_red = ((par == 0) & interior).to(dtype)
    m_black = ((par == 1) & interior).to(dtype)
    keep = getattr(problem, "kernel_keep_mask", None)
    if keep is not None:
        k = keep(tuple(coords), geom, dtype)
        m_red = m_red * k
        m_black = m_black * k
    pre = problem.kernel_precompute(tuple(coords), geom, dtype)
    return pre, m_red.contiguous(), m_black.contiguous()


def plan_engine(problem, geom: LevelGeometry, n: int) -> str:
    """The engine of a level split over `n` ranks: in 3D "timeskew" where
    JAX's gate holds (halo.py:103-130, without its TPU lane alignment); in
    2D "split2d" where JAX's holds (halo.py:158-210, without its TPU
    alignment and size floor); "masked-block" elsewhere."""
    if geom.ndim == 2:
        s2 = (not geom.wrap and hasattr(problem, "split_update2d")
              and hasattr(problem, "kernel_precompute")
              and not hasattr(problem, "kernel_keep_mask")
              and tuple(getattr(problem, "split2d_x_offsets", ())) == (1,))
        return "split2d" if s2 else "masked-block"
    X, Y, Z = geom.padded_shape
    ts = (geom.wrap and hasattr(problem, "split_update")
          and not hasattr(problem, "kernel_keep_mask")
          and (X // n) % 2 == 0 and Y % 2 == 0 and Z % 2 == 0
          and (Y // 2) * Z >= R.TIMESKEW_MIN_PLANE)
    return "timeskew" if ts else "masked-block"


def make_sharded_relax(problem, geom: LevelGeometry, mesh,
                       sweeps_per_exchange: int = 1):
    """relax(v_loc, f_loc, nsweeps) -> v_loc on this rank's x_loc planes of
    a sharded float32 level, in place: T = `sweeps_per_exchange`
    sweeps per halo exchange and a remainder chunk of nsweeps % T, through
    the kernels' wrappers (the CUDA kernels on CUDA tensors, their plain
    versions on CPU tensors).  The engine is recorded as
    `relax.engine`, T as `relax.T`, and whether a leg is one launch (the
    split2d engine on a one-rank ring, on a level that fits on chip) as
    `relax.leg`."""
    X = geom.padded_shape[0]
    n = mesh.n
    if X % n:
        raise ValueError(f"axis-0 extent {X} not divisible by mesh size {n}")
    x_loc = X // n
    T = sweeps_per_exchange
    halo = 2 * T
    if T < 1 or x_loc < halo:
        raise ValueError(
            f"local extent {x_loc} smaller than halo {halo}; agglomerate")
    engine = plan_engine(problem, geom, n)
    i0 = mesh.rank * x_loc  # global plane of owned plane 0
    leg = False  # a whole leg a launch (split2d on a one-rank ring)

    def chunks(nsweeps):
        n_full, rem = divmod(nsweeps, T)
        return [T] * n_full + [rem] * (rem > 0)

    def ext(a, h):
        lo, hi = mesh.exchange(a, h)
        return torch.cat([lo, a, hi], dim=0)

    if engine == "timeskew":

        def relax(v_loc, f_loc, nsweeps: int):
            _, b = R.split(v_loc, red=False)
            fr, fb = R.split(f_loc)
            fr_ext, fb_ext = ext(fr, halo), ext(fb, halo)
            r = torch.empty_like(b)
            ts = chunks(nsweeps)
            for k, t in enumerate(ts):
                # a remainder chunk takes a narrower window of the f halos
                off, xe = halo - 2 * t, x_loc + 4 * t
                R.timeskew_shard(ext(b, 2 * t), fr_ext[off:off + xe],
                                 fb_ext[off:off + xe], i0 - 2 * t, t,
                                 problem, geom, x_loc, b,
                                 r if k == len(ts) - 1 else None)
            return R.merge(r, b, out=v_loc)
    elif engine == "split2d":
        odd = i0 % 2 == 1
        # a one-rank ring: no halo (rows past x_loc read as 0), and a whole
        # leg a launch where the level fits on chip
        one = n == 1
        leg = one and R2.leg_layout(geom) is not None
        bufs = []  # per level and rank: (r, b) twice and (fr, fb)

        def glob(r, b):
            """The port's local split of (r, b) rows in the global colour
            convention, or back: swapped on a shard that starts odd."""
            return (b, r) if odd else (r, b)

        def take_halo(buf, h):
            """Rows x_loc .. x_loc + h of an ext buffer: the right
            neighbour's first h owned rows."""
            _, right = mesh.exchange(buf[:x_loc], h)
            buf[x_loc:x_loc + h].copy_(right)

        def relax(v_loc, f_loc, nsweeps: int):
            if not bufs:
                shape = (x_loc + (0 if one else halo),
                         split2d.half_width(geom))
                bufs.extend(torch.empty(shape, dtype=v_loc.dtype,
                                        device=v_loc.device)
                            for _ in range(6))
            cur, nxt, fs = bufs[0:2], bufs[2:4], bufs[4:6]
            R2.to_halves(f_loc, out=glob(*(a[:x_loc] for a in fs)))
            if not one:
                for a in fs:
                    take_halo(a, halo)
            R2.to_halves(v_loc, out=glob(*(a[:x_loc] for a in cur)))
            if leg:
                R2.color_slab2d_leg(*cur, *fs, nsweeps, problem, geom, nxt)
                cur, nxt = nxt, cur
            for t in () if leg else chunks(nsweeps):
                xe = x_loc if one else x_loc + 2 * t
                if not one:
                    for a in cur:
                        take_halo(a, 2 * t)
                R2.color_slab2d_shard(
                    *(a[:xe] for a in (*cur, *fs)), i0, t, problem, geom,
                    x_loc, tuple(a[:x_loc] for a in nxt), one_rank=one)
                cur, nxt = nxt, cur
            return R2.from_halves(*glob(*(a[:x_loc] for a in cur)),
                                  out=v_loc)
    else:
        ext_shape = (x_loc + 2 * halo,) + tuple(geom.padded_shape[1:])
        masks = {}

        def relax(v_loc, f_loc, nsweeps: int):
            if not masks:  # once per level and rank
                masks["m"] = coords_and_masks(problem, geom, ext_shape,
                                              i0 - halo, v_loc.dtype,
                                              v_loc.device)
            pre, m_red, m_black = masks["m"]
            f_ext = ext(f_loc, halo)
            for t in chunks(nsweeps):
                v_ext = ext(v_loc, halo)
                MB.masked_block(v_ext, f_ext, pre, m_red, m_black, t,
                                problem, geom)
                v_loc.copy_(v_ext[halo:halo + x_loc])
            return v_loc

    relax.engine = engine
    relax.T = T
    relax.leg = leg
    return relax
