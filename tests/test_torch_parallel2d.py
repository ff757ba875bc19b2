"""The sharded 2D Lyapunov solve of the port (`parallel/` with the split2d
engine) against the port's own unsharded ops and against the JAX
package's sharded solve, on the CPU.

  * `Mesh.window`, the row-window fetch the padded transfers stand on;
  * the residual, restriction and prolongation of padded levels, whose
    shards do not nest, over every shard of a ring, bitwise the unsharded
    plain ops on the whole padded arrays;
  * the split2d engine composed over every shard of a ring (shards with an
    odd first row among them), bitwise the whole-level half-sweeps;
  * the plan the card runs at 4097^2 over 1-8 ranks: engine and T per
    level;
  * whole FMG solves over 1, 2, 4 and 8 shards, bitwise the same on the
    logical arrays (relaxed and exact coarsest), and within JAX's
    sharded-vs-single tolerance of the unsharded plain solve;
  * 2 gloo processes at 65^2 against JAX's sharded solve on its 8-device
    CPU mesh (rtol 2e-5, atol 2e-6, error_linf within 1e-6, as
    tests/test_parallel.py:185-203) and bitwise the port's one-rank solve;
  * the CLI's `--problem lyapunov2d --mesh 1`.

`Ring` (every shard of a ring in one process, one thread a shard) comes
from tests/test_torch_parallel.py."""

import contextlib
import io
import json
import math
import subprocess
import sys

import numpy as np
import pytest
import torch
from test_torch_parallel import Ring, _env, _free_port, _Ranks

import pde_multigrid_tpu as J
from pde_multigrid_tpu.parallel import mesh as jmesh
from pde_multigrid_tpu_torch import CycleConfig, MultigridSolver, SolverConfig
from pde_multigrid_tpu_torch import grid as TG
from pde_multigrid_tpu_torch.cycles import TorchKernels
from pde_multigrid_tpu_torch.models import Lyapunov2D
from pde_multigrid_tpu_torch.ops.cuda import relax2d as R2
from pde_multigrid_tpu_torch.parallel import halo
from pde_multigrid_tpu_torch.parallel.mesh import make_mesh, shard_rows
from pde_multigrid_tpu_torch.parallel.sharded import ShardedKernels
from pde_multigrid_tpu_torch.solver import _exact_num_levels

DOM = Lyapunov2D().domain
FMG = SolverConfig(cycle=CycleConfig("fmg", 1, 2, 2), max_cycles=2, tol=0.0)
EXACT = SolverConfig(cycle=CycleConfig("fmg", 2, 5, 5, coarsest="exact"),
                     max_cycles=2, tol=0.0)


def _rand(shape, seed):
    rng = np.random.default_rng(seed)
    return torch.tensor(rng.standard_normal(shape).astype(np.float32))


# ------------------------------------------------------------ the window


@pytest.mark.parametrize("n", [1, 2, 4])
def test_window_fetch(n):
    """Every rank's window [lo, hi) is the whole level's rows lo .. hi - 1
    modulo its X rows (the ring wraps as torch.roll does), for windows
    reaching into either neighbour, windows that differ by rank (the
    restriction's of 4097^2 over 4 ranks: fine [2 r xc - 1, 2 (r + 1) xc)
    with 2 xc = x_loc + 1), and a window inside the own rows; one
    reaching past `depth` rows raises on every rank before any
    exchange."""
    x_loc = 7
    X = n * x_loc
    arr = _rand((X, 5), n)
    xc = (x_loc + 1) // 2
    cases = [(lambda r: r * x_loc - 1, lambda r: (r + 1) * x_loc + 1, 1),
             (lambda r: r * x_loc - 3, lambda r: r * x_loc + 2, 3),
             (lambda r: (r + 1) * x_loc, lambda r: (r + 1) * x_loc + 4, 4),
             (lambda r: 2 * r * xc - 1, lambda r: 2 * (r + 1) * xc, n),
             (lambda r: r * x_loc + 2, lambda r: r * x_loc + 5, 0)]

    def shard(m):
        own = arr[m.rank * x_loc:(m.rank + 1) * x_loc].clone()
        got = [m.window(own, lo(m.rank), hi(m.rank), d)
               for lo, hi, d in cases]
        with pytest.raises(ValueError, match="reach past"):
            m.window(own, m.rank * x_loc - 2, m.rank * x_loc + 1, 1)
        with pytest.raises(ValueError, match="reach past"):
            m.window(own, 0, 1, x_loc + 1)
        return got

    for r, got in enumerate(Ring(n).run(shard)):
        for (lo, hi, _), g in zip(cases, got):
            idx = torch.arange(lo(r), hi(r)) % X
            assert torch.equal(g, arr[idx]), (r, lo(r), hi(r))


# ------------------------------------------------- transfers and residual


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_padded_transfers_bitwise(n):
    """On every level pair of 65^2 padded for n ranks (sharded fine and
    sharded coarse, and at n = 8 sharded 33^2 into replicated 17^2):
    the sharded residual, restriction and prolongation over every shard
    of a ring, concatenated, equal the unsharded plain ops on the whole
    padded arrays bit for bit, padding rows included."""
    prob = Lyapunov2D()
    geoms = TG.build_geometries((65, 65), DOM, pad_axis0_to=n)
    levels = [prob.init_level(g) for g in geoms]
    whole = TorchKernels(prob, geoms)
    tiers = {}
    pairs = [l for l in range(len(geoms) - 1)
             if ShardedKernels(prob, geoms, _Ranks(n), relaxed_levels=()
                               ).sharded[l]]
    assert pairs
    data = {l: (_rand(geoms[l].padded_shape, 10 * l + n),
                _rand(geoms[l].padded_shape, 10 * l + n + 1),
                _rand(geoms[l + 1].padded_shape, 10 * l + n + 2))
            for l in pairs}

    def shard(m):
        k = tiers[m.rank] = ShardedKernels(prob, geoms, m,
                                           relaxed_levels=())
        out = {}
        for l in pairs:
            v, f, c = data[l]
            rows = k.owned_rows(l)
            aux = {key: a[rows] if a.shape[0] == v.shape[0] else a
                   for key, a in levels[l].aux.items()}
            caux = levels[l + 1].aux
            crows = k.owned_rows(l + 1)
            out[l] = (k.residual(l, v[rows], f[rows], aux),
                      k.restrict(l, f[rows], caux["m_int"][crows],
                                 caux["m_log"][crows]),
                      k.prolong(l, c[crows]))
        return out

    got = Ring(n).run(shard)
    for l in pairs:
        v, f, c = data[l]
        caux = levels[l + 1].aux
        csharded = tiers[0].sharded[l + 1]
        want = (whole.residual(l, v, f, levels[l].aux),
                whole.restrict(l, f, caux["m_int"], caux["m_log"]),
                whole.prolong(l, c))
        for i, w in enumerate(want):
            parts = [g[l][i] for g in got]
            full = (torch.cat(parts) if i != 1 or csharded else parts[0])
            assert torch.equal(full, w), (n, l, ["residual", "restrict",
                                                 "prolong"][i])


# ------------------------------------------------------------ the engine


@pytest.mark.parametrize("n,T", [(1, 4), (2, 4), (4, 2), (4, 4), (8, 4)])
def test_split2d_engine_composes_bitwise(n, T):
    """The split2d engine over every shard of 65^2 padded for n ranks
    (x_loc 65, 33, 17, 9: shards starting at odd rows over 2, 4 and 8)
    equals the whole-level half-sweeps (relax_halves2d) on the padded
    level, merged, bit for bit: T sweeps and 2T + 1 (a remainder
    chunk)."""
    prob = Lyapunov2D()
    g = TG.build_geometries((65, 65), DOM, pad_axis0_to=n)[0]
    X = g.padded_shape[0]
    x_loc = X // n
    v, f = _rand(g.padded_shape, 3 * n + T), _rand(g.padded_shape, 7 * n)
    assert halo.plan_engine(prob, g, n) == "split2d"
    for ns in (T, 2 * T + 1):
        def shard(m):
            fn = halo.make_sharded_relax(prob, g, m, T)
            rows = slice(m.rank * x_loc, (m.rank + 1) * x_loc)
            return fn(v[rows].clone(), f[rows].clone(), ns)

        got = torch.cat(Ring(n).run(shard))
        r, b = R2.to_halves(v)
        fr, fb = R2.to_halves(f)
        r, b = R2.relax_halves2d(r, b, fr, fb, ns, prob, g)
        want = R2.from_halves(r, b, torch.empty_like(v))
        assert torch.equal(got, want), (ns, float((got - want).abs().max()))


@pytest.mark.parametrize("m", [65, 513])
def test_one_rank_engine_bitwise(m):
    """The split2d engine on a one-rank ring over m^2: no halo taken, a
    whole leg a launch where the level fits on chip (65^2) and chunks of
    T = 4 in the one-rank form where it does not (513^2); legs of 1, 3
    and 7 sweeps bitwise the whole-level half-sweeps."""
    prob = Lyapunov2D()
    g = TG.build_geometries((m, m), DOM)[0]
    v, f = _rand(g.padded_shape, m), _rand(g.padded_shape, m + 1)
    fn = halo.make_sharded_relax(prob, g, make_mesh(1, device="cpu"), 4)
    assert fn.leg == (m == 65)
    for ns in (1, 3, 7):
        got = fn(v.clone(), f, ns)
        r, b = R2.to_halves(v)
        fr, fb = R2.to_halves(f)
        r, b = R2.relax_halves2d(r, b, fr, fb, ns, prob, g)
        want = R2.from_halves(r, b, torch.empty_like(v))
        assert torch.equal(got, want), ns


@pytest.mark.parametrize("n", range(1, 9))
def test_plan_pins_4097(n):
    """The plan the card runs for Lyapunov 4097^2, FMG exact coarsest
    (the dense inverse at 33^2): over 1 to 8 ranks every level is
    sharded, the seven relaxed ones (4097^2 ... 65^2) take the split2d
    engine with T = min(4, x_loc // 2) = 4, and 33^2 is solved exactly.
    The rows are padded to a multiple of n (4100 over 4: x_loc 1025)."""
    prob = Lyapunov2D()
    L = _exact_num_levels(prob, 4097, False)
    geoms = TG.build_geometries((4097, 4097), DOM, L, pad_axis0_to=n)
    assert [g.shape[0] for g in geoms] == [2 ** (12 - l) + 1
                                           for l in range(8)]
    k = ShardedKernels(prob, geoms, _Ranks(n), relaxed_levels=range(L - 1))
    assert all(k.sharded)
    assert k.plan == ["split2d"] * 7 + [None]
    assert geoms[0].padded_shape[0] == n * math.ceil(4097 / n)
    for fn, g in zip(k._relax[:-1], geoms):
        assert fn.T == min(4, g.padded_shape[0] // n // 2) == 4
    # on one rank (a one-rank ring: no halo copies) 257^2, 129^2 and 65^2
    # fit on chip and run a whole leg a launch; over more ranks every
    # level chunks on its shard
    legs = [fn.leg for fn in k._relax[:-1]]
    assert legs == ([False] * 4 + [True] * 3 if n == 1 else [False] * 7)


# ---------------------------------------------------------- whole solves


def _logical(v):
    return v[:65, :65]


@pytest.mark.parametrize("cfg", [FMG, EXACT], ids=["relax", "exact"])
def test_solves_over_shards_bitwise(cfg):
    """65^2 FMG over 1, 2, 4 and 8 shards in one process: the logical v
    bitwise the same on every n (every relaxed level in the split2d
    arithmetic: replicated coarse levels run the engine on a one-rank
    ring), error_linf equal, the residual history to float32 rounding of
    the summed norms; each within JAX's sharded-vs-single tolerance of
    the unsharded plain solve (whose dense relax divides where the
    split form multiplies by a reciprocal)."""
    single = MultigridSolver(Lyapunov2D(), 65, cfg,
                             device="cpu").solve_to_tolerance()
    base = None
    for n in (1, 2, 4, 8):
        ring = Ring(n)
        solvers = {}

        def make(m):
            solvers[m.rank] = MultigridSolver(Lyapunov2D(), 65, cfg,
                                              device="cpu", mesh=m)

        for r in range(n):  # built one by one: the dense inverse is BLAS
            ring.run(lambda m: make(m) if m.rank == r else None)
        res = ring.run(lambda m: solvers[m.rank].solve_to_tolerance())
        kern = solvers[0].program.kernels
        plan = kern.plan
        assert set(plan) <= {"split2d", None}, plan
        # the one-rank schedule: every level on a one-rank ring (all of
        # them on one rank, the replicated ones on more) a whole leg a
        # launch, every level split over the ranks in chunks
        for l, fn in enumerate(kern._relax):
            if fn is not None:
                assert fn.leg == (n == 1 or not kern.sharded[l]), (n, l)
        base = base or res[0]
        for r in res:
            assert torch.equal(_logical(r.v), _logical(base.v)), n
            assert r.error_linf == base.error_linf
            np.testing.assert_allclose(r.residual_history,
                                       base.residual_history, rtol=1e-6)
            assert not r.diverged
        np.testing.assert_allclose(_logical(res[0].v), single.v, rtol=2e-5,
                                   atol=2e-6)
        assert abs(res[0].error_linf - single.error_linf) < 1e-6


_RANK = r"""
import json, sys
import numpy as np
import torch.distributed as dist
from pde_multigrid_tpu_torch import CycleConfig, MultigridSolver, SolverConfig
from pde_multigrid_tpu_torch.models import Lyapunov2D
from pde_multigrid_tpu_torch.parallel.mesh import make_mesh
addr, n, rank, out = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
dist.init_process_group("gloo", init_method=f"tcp://{addr}", world_size=n,
                        rank=rank)
cfg = SolverConfig(cycle=CycleConfig("fmg", 2, 5, 5, coarsest="exact"),
                   max_cycles=2, tol=0.0)
s = MultigridSolver(Lyapunov2D(), 65, cfg, device="cpu",
                    mesh=make_mesh(n, device="cpu"))
r = s.solve_to_tolerance()
if rank == 0:
    np.save(out, r.v.numpy()[:65, :65])
print(json.dumps({"rank": rank, "error_linf": r.error_linf,
                  "plan": s.program.kernels.plan,
                  "jax": "jax" in sys.modules}))
dist.destroy_process_group()
"""


def test_gloo_ranks_match_jax_and_the_one_rank_solve(tmp_path):
    """65^2 FMG(2, 5, 5), exact coarsest, 2 cycles, over 2 gloo processes
    (a shard starting at the odd row 33): against JAX's
    MultigridSolver(..., mesh=make_mesh(2)) on the 8-device CPU mesh to
    rtol 2e-5, atol 2e-6 and error_linf within 1e-6; rank 0's logical v
    bitwise the port's one-rank solve; no process imports JAX."""
    addr = f"localhost:{_free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK, addr, "2", str(r),
         str(tmp_path / "v.npy")], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=_env()) for r in range(2)]
    try:
        one = MultigridSolver(Lyapunov2D(), 65, EXACT, device="cpu",
                              mesh=make_mesh(1, device="cpu"))
        r1 = one.solve_to_tolerance()
        jr = J.MultigridSolver(J.Lyapunov2D(), 65, J.SolverConfig(
            cycle=J.CycleConfig("fmg", 2, 5, 5, coarsest="exact"),
            max_cycles=2, tol=0.0), mesh=jmesh.make_mesh(2)
        ).solve_to_tolerance()
        rows = []
        for p in procs:
            out, err = p.communicate(timeout=300)
            assert p.returncode == 0, err[-3000:]
            rows.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert not any(row["jax"] for row in rows)
    assert rows[0]["plan"] == ["split2d", None]
    v = np.load(tmp_path / "v.npy")
    np.testing.assert_array_equal(v, r1.v.numpy())
    np.testing.assert_allclose(v, np.asarray(jr.v)[:65, :65], rtol=2e-5,
                               atol=2e-6)
    for row in rows:
        assert abs(row["error_linf"] - jr.error_linf) < 1e-6
        assert row["error_linf"] == r1.error_linf


def test_cli_lyapunov_mesh_1():
    """`--device cpu --problem lyapunov2d --n 65 --coarsest exact --mesh 1`
    through the CLI in process: the sharded tier over one rank, split2d
    on 65^2; error_linf under the bench's gate max(10 h, 5e-5) for this
    first-order scheme, and the residual falls."""
    from pde_multigrid_tpu_torch.__main__ import main

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        res = main(["--device", "cpu", "--problem", "lyapunov2d", "--n",
                    "65", "--nu0", "2", "--nu1", "10", "--nu2", "10",
                    "--coarsest", "exact", "--mesh", "1", "--cycles", "2"])
    summary = json.loads(out.getvalue().strip().splitlines()[-1])
    assert summary["problem"] == "lyapunov2d" and not summary["diverged"]
    assert summary["error_linf"] == res.error_linf < max(10 / 64, 5e-5)
    hist = summary["residual_history"]
    assert hist[-1] < hist[0]
    assert "ShardedKernels over 1 rank(s)" in err.getvalue()
    assert tuple(res.v.shape) == (65, 65)
    assert shard_rows(make_mesh(1, device="cpu"),
                      TG.build_geometries((65, 65), DOM)[0]) == slice(0, 65)
