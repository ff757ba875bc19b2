"""The sharded solve of the port (`pde_multigrid_tpu_torch/parallel/`)
against the JAX package's `parallel/` and against the port's own
unsharded solve, on the CPU.

  * the level shardings against JAX's `level_sharding`, and the plan the
    card runs: the engine and T per level of the 257^3 and 129^3
    hierarchies over 1, 2, 4 and 8 ranks;
  * the two engines composed over every shard of a ring, in one process
    (`Ring`: one thread a shard, the halos passed through shared memory),
    against the single-device relax, bitwise: the wavefront's plain
    version for the time-skew engine, `relax_rbgs` (the blend form) for
    the masked block; full chunks and a remainder chunk;
  * whole FMG solves over 1, 2, 4 and 8 shards in one process, bitwise
    the port's unsharded plain solve (correction scheme, relaxed and exact
    coarsest; FAS, relaxed coarsest);
  * whole solves over 2 and 4 gloo processes (each importing torch and the
    port only), in the correction scheme and in FAS, each against JAX's sharded solve on its 8-device CPU mesh (rtol
    2e-5, atol 2e-6 and error_linf within 1e-6, as
    tests/test_parallel.py:185-203) and bitwise against the port's
    one-rank solve; the CLI over `--distributed`, where rank 0 alone
    prints;
  * the refusals at construction.
"""

import json
import os
import socket
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

import pde_multigrid_tpu as J
from pde_multigrid_tpu.parallel import mesh as jmesh
from pde_multigrid_tpu_torch import CycleConfig, MultigridSolver, SolverConfig
from pde_multigrid_tpu_torch import grid as TG
from pde_multigrid_tpu_torch.models import (
    HJBMinTime,
    Lyapunov2D,
    Poisson,
    Poisson3D,
)
from pde_multigrid_tpu_torch.ops import stencil
from pde_multigrid_tpu_torch.ops.cuda import relax as R
from pde_multigrid_tpu_torch.parallel import halo
from pde_multigrid_tpu_torch.parallel.mesh import (
    Mesh,
    level_sharding,
    make_mesh,
    shard_rows,
)
from pde_multigrid_tpu_torch.parallel.sharded import ShardedKernels

ROOT = Path(__file__).resolve().parents[1]
DOM = ((0.0, 1.0),) * 3
FMG = SolverConfig(cycle=CycleConfig("fmg", 1, 2, 2), max_cycles=2, tol=0.0)
EXACT = SolverConfig(cycle=CycleConfig("fmg", 2, 5, 5, coarsest="exact"),
                     max_cycles=2, tol=0.0)
FAS = SolverConfig(cycle=CycleConfig("fmg", 1, 2, 2, scheme="fas"),
                   max_cycles=2, tol=0.0)
# a W-cycle (mu = 2): held on 1 and 2 shards
W = SolverConfig(cycle=CycleConfig("fmg", 1, 2, 2, 2), max_cycles=2,
                 tol=0.0)


class Ring:
    """Every shard of an n-rank ring in one process, one thread a shard:
    `run(fn)` calls fn(mesh) on each shard's mesh and returns the results
    in rank order.  The collectives pass tensors through shared slots
    between two barriers."""

    def __init__(self, n):
        self.n = n
        self.barrier = threading.Barrier(n)
        self.slots = [None] * n

    def run(self, fn):
        out, errs = [None] * self.n, []

        def go(rank):
            try:
                out[rank] = fn(_ThreadMesh(self, rank))
            except BaseException as e:  # noqa: BLE001 - re-raised below
                errs.append(e)
                self.barrier.abort()

        threads = [threading.Thread(target=go, args=(r,))
                   for r in range(self.n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errs:
            raise errs[0]
        return out


class _ThreadMesh:
    def __init__(self, ring, rank):
        self.ring, self.rank, self.n = ring, rank, ring.n
        self.device = torch.device("cpu")

    def _swap(self, item):
        self.ring.slots[self.rank] = item
        self.ring.barrier.wait()
        got = list(self.ring.slots)
        self.ring.barrier.wait()
        return got

    def exchange(self, arr, h):
        got = self._swap((arr[-h:].clone(), arr[:h].clone()))
        return got[(self.rank - 1) % self.n][0], got[(self.rank + 1)
                                                     % self.n][1]

    window = Mesh.window  # built on exchange

    def all_reduce(self, t, op="sum"):
        got = self._swap(t.clone())
        out = got[0]
        for g in got[1:]:
            out = out + g if op == "sum" else torch.maximum(out, g)
        return out

    def all_gather(self, arr):
        return torch.cat(self._swap(arr.clone()), dim=0)


class _Ranks:
    """A mesh of `n` ranks seen from rank 0, for plans (no collective)."""

    def __init__(self, n):
        self.n, self.rank, self.device = n, 0, torch.device("cpu")


def _level(n, seed):
    g = TG.build_geometries((n,) * 3, DOM, 1, wrap=True)[0]
    rng = np.random.default_rng(seed)
    m = torch.tensor(TG.wrap_interior(g.padded_shape), dtype=torch.float32)
    v = torch.tensor(rng.standard_normal(g.padded_shape).astype(np.float32))
    f = torch.tensor(rng.standard_normal(g.padded_shape).astype(np.float32))
    return g, v * m, f


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


# ------------------------------------------------------- plans and shardings


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_level_sharding_matches_jax(n):
    """Split or replicated: JAX's rule on every level of 33^3, 129^3 and
    257^3 (wrap) and of a padded 2D hierarchy, with pad_axis0_to = n."""
    jm = jmesh.make_mesh(n)
    for shape, wrap in (((33,) * 3, True), ((129,) * 3, True),
                        ((257,) * 3, True), ((65, 65), False)):
        dom = ((0.0, 1.0),) * len(shape)
        jgs = J.grid.build_geometries(shape, dom, pad_axis0_to=n, wrap=wrap)
        tgs = TG.build_geometries(shape, dom, pad_axis0_to=n, wrap=wrap)
        for jg, tg in zip(jgs, tgs):
            assert tg.padded_shape == jg.padded_shape
            spec = jmesh.level_sharding(jm, jg).spec
            assert level_sharding(_Ranks(n), tg) == (spec[0] == "x")


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_plan_pins_257_and_129(n):
    """The plan the card runs (the gates are functions of the shapes, the
    same on either device): at 257^3, FMG exact coarsest, 256^3 takes the
    time-skew engine, 128^3 the masked block, 64^3 is solved exactly; at
    129^3, 128^3 the masked block (half-plane 8192 < 16384); T = min(4,
    x_loc // 2) everywhere.  CPU tensors: the plan is built, no level
    allocated beyond the hierarchy."""
    for size, plan in ((257, ["timeskew", "masked-block", None]),
                       (129, ["masked-block", None])):
        s = MultigridSolver(Poisson3D(), size, EXACT, device="cpu")
        k = ShardedKernels(s.problem, s.geoms, _Ranks(n), torch.float32,
                           relaxed_levels=range(len(s.geoms) - 1))
        assert k.plan == plan, (size, n)
        assert all(k.sharded)
        for fn, g in zip(k._relax, s.geoms):
            if fn is not None:
                assert fn.T == min(4, g.padded_shape[0] // n // 2)
                assert fn.engine == halo.plan_engine(s.problem, g, n)


# -------------------------------------------------- engines over all shards


def _compose(v, f, g, n, T, ns):
    X = g.padded_shape[0]
    x_loc = X // n

    def shard(m):
        fn = halo.make_sharded_relax(Poisson3D(), g, m, T)
        rows = slice(m.rank * x_loc, (m.rank + 1) * x_loc)
        return fn.engine, fn(v[rows].clone(), f[rows].clone(), ns)

    out = Ring(n).run(shard)
    return out[0][0], torch.cat([o[1] for o in out], dim=0)


@pytest.mark.parametrize("size,n,T", [(17, 1, 4), (17, 2, 2), (17, 4, 1),
                                      (33, 2, 4), (33, 4, 2), (33, 8, 2)])
def test_timeskew_engine_composes_bitwise(monkeypatch, size, n, T):
    """The time-skew engine over every shard (the gate's half-plane lowered
    to take these small levels) equals the single-device wavefront's plain
    version (where form), merged, bit for bit: full chunks and a
    remainder."""
    monkeypatch.setattr(R, "TIMESKEW_MIN_PLANE", 0)
    g, v, f = _level(size, 10 * size + n)
    b = R.split_colors(v)[1]
    fr, fb = R.split_colors(f)
    for ns in (T, 2 * T + 1):
        engine, got = _compose(v, f, g, n, T, ns)
        assert engine == "timeskew"
        want = R.merge_colors(*R.timeskew_sweeps_plain(b, fr, fb, ns,
                                                       Poisson3D(), g))
        assert torch.equal(got, want), (ns, float((got - want).abs().max()))


@pytest.mark.parametrize("size,n,T", [(17, 1, 4), (17, 2, 2), (17, 4, 1),
                                      (33, 2, 4), (33, 4, 4), (33, 8, 2)])
def test_masked_block_engine_composes_bitwise(size, n, T):
    """The masked-block engine over every shard equals the single-device
    relax_rbgs (the blend form, Poisson's relax_update) bit for bit: full
    chunks and a remainder."""
    g, v, f = _level(size, 20 * size + n)
    aux = TG.base_aux(g)
    prob = Poisson3D()
    for ns in (T, 2 * T + 1):
        engine, got = _compose(v, f, g, n, T, ns)
        assert engine == "masked-block"
        want = stencil.relax_rbgs(
            lambda vv, ff: prob.relax_update(vv, ff, g, aux), v.clone(), f,
            aux["m_red"], aux["m_black"], ns)
        assert torch.equal(got, want), (ns, float((got - want).abs().max()))


# ---------------------------------------------------------- whole solves


@pytest.mark.parametrize("cfg", [FMG, EXACT, FAS, W],
                         ids=["relax", "exact", "fas", "w"])
def test_solves_over_shards_equal_the_unsharded_solve(cfg):
    """FMG over 1, 2, 4 and 8 shards in one process: v (gathered), the
    residual history to float32 rounding of the summed norms, and
    error_linf exactly as the unsharded plain solve's; v bitwise.  In
    the FAS scheme the injection into a replicated coarse level takes the
    whole fine level (ROADMAP queue 3 F3: each rank injected its own
    planes only).  The W-cycle (mu = 2) over 1 and 2 shards."""
    single = MultigridSolver(Poisson3D(), 33, cfg,
                             device="cpu").solve_to_tolerance()
    for n in (1, 2) if cfg is W else (1, 2, 4, 8):
        res = Ring(n).run(lambda m: MultigridSolver(
            Poisson3D(), 33, cfg, device="cpu",
            mesh=m).solve_to_tolerance())
        for r in res:
            assert torch.equal(r.v, single.v), n
            assert r.error_linf == single.error_linf
            np.testing.assert_allclose(r.residual_history,
                                       single.residual_history, rtol=1e-6)
            assert not r.diverged


_RANK = r"""
import json, sys
import numpy as np
import torch
import torch.distributed as dist
from pde_multigrid_tpu_torch import CycleConfig, MultigridSolver, SolverConfig
from pde_multigrid_tpu_torch.models import Poisson3D
from pde_multigrid_tpu_torch.parallel.mesh import make_mesh
addr, n, rank, out = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
scheme = sys.argv[5]
dist.init_process_group("gloo", init_method=f"tcp://{addr}", world_size=n,
                        rank=rank)
cfg = SolverConfig(cycle=CycleConfig("fmg", 1, 2, 2, scheme=scheme),
                   max_cycles=2, tol=0.0)
s = MultigridSolver(Poisson3D(), 33, cfg, device="cpu",
                    mesh=make_mesh(n, device="cpu"))
r = s.solve_to_tolerance()
if rank == 0:
    np.save(out, r.v.numpy())
print(json.dumps({"rank": rank, "error_linf": r.error_linf,
                  "history": r.residual_history, "plan": s.program.kernels.plan,
                  "jax": "jax" in sys.modules}))
dist.destroy_process_group()
"""


def _env():
    return dict(os.environ, PYTHONPATH=str(ROOT), GLOO_SOCKET_IFNAME="lo",
                OMP_NUM_THREADS="1")


def test_gloo_ranks_match_jax_and_the_one_rank_solve(tmp_path, monkeypatch):
    """33^3 FMG(1, 2, 2), 2 cycles, over 2 and 4 gloo processes: against
    JAX's MultigridSolver(..., mesh=make_mesh(n)) on the 8-device CPU mesh
    to rtol 2e-5, atol 2e-6 and error_linf within 1e-6; rank 0's v bitwise
    the port's one-rank and unsharded solves; no process imports JAX.  JAX
    runs the masked-block engine on every split level, as the port's plan
    does at this size (the half-plane gate); its interpret mode would
    otherwise drop its hardware gate and take the time-skew engine
    (PDE_MG_SHARD_TIMESKEW, parallel/halo.py:103-130)."""
    _gloo_case(tmp_path, monkeypatch, FMG)


def test_gloo_fas_ranks_match_jax_and_the_one_rank_solve(tmp_path,
                                                         monkeypatch):
    """The same in FAS (ROADMAP queue 3 F3): the injection into the
    replicated coarse levels (5^3 and 3^3 over 2 ranks, 9^3 too over 4)
    takes the gathered fine level, so rank 0's v is bitwise the one-rank
    solve's, and within JAX's tolerance of its sharded FAS solve."""
    _gloo_case(tmp_path, monkeypatch, FAS)


def _gloo_case(tmp_path, monkeypatch, cfg):
    monkeypatch.setenv("PDE_MG_SHARD_TIMESKEW", "0")
    procs = {}
    for n in (2, 4):
        addr = f"localhost:{_free_port()}"
        procs[n] = [subprocess.Popen(
            [sys.executable, "-c", _RANK, addr, str(n), str(r),
             str(tmp_path / f"v{n}.npy"), cfg.cycle.scheme],
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, env=_env()) for r in range(n)]
    try:
        one = MultigridSolver(Poisson3D(), 33, cfg, device="cpu",
                              mesh=make_mesh(1, device="cpu"))
        r1 = one.solve_to_tolerance()
        single = MultigridSolver(Poisson3D(), 33, cfg,
                                 device="cpu").solve_to_tolerance()
        assert torch.equal(r1.v, single.v)
        jax_res = {n: J.MultigridSolver(J.Poisson(3), 33, J.SolverConfig(
            cycle=J.CycleConfig("fmg", 1, 2, 2, scheme=cfg.cycle.scheme),
            max_cycles=2, tol=0.0),
            mesh=jmesh.make_mesh(n)).solve_to_tolerance() for n in procs}
        for n, group in procs.items():
            rows = []
            for p in group:
                out, err = p.communicate(timeout=300)
                assert p.returncode == 0, err[-3000:]
                rows.append(json.loads(out.strip().splitlines()[-1]))
            assert not any(row["jax"] for row in rows)
            v = np.load(tmp_path / f"v{n}.npy")
            np.testing.assert_array_equal(v, r1.v.numpy())
            jr = jax_res[n]
            np.testing.assert_allclose(v, np.asarray(jr.v), rtol=2e-5,
                                       atol=2e-6)
            for row in rows:
                assert abs(row["error_linf"] - jr.error_linf) < 1e-6
                assert row["error_linf"] == r1.error_linf
    finally:
        for group in procs.values():
            for p in group:
                if p.poll() is None:
                    p.kill()


def test_cli_distributed_prints_on_rank_0_only():
    """`--mesh 2 --distributed localhost:PORT` in two processes, as
    tests/test_distributed.py runs the JAX CLI: rank 0 prints the summary
    JSON, rank 1 prints nothing; the solve converges to O(h^2)."""
    addr = f"localhost:{_free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "pde_multigrid_tpu_torch", "--device", "cpu",
         "--problem", "poisson3d", "--n", "33", "--kind", "fmg", "--nu0",
         "1", "--nu1", "2", "--nu2", "2", "--cycles", "2", "--mesh", "2",
         "--distributed", addr, "--num-processes", "2", "--process-id",
         str(r)], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=_env(), cwd=ROOT) for r in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=300)
            assert p.returncode == 0, err[-3000:]
            outs.append((out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    lines = [ln for ln in outs[0][0].splitlines() if ln.startswith("{")]
    assert len(lines) == 1
    res = json.loads(lines[0])
    assert res["problem"] == "poisson3d" and not res["diverged"]
    assert res["error_linf"] < 50 * (1.0 / 32) ** 2
    assert res["residual_history"][-1] < 0.2 * res["residual_history"][0]
    assert "ShardedKernels over 2 rank(s)" in outs[0][1]
    assert not outs[1][0].strip()


# ------------------------------------------------------------- refusals


def test_refusals_at_construction():
    """A mesh solve outside the slice raises at construction, naming its
    ROADMAP item: 2D Poisson (its 2D kernels), 1D, HJB (the keep-mask
    engine), Lyapunov in the FAS scheme (the sharded FAS ops), a smoother
    other than rbgs, float64 (the port's gates are the same on either
    device, so these are checked on a cpu mesh);
    Galerkin is JAX's ValueError; a
    mesh of another size than the process group, or on a device the mesh
    does not run on, raises."""
    mesh = make_mesh(1, device="cpu")
    cases = [(Poisson(2), 33, {}, "queue 1 item 17"),
             (Lyapunov2D(), 33, {"scheme": "fas"}, "queue 2 item 40"),
             (Poisson(1), 33, {}, "queue 1 item 17"),
             (HJBMinTime(), 33, {}, "queue 2 item 40"),
             (Poisson3D(), 17, {"smoother": "jacobi"}, "queue 1 item 17")]
    for prob, size, kw, item in cases:
        cfg = SolverConfig(cycle=CycleConfig(**kw))
        with pytest.raises(NotImplementedError, match=item):
            MultigridSolver(prob, size, cfg, device="cpu", mesh=mesh)
    with pytest.raises(NotImplementedError, match="queue 1 item 17"):
        MultigridSolver(Poisson3D(), 17, SolverConfig(dtype="float64"),
                        device="cpu", mesh=mesh)
    with pytest.raises(ValueError, match="galerkin"):
        MultigridSolver(Poisson3D(), 17, SolverConfig(
            cycle=CycleConfig(coarse_operator="galerkin")), device="cpu",
            mesh=mesh)
    with pytest.raises(RuntimeError, match="2 ranks"):
        make_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="NCCL"):
        make_mesh(1, "nccl", device="cpu")
    with pytest.raises(ValueError, match="mesh"):
        MultigridSolver(Poisson3D(), 17, device="cuda", mesh=mesh)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_mesh(1, device="cuda")
    assert shard_rows(mesh, TG.build_geometries((17,) * 3, DOM,
                                                wrap=True)[0]) == slice(0, 16)
