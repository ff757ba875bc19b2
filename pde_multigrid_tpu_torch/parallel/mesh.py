"""Ranks, level shardings and the collectives of the sharded solve
(PyTorch port of `pde_multigrid_tpu.parallel.mesh`).

Every grid level whose axis 0 is long enough is split into contiguous
slabs of x-planes, one per rank of a `torch.distributed` process group;
the other levels are held whole by every rank (agglomeration), so the
coarse solve runs redundantly with no communication.  JAX gets the
partitioning from GSPMD; here each rank holds its own planes as plain
tensors and `parallel/halo.py` / `parallel/sharded.py` exchange what the
ops need.

The collectives are methods of `Mesh`: the ring exchange of halo planes,
the row window built on it, and the reductions and gathers of the
sharded tier.  NCCL takes device
tensors; a gloo group takes CPU tensors, so device tensors pass through
the host there (several ranks on one card must use gloo: NCCL places one
rank per GPU).  A one-rank mesh does no collective: its ring exchange is
the local copy that `lax.ppermute` to self computes, and its reductions
are the local ones, so a one-rank sharded step can be captured as a CUDA
graph.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from pde_multigrid_tpu_torch.grid import Level, LevelGeometry

SHARD_AXIS = "x"  # grid axis 0 is split over the ranks

BACKENDS = ("nccl", "gloo")


def min_shardable_extent(n_shards: int, halo: int = 1) -> int:
    """Smallest axis-0 extent worth sharding: every shard must own at least
    one interior plane beyond its halos."""
    return n_shards * (2 * halo + 1)


def level_sharding(mesh, geom: LevelGeometry, halo: int = 1) -> bool:
    """True when the level is split along axis 0 over the mesh's `n` ranks,
    False when every rank holds it whole (JAX's rule, mesh.py:44-58)."""
    n = mesh.n
    return (geom.shape[0] >= min_shardable_extent(n, halo)
            and geom.padded_shape[0] % n == 0)


@dataclasses.dataclass
class Mesh:
    """One rank's view of a 1-axis mesh: `n` ranks in the default process
    group, this process's `rank`, the torch `device` its tensors live on,
    and the group's `backend`."""

    rank: int
    n: int
    device: torch.device
    backend: str

    @property
    def left(self) -> int:
        return (self.rank - 1) % self.n

    @property
    def right(self) -> int:
        return (self.rank + 1) % self.n

    def _staged(self, t: torch.Tensor) -> bool:
        return self.backend == "gloo" and t.device.type != "cpu"

    def exchange(self, arr: torch.Tensor, h: int):
        """(from_left, from_right): the left neighbour's last `h` planes of
        `arr` and the right neighbour's first `h` (halo.py:257-262).  On a
        one-rank ring both are views of `arr`'s own planes."""
        if self.n == 1:
            return arr[-h:], arr[:h]
        stage = self._staged(arr)
        send_r, send_l = arr[-h:], arr[:h]
        if stage:
            send_r, send_l = send_r.cpu(), send_l.cpu()
        else:
            send_r, send_l = send_r.contiguous(), send_l.contiguous()
        recv_l, recv_r = torch.empty_like(send_r), torch.empty_like(send_l)
        # with n == 2 both neighbours are the same rank, and NCCL pairs a
        # peer's point-to-point ops in order (it has no tags): this order
        # makes each rank's k-th send to a peer its peer's k-th receive
        # from it (rightward first, then leftward)
        ops = [dist.P2POp(dist.isend, send_r, self.right, tag=0),
               dist.P2POp(dist.isend, send_l, self.left, tag=1),
               dist.P2POp(dist.irecv, recv_l, self.left, tag=0),
               dist.P2POp(dist.irecv, recv_r, self.right, tag=1)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        if stage:
            recv_l = recv_l.to(arr.device)
            recv_r = recv_r.to(arr.device)
        return recv_l, recv_r

    def window(self, arr: torch.Tensor, lo: int, hi: int, depth: int):
        """Global rows [lo, hi) of a sharded level, of which this rank
        holds `arr` (x_loc rows from row rank * x_loc), the rows taken
        modulo the level's n * x_loc (a ring, as `torch.roll` wraps the
        whole level): the rank's own rows and up to `depth` rows of each
        ring neighbour.  `depth` sizes the exchange, so it must be the
        same on every rank (the largest any rank's window needs; 0: no
        collective).  Raises if the window reaches more than `depth` rows
        past the rank's own."""
        x_loc = arr.shape[0]
        a = lo - self.rank * x_loc  # the window in local rows
        b = hi - self.rank * x_loc
        if not (-depth <= a <= b <= x_loc + depth) or depth > x_loc:
            raise ValueError(
                f"rows [{lo}, {hi}) reach past the {depth} rows taken from "
                f"each neighbour of rank {self.rank}'s [{self.rank * x_loc},"
                f" {(self.rank + 1) * x_loc})")
        if depth == 0:
            return arr[a:b]
        left, right = self.exchange(arr, depth)
        parts = ([left[depth + a:depth + min(b, 0)]] if a < 0 else []) + [
            arr[max(a, 0):min(b, x_loc)]] + (
            [right[max(a - x_loc, 0):b - x_loc]] if b > x_loc else [])
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=0)

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """`t` (a 0-dim tensor) reduced over the ranks, "sum" or "max"."""
        if self.n == 1:
            return t
        red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
        buf = t.detach().cpu() if self._staged(t) else t.detach().clone()
        dist.all_reduce(buf, red)
        return buf.to(t.device)

    def all_gather(self, arr: torch.Tensor) -> torch.Tensor:
        """The ranks' `arr` concatenated along axis 0, in rank order."""
        if self.n == 1:
            return arr
        src = arr.cpu() if self._staged(arr) else arr.contiguous()
        parts = [torch.empty_like(src) for _ in range(self.n)]
        dist.all_gather(parts, src)
        return torch.cat(parts, dim=0).to(arr.device)


def make_mesh(n: int | None = None, backend: str | None = None,
              device="cuda") -> Mesh:
    """The mesh of this process: the default process group when one
    exists, else (for n == 1 or None) a one-rank group made here, in
    process.  `backend` defaults to NCCL on "cuda" and gloo on "cpu"; a
    group that exists must have it and `n` ranks.  On "cuda" the rank's
    device is cuda:(rank % device_count)."""
    dev = torch.device(device)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' requested but CUDA is unavailable")
    want = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if want not in BACKENDS:
        raise ValueError(f"unknown backend {want!r} (nccl or gloo)")
    if want == "nccl" and dev.type != "cuda":
        raise ValueError("NCCL takes CUDA tensors; a cpu mesh uses gloo")
    if not dist.is_initialized():
        if n not in (None, 1):
            raise RuntimeError(
                f"a {n}-rank mesh needs a process group of {n} processes "
                "(torch.distributed.init_process_group, or the CLI's "
                "--distributed); none exists")
        dist.init_process_group(want, store=dist.HashStore(), rank=0,
                                world_size=1)
    size, rank = dist.get_world_size(), dist.get_rank()
    if n is not None and size != n:
        raise RuntimeError(f"mesh of {n} ranks, but the process group has "
                           f"{size}")
    have = dist.get_backend()
    if have != want:
        raise ValueError(f"the process group's backend is {have}, not "
                         f"{want}")
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    return Mesh(rank=rank, n=size, device=dev, backend=want)


def shard_rows(mesh, geom: LevelGeometry) -> slice:
    """The axis-0 planes of a level that this rank holds."""
    if not level_sharding(mesh, geom):
        return slice(None)
    x_loc = geom.padded_shape[0] // mesh.n
    return slice(mesh.rank * x_loc, (mesh.rank + 1) * x_loc)


def shard_levels(mesh, levels, geoms):
    """This rank's part of each level (mesh.py:77-89): its own x-planes of
    v, f and every full-size aux field of a sharded level (contiguous
    copies), the whole of a replicated one.  Every rank builds the same
    logical levels from the deterministic init, as JAX's `_put` assumes."""
    out = []
    for lvl, g in zip(levels, geoms):
        rows = shard_rows(mesh, g)
        if rows == slice(None):
            out.append(lvl)
            continue
        out.append(Level(
            v=lvl.v[rows].clone(),
            f=lvl.f[rows].clone(),
            aux={k: a[rows].clone() if a.shape[0] == g.padded_shape[0]
                 else a for k, a in lvl.aux.items()},
        ))
    return out
