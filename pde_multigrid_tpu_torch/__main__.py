"""Command line: `python -m pde_multigrid_tpu_torch ...`

The port's counterpart of `python -m pde_multigrid_tpu`, for the options
this package covers.  `--preset` reproduces the reference programs'
parameters:

  ode1d          Poisson1DSolver.cpp:13-18   N=8193,  FMG(2, 1000, 1000)
  lyapunov2d     LyapunovSolver.cpp:13-31    N=1025^2 [0,1]^2,  FMG(1, 500, 500)
  lyapunov2d-cuda CUDA .../main.cu:13-25     N=65^2  [0,20]^2,  FMG(2, 500, 500)
  poisson3d      Poisson3DSolver.cpp:14-20   N=129^3, FMG(2, 3000, 3000)
  poisson3d-cuda CUDA .../main.cu:18-22      N=257^3, FMG(2, 3000, 3000)

`--device` (cuda | cpu; default cuda) takes the place of `--backend`:
"cuda" runs on the card (the hand-written kernels for `--smoother rbgs`,
the line kernel for `line-K`, the plain tensor ops for `jacobi` and
`exact`, as the JAX jnp tier), "cpu" the plain tensor tier; without CUDA
the default raises.  `--kind w` with `--mu 2` runs W-cycles.  Output: the same
one-line summary JSON as the JAX CLI, and the reference-style timing
footer on stderr with the kernel tier that ran.

`--mesh N` splits the levels over N ranks (`parallel/`): N = 1 makes a
one-rank process group in process; more ranks run one process each,
started with `--distributed HOST:PORT --num-processes N --process-id I`
(`torch.distributed.init_process_group` over `tcp://HOST:PORT`).  Torch
must be told its backend, JAX is not: `--dist-backend` (nccl on cuda,
gloo on cpu by default; several ranks sharing one GPU need gloo).  Only
rank 0 prints.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

PRESETS = {
    "ode1d": dict(problem="ode1d", n=8193, kind="fmg", nu0=2, nu1=1000, nu2=1000),
    "lyapunov2d": dict(
        problem="lyapunov2d", n=1025, kind="fmg", nu0=1, nu1=500, nu2=500
    ),
    "lyapunov2d-cuda": dict(
        problem="lyapunov2d",
        n=65,
        kind="fmg",
        nu0=2,
        nu1=500,
        nu2=500,
        domain=20.0,
    ),
    "poisson3d": dict(
        problem="poisson3d", n=129, kind="fmg", nu0=2, nu1=3000, nu2=3000
    ),
    "poisson3d-cuda": dict(
        problem="poisson3d", n=257, kind="fmg", nu0=2, nu1=3000, nu2=3000
    ),
}


def build_problem(name: str, domain_hi: float | None):
    from pde_multigrid_tpu_torch import (
        HJBMinTime,
        Lyapunov2D,
        Ode1D,
        Poisson,
        VariableCoefficientPoisson,
    )

    if name in ("hjb2d", "hjb2d-tesi"):
        hi = domain_hi or 1.0
        return HJBMinTime(
            domain=((-hi, hi), (-hi, hi)),
            scheme="tesi" if name.endswith("tesi") else "upwind",
        )
    if name == "ode1d":
        return Ode1D(domain=((0.0, domain_hi or 1.0),))
    if name == "lyapunov2d":
        hi = domain_hi or 1.0
        return Lyapunov2D(domain=((0.0, hi), (0.0, hi)))
    if name.startswith("poisson") and name[len("poisson"):-1].isdigit():
        nd = int(name[len("poisson"):-1])
        hi = domain_hi or 1.0
        return Poisson(nd, domain=((0.0, hi),) * nd)
    if name.startswith("varcoef") and name[len("varcoef"):-1].isdigit():
        return VariableCoefficientPoisson(int(name[len("varcoef"):-1]))
    raise SystemExit(
        f"unknown problem {name!r} (the port covers ode1d, "
        "poisson{1,2,3}d, lyapunov2d, hjb2d[-tesi] and varcoef{1,2,3}d)"
    )


def _smoother(name: str) -> str:
    """--smoother's value: rbgs, jacobi, exact or line-K (K an axis)."""
    if name in ("rbgs", "jacobi", "exact") or (
            name.startswith("line-") and name[5:].isdigit()):
        return name
    raise argparse.ArgumentTypeError(
        f"{name!r}: choose rbgs, jacobi, exact or line-K (K an axis)")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="pde_multigrid_tpu_torch")
    ap.add_argument("--preset", choices=sorted(PRESETS), default=None)
    ap.add_argument(
        "--problem", default="poisson3d",
        help="ode1d | poisson{1,2,3}d | lyapunov2d | hjb2d[-tesi] | "
        "varcoef{1,2,3}d",
    )
    ap.add_argument("--n", type=int, default=129, help="points per axis (2^k+1)")
    ap.add_argument("--domain", type=float, default=None, help="domain upper bound")
    ap.add_argument("--kind", choices=["v", "w", "fmg"], default="fmg")
    ap.add_argument("--nu0", type=int, default=2)
    ap.add_argument("--nu1", type=int, default=2)
    ap.add_argument("--nu2", type=int, default=2)
    ap.add_argument("--mu", type=int, default=1,
                    help="coarse visits a level (1: V-cycle, 2: W-cycle)")
    ap.add_argument("--smoother", type=_smoother, default="rbgs",
                    help="rbgs (red-black Gauss-Seidel) | jacobi (damped) "
                    "| line-K (zebra lines along axis K) | exact (the 1D "
                    "direct scan)")
    ap.add_argument(
        "--scheme",
        choices=["cs", "fas"],
        default="cs",
        help="coarse-grid correction: cs (linear) | fas (nonlinear)",
    )
    ap.add_argument("--omega", type=float, default=1.0,
                    help="Jacobi damping")
    ap.add_argument(
        "--coarse-operator",
        choices=["rediscretize", "galerkin"],
        default="rediscretize",
        help="coarse-level operators: rediscretized, or Galerkin R A P",
    )
    ap.add_argument(
        "--coarsest",
        choices=["relax", "exact"],
        default="relax",
        help="coarsest-level solver: nu1+nu2 sweeps, or a direct solve "
        "(fast diagonalization or the probed dense inverse; truncates "
        "the hierarchy)",
    )
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--device", default="cuda", help="cuda | cpu")
    ap.add_argument(
        "--precision",
        choices=["f32", "mixed"],
        default="f32",
        help="mixed = bf16 defect-correction smoothing (same f32 result)",
    )
    ap.add_argument("--tol", type=float, default=0.0)
    ap.add_argument(
        "--cycles", type=int, default=1, help="max cycles after the first"
    )
    ap.add_argument("--mesh", type=int, default=0,
                    help="split the levels over N ranks")
    ap.add_argument(
        "--distributed", default=None, metavar="COORD_ADDR",
        help="HOST:PORT of rank 0: init_process_group(init_method="
        "'tcp://HOST:PORT') before the mesh; pair with --num-processes and "
        "--process-id",
    )
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--dist-backend", choices=["nccl", "gloo"], default=None,
                    help="process-group backend (default: nccl on cuda, "
                    "gloo on cpu)")
    args = ap.parse_args(argv)

    if args.preset:
        for k, v in PRESETS[args.preset].items():
            setattr(args, k, v)

    from pde_multigrid_tpu_torch import (
        CycleConfig,
        MultigridSolver,
        SolverConfig,
    )

    problem = build_problem(args.problem, args.domain)
    cfg = SolverConfig(
        cycle=CycleConfig(
            args.kind, args.nu0, args.nu1, args.nu2, args.mu,
            smoother=args.smoother, omega=args.omega,
            coarse_operator=args.coarse_operator, scheme=args.scheme,
            coarsest=args.coarsest,
        ),
        dtype=args.dtype,
        precision=args.precision,
        tol=args.tol,
        max_cycles=max(args.cycles, 1),
    )
    backend = args.dist_backend or (
        "nccl" if args.device.startswith("cuda") else "gloo")
    if args.distributed:
        import torch.distributed as dist

        if args.num_processes is None or args.process_id is None:
            raise SystemExit("--distributed needs --num-processes and "
                             "--process-id")
        dist.init_process_group(
            backend, init_method=f"tcp://{args.distributed}",
            world_size=args.num_processes, rank=args.process_id)
    mesh = None
    if args.mesh:
        from pde_multigrid_tpu_torch.parallel.mesh import make_mesh

        mesh = make_mesh(args.mesh, backend, args.device)

    t_start = time.time()
    solver = MultigridSolver(problem, args.n, cfg, device=args.device,
                             mesh=mesh)
    res = solver.solve_to_tolerance()
    if mesh is not None and mesh.rank != 0:
        return res
    print(
        json.dumps(
            {
                "problem": problem.name,
                "n": args.n,
                "cycle": dataclasses.asdict(cfg.cycle),
                "cycles_run": res.cycles_run,
                "residual_l2": res.residual_l2,
                "residual_history": res.residual_history,
                "error_l2": res.error_l2,
                "error_linf": res.error_linf,
                "error_mae": res.error_mae,
                "diverged": res.diverged,
                "wall_time_s": round(res.wall_time_s, 4),
                "compile_time_s": round(res.compile_time_s, 2),
            }
        )
    )
    # reference-style footer (Poisson3DSolver.cpp:44-46)
    print(f"finestGridSize: {args.n}", file=sys.stderr)
    print(
        f"Used {res.wall_time_s:0.2f} seconds of device time.",
        file=sys.stderr,
    )
    print(
        f"Finished in about {time.time() - t_start:.0f} seconds.",
        file=sys.stderr,
    )
    print(f"kernel tier: {type(solver.program.kernels).__name__}"
          + (f" over {mesh.n} rank(s)" if mesh is not None else ""),
          file=sys.stderr)
    return res


if __name__ == "__main__":
    main()
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
