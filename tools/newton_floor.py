"""How far f32 lets Newton go on the cylinder wake (chip_smoke.py phase 8's
configuration: Re=50 `medium`, 160 elements at order 6, dt = 5e-3,
vtol = ptol = 3e-6, tau = 0.5).

    python3 tools/newton_floor.py [--device cuda|cpu] [--nspin 8000] [--maxiter 7]

Spins the flow up for `nspin` steps, runs newton_fixed_point_iteration with
an unreachable tolerance (1e-6) for `maxiter` iterations, and prints one
JSON line: the spin-up's seconds and CG iterations per step, the |F|
history and GMRES matvecs per iteration, and at every iterate x (the start
included) the residual of the same map in float64 on the float64 mesh,
F64(x) (same inner tolerances) and F64_tight(x) (inner tolerances 1e-11),
and |F32(x) - F64(x)|, the part of the float32 |F| that is float32's.
Iterations 1-2 are those of chip_smoke.py phase 8, whose Newton stops at
the first iterate with |F32| < 2e-4. Norms are the mass-weighted L2 norm of
the velocity. Imports no jax.
"""

import argparse
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def cylinder(dtype, dev, tol):
    from neklab_tpu_torch.mesh.cylinder import annulus_mesh
    from neklab_tpu_torch.models.linearized import LinConfig
    from neklab_tpu_torch.models.navier_stokes import FlowConfig
    from neklab_tpu_torch.systems.fixed_point import FixedPointSystem

    mesh = annulus_mesh(8, 20, r_in=0.5, r_out=20.0, order=6, grading=1.5, outer_bc="vO",
                        shift=0.25, dtype=dtype, device=dev)
    fc = FlowConfig(viscosity=1 / 50, dt=5e-3, vtol=tol, ptol=tol)
    r = torch.sqrt(mesh.x[0] ** 2 + mesh.x[1] ** 2)
    free = (r > 0.5 + 1e-8).to(dtype)
    ub = torch.stack([free, torch.zeros_like(free)])
    system = FixedPointSystem(mesh, LinConfig(flow=fc), tau=0.5, ub=ub, dt=fc.dt)
    return mesh, fc, ub, r, system


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--nspin", type=int, default=8000)
    ap.add_argument("--maxiter", type=int, default=7)
    args = ap.parse_args()
    import neklab_tpu_torch  # noqa: F401  (sets the TF32 switches)
    from neklab_tpu_torch.analysis import newton_fixed_point_iteration
    from neklab_tpu_torch.models.navier_stokes import advance, initial_state
    from neklab_tpu_torch.models.precond import build_e_preconditioner
    from neklab_tpu_torch.ops import sem
    from neklab_tpu_torch.utils.timers import Counts
    from neklab_tpu_torch.vectors import flow_vector, flow_vector_space

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("newton_floor: no CUDA card (pass --device cpu for the CPU)")
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    mesh, fc, ub, r, system = cylinder(torch.float32, dev, 3e-6)
    ramp = 1 - torch.exp(-3.0 * (r - 0.5))
    st = initial_state(mesh, fc, u=mesh.vmask * torch.stack([ramp, 0 * ramp]) + (1 - mesh.vmask) * ub)
    stats = Counts()  # the counts alone: the spin-up runs untraced
    t0 = time.time()
    st = advance(mesh, fc, st, args.nspin, ub=ub, pc_e=build_e_preconditioner(mesh), stats=stats)
    sync()
    spin_s = time.time() - t0
    m64, *_, system64 = cylinder(torch.float64, dev, 3e-6)
    tight64 = cylinder(torch.float64, dev, 1e-11)[4]
    norm = lambda a: float(sem.mass_dot(m64, a, a).sqrt())
    at = {"F64": [], "F64_tight": [], "F32_minus_F64": []}

    def measure(x):
        """The float64 residuals at iterate x (outside Newton's clock)."""
        x64 = {k: v.double() for k, v in x.items()}
        f32 = system.response(x)["u"].double()
        f64 = system64.response(x64)["u"]
        at["F64"].append(norm(f64))
        at["F64_tight"].append(norm(tight64.response(x64)["u"]))
        at["F32_minus_F64"].append(norm(f32 - f64))

    x0 = flow_vector(mesh, 0, u=st.u)
    measure(x0)
    t0 = time.time()
    res = newton_fixed_point_iteration(system, x0, flow_vector_space(mesh, 0), tol=1e-6,
                                       maxiter=args.maxiter, gmres_kdim=30,
                                       callback=lambda it, x, rnorm: measure(x))
    newton_s = time.time() - t0  # the measurements included
    print(json.dumps({
        "device": torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu",
        "nspin": args.nspin, "spinup_s": spin_s,
        "spinup_cg_iters_per_step": {k: sum(v) / len(v) for k, v in stats.items()},
        "newton_history": res.history, "gmres_matvecs": res.matvecs, "newton_s": newton_s,
        **at,
    }), flush=True)


if __name__ == "__main__":
    main()
