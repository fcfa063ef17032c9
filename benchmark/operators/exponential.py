"""The exponential propagator exp(tau A) of the flow linearized about the
configuration's base flow: the program's `ExponentialPropagator` and the
plain reference's `flow.Propagator`.

An operator is found by the name in a traffic mix's `operator`: `program`
builds the program's operator (with the mix's `operator_args` passed on,
such as `recycle`) and the counters it keeps, `reference` the plain
reference's at the same dt, `time_steps_per_call` the time steps of one
call, `apply_shape` the velocity solve's Helmholtz coefficients for the
roofline.
"""

import torch

from reference import flow


def program(mesh, cfg: dict, base_u, args: dict):
    from neklab_tpu_torch import ExponentialPropagator, FlowConfig, LinConfig

    flow_cfg = FlowConfig(viscosity=cfg["viscosity"], dt=cfg["tau"], vtol=cfg["vtol"],
                          ptol=cfg["ptol"], vmaxit=cfg["vmaxit"], pmaxit=cfg["pmaxit"])
    op = ExponentialPropagator(mesh, LinConfig(flow=flow_cfg), base_u, tau=cfg["tau"],
                               cfl=cfg["cfl"], **args)
    return op


def counters(op, calls) -> dict:
    """The program's own counts of what it holds: the adjoint's tape, once
    an rmatvec has recorded it."""
    return {"tape_bytes": op.adjoint.tape_bytes} if "rmatvec" in calls else {}


def time_steps_per_call(op) -> int:
    return op.nsteps


def apply_shape(op, cfg: dict) -> tuple[float, float]:
    """(h1, h2) of the BDF3 velocity solve."""
    return cfg["viscosity"], flow.BDF[3][0] / op.dt


def reference(rmesh, base_np, cfg: dict, dt=None):
    return flow.Propagator(rmesh, base_np, cfg["viscosity"], cfg["tau"], cfg["vtol"],
                           cfg["ptol"], cfg["vmaxit"], cfg["pmaxit"], dt=dt)


def theta(mesh, dtype, device):
    """The (empty) scalar field of a vector of this operator's space."""
    return torch.zeros((0,) + tuple(mesh.bm1.shape), dtype=dtype, device=device)
