"""The exponential propagator exp(tau A) of the Boussinesq equations (one
temperature, the buoyancy Ra Pr theta along y) linearized about the
configuration's base state: the program's `ExponentialPropagator` with
nscal = 1 and its `lin_forcing_fn`, and the plain reference's
`boussinesq.Propagator`.

The benchmark's vectors carry the temperature as the last component of
"u" ([ndim + 1, pts..., nel]; their "theta" is empty), so that the
harness's start vector, records, inner product and check take it whole
beside the velocity. The operator it drives (`Fold`) does nothing but the
fold: the slices of "u" in, the program's {"u", "theta"} out as one
`torch.cat`. The base state comes the same way: U, then Theta.
"""

import torch

from reference import boussinesq, flow


def buoyancy(ra_pr: float, mesh):
    """lin_forcing_fn(mesh, u, theta) = (0, ra_pr theta, 0): the buoyancy
    along y, one product a call."""
    up = torch.zeros(mesh.ndim, dtype=mesh.dtype, device=mesh.device)
    up[1] = ra_pr
    up = up.reshape((mesh.ndim,) + (1,) * mesh.bm1.dim())
    return lambda m, u, theta: up * theta[0]


class Fold:
    """The program's propagator `op` on the benchmark's vectors."""

    def __init__(self, op):
        self.op, self.tau, self.nsteps, self.dt = op, op.tau, op.nsteps, op.dt
        self.ndim = op.mesh.ndim

    def matvec(self, x: dict, stats: dict | None = None) -> dict:
        u = x["u"]
        y = self.op.matvec({"u": u[: self.ndim], "theta": u[self.ndim:]}, stats=stats)
        return {"u": torch.cat([y["u"], y["theta"]]), "theta": x["theta"]}


def program(mesh, cfg: dict, base_u, args: dict):
    from neklab_tpu_torch import ExponentialPropagator, FlowConfig, LinConfig

    flow_cfg = FlowConfig(viscosity=cfg["viscosity"], dt=cfg["dt"], nscal=1,
                          conductivity=(cfg["conductivity"],), vtol=cfg["vtol"], ptol=cfg["ptol"],
                          ttol=cfg["ttol"], vmaxit=cfg["vmaxit"], pmaxit=cfg["pmaxit"])
    lin_cfg = LinConfig(flow=flow_cfg,
                        lin_forcing_fn=buoyancy(cfg["rayleigh"] * cfg["prandtl"], mesh))
    nd = mesh.ndim
    op = ExponentialPropagator(mesh, lin_cfg, base_u[:nd], base_u[nd:], tau=cfg["tau"],
                               dt=cfg["dt"], **args)
    return Fold(op)


def counters(op, calls) -> dict:
    return {}


def time_steps_per_call(op) -> int:
    return op.nsteps


def apply_shape(op, cfg: dict) -> tuple[float, float]:
    """(h1, h2) of the BDF3 velocity solve."""
    return cfg["viscosity"], flow.BDF[3][0] / op.dt


def reference(rmesh, base_np, cfg: dict, dt=None):
    spec = cfg["mesh"]
    tmask = boussinesq.temperature_mask(rmesh.x_host, spec["lims"], spec["bc_temp"])
    return boussinesq.Propagator(rmesh, base_np, tmask, cfg["viscosity"], cfg["conductivity"],
                                 cfg["rayleigh"] * cfg["prandtl"], cfg["tau"],
                                 cfg["dt"] if dt is None else dt, cfg["vtol"], cfg["ptol"],
                                 cfg["ttol"], cfg["vmaxit"], cfg["pmaxit"])


def theta(mesh, dtype, device):
    """The (empty) scalar field of a vector of the benchmark's space."""
    return torch.zeros((0,) + tuple(mesh.bm1.shape), dtype=dtype, device=device)
