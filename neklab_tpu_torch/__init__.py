"""neklab_tpu_torch: the PyTorch/CUDA port of neklab_tpu.

The modal-stability eigensolves, direct and adjoint (mesh -> SEM operators
-> BDF3/EXT3 linearized propagator -> Krylov-Schur eigs), transient growth,
the base flows they start from (the nonlinear BDF3/EXT3 stepper and
Newton-Krylov over a fixed-point system), resolvent analysis, the
wavenumber-projected propagator, periodic orbits with their Floquet
multipliers, and OTD mode evolution on torch tensors, on meshes the
package builds (box, annulus, backward-facing step) or reads (Nek5000
`.re2`, genbox `.box`), with the pressure preconditioner at any mesh size
and the 2-D local Helmholtz apply as a hand-written CUDA kernel for Hopper
(`ops/helmholtz_kernel.py`, `csrc/helmholtz2d.cu`). The JAX package
`neklab_tpu` is the reference the port is tested against; this package
imports torch, numpy and scipy, never jax.

The package exports every public name of `neklab_tpu/__init__.py` that
the port has, and a few of its own (`bfs_mesh`, `mesh_from_box`,
`mesh_from_re2`, `read_fld`/`write_fld`, OTD's file helpers). It leaves
out `set_precision` and `tensor.KRON3D` (switches of the TPU's matrix
unit: here f32 contractions are true f32, TF32 off) and the sharding
helpers, which wait for the multi-GPU slice. Importing it builds nothing
and does not touch CUDA: the kernel and the native library are built at
their first use.

Field layout is the reference's element-last `[..., s, r, nel]` at every
public function. The device is chosen once, by `box_mesh(..., device=)` (or
`annulus_mesh`, `bfs_mesh`, `mesh_from_box`, `mesh_from_re2`, `build_mesh`,
`mesh_from_arrays`), and every later tensor follows the mesh's device. It defaults to the current CUDA card; without a card the mesh
builders raise unless the caller passes `device="cpu"`.
"""

import torch

# True float32 everywhere: TF32 keeps ~10 mantissa bits, and the reference's
# OTD clean-gap oracle failed under reduced matmul precision and passed only
# once full-f32 contractions were forced. The Krylov Gram products and the
# preconditioner's batched solves are matmuls, so both switches stay off.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"

# Krylov layer
from .krylov import (AdjointOperator, EigsResult, FunctionOperator, GmresResult,  # noqa: E402
                     KrylovBasis, LinearOperator, NewtonResult, NonlinearSystem, SvdsResult,
                     VectorSpace, cg, constant_tol, dynamic_tol, euclidean_space, fgmres, svds)
from .krylov.eigs import eigs  # noqa: E402
from .krylov.gmres import gmres  # noqa: E402
from .krylov.newton import newton  # noqa: E402

# meshes
from .mesh.bfs import bfs_mesh  # noqa: E402
from .mesh.box import box_mesh  # noqa: E402
from .mesh.boxfile import mesh_from_box  # noqa: E402
from .mesh.core import SemMesh, build_mesh  # noqa: E402
from .mesh.cylinder import annulus_mesh  # noqa: E402
from .mesh.re2 import mesh_from_re2  # noqa: E402

# solvers, models
from .models.linearized import (LinConfig, PertState, adjoint_explicit_lin_map,  # noqa: E402
                                make_adjoint_propagator, pert_initial, propagate,
                                propagate_forced, step_lin)
from .models.navier_stokes import FlowConfig, FlowState, advance, initial_state, step  # noqa: E402
from .models.precond import build_e_preconditioner  # noqa: E402

# vectors
from .vectors import (ext_flow_vector, ext_flow_vector_space, flow_vector,  # noqa: E402
                      flow_vector_space, get_size, project_c0)

# linear operators and systems: the propagator, resolvent, the
# wavenumber-projected propagator, fixed points, periodic orbits (Floquet)
from .linops.exponential_propagator import ExponentialPropagator  # noqa: E402
from .linops.projected import ProjectedPropagator  # noqa: E402
from .linops.resolvent import Resolvent, complex_pair_space  # noqa: E402
from .systems.fixed_point import FixedPointSystem  # noqa: E402
from .systems.periodic_orbit import MonodromyOperator, PeriodicOrbitSystem  # noqa: E402

# OTD
from .otd import (OtdOpts, OtdResult, apply_l, load_otd_ics, load_otd_restart,  # noqa: E402
                  orthonormalize_states, otd_analysis, otd_chunk, outpost_otd_modes,
                  save_otd_restart)

# analysis drivers
from .analysis import (NewtonFPResult, StabilityResult, TransientGrowthResult,  # noqa: E402
                       linear_stability_analysis_fixed_point, newton_fixed_point_iteration,
                       transient_growth_analysis_fixed_point)

# utilities
from .utils.fldfile import read_fld, write_fld  # noqa: E402
from .utils.orr_sommerfeld import orr_sommerfeld_spectrum, shear_mode_eigenvalues  # noqa: E402
from .utils.parfile import ParCase, load_par  # noqa: E402
from .utils.timers import timer  # noqa: E402
from .utils.timestep import cfl_dt, horizon_steps  # noqa: E402
