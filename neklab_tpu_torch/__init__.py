"""neklab_tpu_torch: the PyTorch/CUDA port of neklab_tpu.

The modal-stability eigensolves, direct and adjoint (mesh -> SEM operators
-> BDF3/EXT3 linearized propagator -> Krylov-Schur eigs), transient growth,
the base flows they start from (the nonlinear BDF3/EXT3 stepper and
Newton-Krylov over a fixed-point system), resolvent analysis, the
wavenumber-projected propagator, periodic orbits with their Floquet
multipliers, and OTD mode evolution on torch tensors, with the 2-D
local Helmholtz apply as a hand-written CUDA kernel for Hopper
(`ops/helmholtz_kernel.py`, `csrc/helmholtz2d.cu`). The JAX package
`neklab_tpu` is the reference the port is tested against; this package
imports torch, numpy and scipy, never jax.

Field layout is the reference's element-last `[..., s, r, nel]` at every
public function. The device is chosen once, by `box_mesh(..., device=)` (or
`annulus_mesh`, `build_mesh`, `mesh_from_arrays`), and every later tensor
follows the mesh's
device. It defaults to the current CUDA card; without a card the mesh
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

# resolvent, wavenumber-projected stability, periodic orbits (Floquet), OTD
from .linops.projected import ProjectedPropagator  # noqa: E402
from .linops.resolvent import Resolvent, complex_pair_space  # noqa: E402
from .models.linearized import adjoint_explicit_lin_map, propagate_forced  # noqa: E402
from .otd import (OtdOpts, OtdResult, apply_l, load_otd_ics, load_otd_restart,  # noqa: E402
                  orthonormalize_states, otd_analysis, otd_chunk, outpost_otd_modes,
                  save_otd_restart)
from .systems.periodic_orbit import MonodromyOperator, PeriodicOrbitSystem  # noqa: E402
from .utils.fldfile import read_fld, write_fld  # noqa: E402
from .vectors import ext_flow_vector, ext_flow_vector_space, get_size  # noqa: E402
