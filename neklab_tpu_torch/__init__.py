"""neklab_tpu_torch: the PyTorch/CUDA port of neklab_tpu.

The modal-stability eigensolves, direct and adjoint (mesh -> SEM operators
-> BDF3/EXT3 linearized propagator -> Krylov-Schur eigs), transient growth,
and the base flows they start from (the nonlinear BDF3/EXT3 stepper and
Newton-Krylov over a fixed-point system) on torch tensors, with the 2-D
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
