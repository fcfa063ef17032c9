"""The benchmark's yardstick: the plain reference (mesh, flow, krylov), the
comparison that decides `correct` (check), the analytic base flows
(baseflow) and the fixed arithmetic of peaks, counts and traces
(yardstick). Plain numpy and torch; imports nothing of the program."""

import torch

# true float32 contractions: TF32 would be a lower precision than the one
# a configuration states
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
