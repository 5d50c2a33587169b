"""rlcf_torch: the RLCF test-time-adaptation system in PyTorch, for NVIDIA Hopper.

The package mirrors ``rlcf_tpu``'s module layout (``models/clip.py`` here is
the counterpart of ``rlcf_tpu/models/clip.py``, and so on) and keeps its
public layouts: linear weights ``[in, out]``, transformer blocks stacked on a
leading layer axis, patch-major tokens ``[B, T, p*p*3]``, NHWC images. It
imports neither JAX nor the JAX package.

Entry points run on ``cuda`` unless the caller asks for ``cpu``; on a CUDA
tensor every hand-written kernel either launches or raises.
"""

import torch

# Float32 matmuls and convolutions run in full float32, never TF32: cuDNN
# convolutions default to TF32 (about three decimal digits), which would put
# the port's float32 path outside the reference's tolerances.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
