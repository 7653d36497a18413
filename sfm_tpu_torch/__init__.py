"""sfm_tpu_torch: PyTorch / CUDA port of the sfm_tpu visual-odometry engine.

Same layout and names as the JAX package `sfm_tpu` (config, ops, models,
utils), so a reader finds each counterpart. Plain tensor code is PyTorch; the
kernels the JAX package wrote in Pallas are hand-written CUDA C++ under
`csrc/`, bound in `ops/cuda_kernels.py`.

Entry points run on the GPU unless the caller asks for `device="cpu"`.
"""

import torch

# f32-faithful geometry: pixel coordinates do not survive TF32's 10-bit
# mantissa and Gauss-Newton stalls on truncated normal equations. The
# counterpart of the JAX package's "highest" matmul precision pin.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
