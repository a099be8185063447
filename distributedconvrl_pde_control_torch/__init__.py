"""PyTorch / CUDA port of distributedconvrl_pde_control_tpu for one NVIDIA H100.

The JAX package beside this one is the reference; every module here mirrors
the name of its counterpart there. This package imports torch and numpy and
never JAX nor anything of the JAX package.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``. On a
CUDA tensor each kernel wrapper launches its hand-written kernel; on a CPU
tensor it runs the kernel's plain PyTorch version.
"""

import torch

# The JAX reference runs its contractions at Precision.HIGHEST, so float32
# matrix products and convolutions stay in full float32 here (no TF32).
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
