"""PyTorch/CUDA port of cvo_slam_tpu: RGB-D CVO tracking on an NVIDIA GPU.

Plain tensor code is PyTorch; the two pairwise passes of the align loop and
of compute_innerproduct are hand-written CUDA kernels (cvo/kernels.py,
csrc/). Entry points default to device="cuda" and raise if CUDA is absent.
"""

__version__ = "0.1.0"

# SLAM numerics need true f32 products: TF32 (10-bit mantissa) flips
# borderline kernel-threshold gates and degrades the flow integration.
import torch as _torch

_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")
