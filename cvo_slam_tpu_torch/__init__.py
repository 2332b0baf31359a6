"""PyTorch/CUDA port of cvo_slam_tpu: RGB-D CVO-SLAM on an NVIDIA GPU.

Tracking plus the SLAM backend (keyframe graph, ORB + BoW loop closure,
windowed and final bundle adjustment). Plain tensor code is PyTorch; the
pairwise passes of the align loop, of compute_innerproduct and of the
loop-closure scoring are hand-written CUDA kernels (cvo/kernels.py, csrc/).
Entry points default to device="cuda" and raise if CUDA is absent.
"""

__version__ = "0.1.0"

# SLAM numerics need true f32 products: TF32 (10-bit mantissa) flips
# borderline kernel-threshold gates and degrades the flow integration.
import torch as _torch

_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")
