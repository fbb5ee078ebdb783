"""legoloam_tpu_torch — the LeGO-LOAM SLAM engine in PyTorch and CUDA.

The PyTorch port of ``legoloam_tpu`` (the JAX package beside it, which stays
the reference).  Same layout and function names:

  * ``ops/``    — per-scan operators: projection, segmentation, features,
                  voxel/NN search, small linear algebra, and the four
                  hand-written CUDA kernels (``ccl_cuda``, ``features_cuda``,
                  ``knn_cuda``, ``class_nn_cuda``) with their plain PyTorch
                  versions.
  * ``models/`` — odometry, scan-to-map mapping, fusion, the pipeline.
  * ``utils/``  — synthetic worlds, trajectory metrics, state interchange
                  with the JAX package, scan and IMU files, checkpoints,
                  map and trajectory export, debug dumps, stage timing,
                  memory accounting.
  * ``evals/``  — the kidnap and loop-recovery evaluations.
  * ``cli.py``  — ``python -m legoloam_tpu_torch``.
  * ``csrc/``   — CUDA C++ sources, built with nvcc at first use, and the
                  scan loader ``legoio.cpp``, built with g++.

Entry points run on the CUDA device unless the caller passes a CPU device;
on a CPU tensor every kernel wrapper takes its plain PyTorch version.
"""

import torch as _torch

# Geometry needs true float32 products: TF32 keeps ~10 mantissa bits, which
# at 70 m world coordinates is centimetres of error per transformed point —
# the same class of fault as bfloat16 matrix-unit truncation.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

from . import config                                              # noqa: E402
from .config import DEFAULT, PipelineConfig, SensorConfig         # noqa: E402
from .device import resolve_device                                # noqa: E402

__version__ = "0.1.0"
__all__ = ["config", "DEFAULT", "PipelineConfig", "SensorConfig",
           "resolve_device"]
