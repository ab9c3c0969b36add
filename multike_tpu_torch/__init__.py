"""MultiKE in PyTorch for NVIDIA Hopper (H100).

The JAX package ``multike_tpu`` is the reference; this package mirrors its
layout module for module. Its two hand-written CUDA kernels live in
``csrc/`` and are built at first use into ``build/`` (see
``kernels/_build.py``).

Precision: the reference pins every float32 matmul to full precision
(``Precision.HIGHEST`` in losses.py and the rank kernel), so TF32 is turned
off for cuBLAS and cuDNN on import.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"

from multike_tpu_torch.config import Config, load_config  # noqa: F401,E402
