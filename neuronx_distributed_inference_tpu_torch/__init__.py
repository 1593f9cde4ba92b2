"""PyTorch/CUDA port of the inference framework, for one NVIDIA H100.

Counterpart of ``neuronx_distributed_inference_tpu`` (the JAX/Pallas
package, which stays the reference). This package imports ``torch`` and
numpy only — never jax, never the JAX package. Every Pallas kernel on the
ported path is a CUDA C++ kernel for ``sm_90a`` under ``csrc/``, built with
``nvcc`` at first use (``ops/_cuda.py``) and held against its plain PyTorch
version (in the same module) by ``chip_smoke.py`` at the repo root.

Entry points run on the card unless the caller passes ``device="cpu"``.
"""

import torch as _torch

__version__ = "0.1.0"

# float32 reference math must stay float32 on the card: TF32 keeps ~3
# decimal digits and would make the plain versions disagree with the
# kernels (and with the JAX reference) by far more than fp32 tolerance
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
