"""The port's kernels against their plain versions on a CUDA card, through
the same phases ``chip_smoke.py`` runs (one place holds the cases and the
tolerances). The file imports neither jax nor the JAX package, so it runs on
a host with the card and no jax:
``python -m pytest --noconftest -m gpu tests/test_torch_gpu.py``.
Without a card each test skips."""

import os
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels run only on the card (python3 chip_smoke.py)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_kernels_match_plain_on_the_card(cuda_card):
    sys.path.insert(0, REPO)
    import chip_smoke
    from neuronx_distributed_inference_tpu_torch.ops import _cuda
    from neuronx_distributed_inference_tpu_torch.ops import decode_attention as da
    from neuronx_distributed_inference_tpu_torch.ops import flash_attention as fa
    from neuronx_distributed_inference_tpu_torch.ops import paged_flash_attention as pf
    from neuronx_distributed_inference_tpu_torch.ops import ragged_paged_attention as rp

    _cuda.reset_launch_counts()
    chip_smoke.phase_flash_parity(torch, fa)
    chip_smoke.phase_decode_parity(torch, da)
    chip_smoke.phase_paged_decode_parity(torch, da)
    chip_smoke.phase_paged_flash_parity(torch, pf)
    chip_smoke.phase_ragged_parity(torch, rp)
    counts = _cuda.launch_counts()
    assert all(counts[name] > 0 for name in _cuda.KERNELS), counts
