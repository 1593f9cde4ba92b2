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
    chip_smoke.phase_decode_split_parity(torch, da)  # B1's kv split, bit-identical twice
    chip_smoke.phase_flash_layout_parity(torch, fa)  # B2: odd lengths, D=128 fused-QKV views
    n_paged, n_paged_split = chip_smoke.phase_paged_decode_parity(torch, da)  # B4, its split bit-identical twice
    chip_smoke.phase_paged_flash_parity(torch, pf)
    chip_smoke.phase_ragged_parity(torch, rp)
    counts = _cuda.launch_counts()
    assert counts["paged_decode_attention"] == n_paged + 3 * n_paged_split, counts
    attention = ("flash_attention", "decode_attention", "paged_decode_attention", "paged_flash_attention",
                 "ragged_paged_attention")
    assert all(counts[name] > 0 for name in attention), counts


@pytest.mark.gpu
def test_quant_matmul_matches_plain_on_the_card(cuda_card):
    """B6 against its plain version at rows 1 to 64 (chip_smoke.QMM_PARITY_ROWS),
    bf16 and fp32, every int4 projection of the 8B and 1B rows and a padded
    K with a ragged N; each case launches once for the check and twice for
    the bit-identical repeat."""
    sys.path.insert(0, REPO)
    import chip_smoke
    from neuronx_distributed_inference_tpu_torch.ops import _cuda
    from neuronx_distributed_inference_tpu_torch.ops import quant_matmul as qmm

    _cuda.reset_launch_counts()
    n = chip_smoke.phase_quant_matmul_parity(torch, qmm)
    assert n == len(chip_smoke.QMM_PARITY_ROWS) * 2 * len(chip_smoke.qmm_shapes())
    assert _cuda.launch_counts()["quant_matmul"] == 3 * n


@pytest.mark.gpu
def test_moe_decode_matches_plain_on_the_card(cuda_card):
    """B7 against its plain version: Qwen3-30B-A3B widths at 1, 2 and 8
    tokens (64 rows), Mixtral-8x7B widths at 1 and 4, widths no tile
    divides, bf16 and fp32, silu and the clamped swiglu. Each case checks
    that B7 launched once (its plain runs reset the counts)."""
    sys.path.insert(0, REPO)
    import chip_smoke
    from neuronx_distributed_inference_tpu_torch.ops import moe_decode as md

    n = chip_smoke.phase_moe_parity(torch, md)
    assert n == 2 * len(chip_smoke.MOE_GLUS) * len(chip_smoke.moe_cases())


@pytest.mark.gpu
def test_fused_blocks_match_plain_on_the_card(cuda_card):
    """B8 against its plain version at D 64 and 128, GQA 4:1 and 8:1, batch
    1 and 4, K 1 and 4, buckets 512 and 1024, bf16 and fp32, and rows on the
    garbage line; B9 at Llama-3.2-1B's MLP and widths no tile divides, silu
    and the tanh gelu. Each case checks that its kernel launched once."""
    sys.path.insert(0, REPO)
    import chip_smoke
    from neuronx_distributed_inference_tpu_torch.ops import decode_block as db

    n_attn, n_mlp = chip_smoke.phase_fused_parity(torch, db)
    assert n_attn == 2 * 2 * 2 * 2 * len(chip_smoke.FUSED_ATTN_SHAPES) + 4
    assert n_mlp == 2 * 2 * 2 * 2 * len(chip_smoke.FUSED_MLP_SHAPES)
