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
    1 and 4, K 1 and 4, buckets 512 and 1024, bf16 and fp32, rows on the
    garbage line and blocks of 64 query rows (K 16 and 8 at D 128), each
    case bit-identical over two more launches; B9 at Llama-3.2-1B's MLP and
    widths no tile divides, 1 to 80 rows, silu and the tanh gelu, bf16 and
    fp32, each case bit-identical over two more launches. Each case checks
    that its kernel launched once."""
    sys.path.insert(0, REPO)
    import chip_smoke
    from neuronx_distributed_inference_tpu_torch.ops import decode_block as db

    n_attn, n_mlp = chip_smoke.phase_fused_parity(torch, db)
    assert n_attn == 2 * 2 * 2 * 2 * len(chip_smoke.FUSED_ATTN_SHAPES) + 4 + 2 * 2 * len(chip_smoke.FUSED_FULL_ROWS)
    assert n_mlp == 2 * 2 * len(chip_smoke.FUSED_MLP_ROWS) * len(chip_smoke.FUSED_MLP_SHAPES)


# ---------------------------------------------------------------------------
# CUDA graphs: one captured graph per runner key against the same programs
# run eagerly (cuda_graphs=False), at a tiny head_dim-64 Llama in bf16
# ---------------------------------------------------------------------------

TINY = dict(
    model_type="llama", hidden_size=256, intermediate_size=512, num_attention_heads=4,
    num_key_value_heads=2, num_hidden_layers=2, vocab_size=256, rms_norm_eps=1e-5,
    rope_theta=10000.0, max_position_embeddings=512, hidden_act="silu", tie_word_embeddings=False,
)


def _tiny_app(params=None, **tc):
    from neuronx_distributed_inference_tpu_torch.config import Config
    from neuronx_distributed_inference_tpu_torch.models.llama import LlamaInferenceConfig
    from neuronx_distributed_inference_tpu_torch.runtime.application import ModelForCausalLM

    base = dict(
        batch_size=2, seq_len=256, dtype="bfloat16", context_encoding_buckets=[32, 64],
        token_generation_buckets=[128, 256], fused_qkv=True, device="cuda",
    )
    cfg = LlamaInferenceConfig(Config(**{**base, **tc}), load_config=lambda c: [setattr(c, k, v) for k, v in TINY.items()])
    app = ModelForCausalLM(None, cfg)
    if params is not None:
        return app.load(params=params)
    torch.manual_seed(0)
    return app.load(random_weights=True)


def _pair(**tc):
    """(eager app, graph app) over the same weights, both warmed."""
    eager = _tiny_app(cuda_graphs=False, **tc).warmup()
    graph = _tiny_app(params=eager.params, cuda_graphs=True, **tc).warmup()
    assert not eager.graphs.enabled and graph.graphs.enabled and graph.graphs.captures > 0
    return eager, graph


def _counted(fn):
    from neuronx_distributed_inference_tpu_torch.ops import _cuda

    _cuda.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, {**_cuda.launch_counts(), **_cuda.route_counts()}


PROMPTS = [[5, 17, 92, 41, 33, 88, 2, 11, 7, 200, 13, 14], [64, 3, 27, 9]]


def _prompt_batch():
    import numpy as np

    ids = np.zeros((2, 12), np.int64)
    mask = np.zeros((2, 12), np.int64)
    for i, p in enumerate(PROMPTS):
        ids[i, : len(p)] = p
        mask[i, : len(p)] = 1
    return ids, mask


@pytest.mark.gpu
@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused_layer"])
def test_graphs_match_eager_generate(cuda_card, fused):
    """generate() (no EOS: chunks across both decode buckets; EOS: 8-step
    chunks) through captured graphs: byte-identical greedy tokens and equal
    launch counts; sealed after warmup, the steady state captures nothing."""
    import numpy as np

    from neuronx_distributed_inference_tpu_torch.analysis.retrace_guard import RetraceGuard

    kw = dict(fused_attn_block_kernel_enabled=True, fused_mlp_kernel_enabled=True) if fused else {}
    eager, graph = _pair(retrace_guard=True, **kw)
    ids, mask = _prompt_batch()
    for call in (dict(max_new_tokens=150), dict(max_new_tokens=40, eos_token_id=int(PROMPTS[0][3]))):
        want, want_counts = _counted(lambda: eager.generate(ids, mask, **call))
        with RetraceGuard():
            got, got_counts = _counted(lambda: graph.generate(ids, mask, **call))
        np.testing.assert_array_equal(got.sequences, want.sequences)
        assert got_counts == want_counts, (got_counts, want_counts)
        assert sum(got_counts.values()) > 0
    assert graph.token_generation_model.sealed


@pytest.mark.gpu
def test_graphs_sampled_generate_draws_afresh(cuda_card):
    """A sampling program registers the app's generator with its graph: the
    same seed repeats a run, a second generate() call draws anew, and the
    draws stay inside the top-k window (top_k=1 is the greedy run)."""
    import numpy as np

    ods = dict(do_sample=True, top_k=50)
    eager, graph = _pair(on_device_sampling_config=ods)
    twin = _tiny_app(params=eager.params, on_device_sampling_config=ods).warmup()
    ids, mask = _prompt_batch()
    kw = dict(max_new_tokens=60, top_k=50, top_p=0.95, temperature=1.0)
    first = graph.generate(ids, mask, **kw).sequences
    np.testing.assert_array_equal(twin.generate(ids, mask, **kw).sequences, first)
    second = graph.generate(ids, mask, **kw).sequences
    assert (second != first).any()
    greedy = eager.generate(ids, mask, max_new_tokens=60, top_k=1).sequences
    np.testing.assert_array_equal(graph.generate(ids, mask, max_new_tokens=60, top_k=1).sequences, greedy)


@pytest.mark.gpu
def test_graphs_match_eager_windowed_generate(cuda_card):
    """A prompt longer than max_context_length: window 0 through a context
    graph, later windows through (window, bucket) graphs."""
    import numpy as np

    eager, graph = _pair(max_context_length=64, batch_size=1)
    ids = np.random.RandomState(2).randint(1, 256, size=(1, 150))
    want, want_counts = _counted(lambda: eager.generate(ids, max_new_tokens=40))
    got, got_counts = _counted(lambda: graph.generate(ids, max_new_tokens=40))
    np.testing.assert_array_equal(got.sequences, want.sequences)
    assert got_counts == want_counts


def _serve(app, prompts, gen=24):
    from neuronx_distributed_inference_tpu_torch.runtime.serving import ServingSession

    sess = ServingSession(app)
    waiting = list(enumerate(prompts))
    while waiting or sess.active or sess._readmit:
        # a request joins as soon as a slot is free, mid-drain included
        while waiting and sess.free_slots:
            i, p = waiting.pop(0)
            assert sess.add_request(f"r{i}", p, max_new_tokens=gen + i)
        sess.step()
    return {rid: list(r.generated) for rid, r in sess.requests.items()}


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["split_sync", "split_1ahead", "ragged_sync", "ragged_1ahead"])
def test_graphs_match_eager_serving(cuda_card, mode):
    """A paged chunked-prefill session, split or ragged, synchronous or
    1-ahead: byte-identical tokens and equal launch counts through graphs
    (the 1-ahead step reads the pending step's tokens after the next
    replay)."""
    import numpy as np

    kw = dict(
        is_continuous_batching=True, batch_size=4, is_block_kv_layout=True, pa_block_size=16,
        pa_num_blocks=96, is_chunked_prefill=True, chunked_prefill_config=dict(max_num_seqs=2, kernel_q_tile_size=32),
        async_mode=mode.endswith("1ahead"), serving_ragged=mode.startswith("ragged"),
    )
    eager, graph = _pair(**kw)
    rng = np.random.RandomState(5)
    prompts = [rng.randint(1, 256, size=n).tolist() for n in (40, 9, 77, 20, 33, 5)]
    want, want_counts = _counted(lambda: _serve(eager, prompts))
    got, got_counts = _counted(lambda: _serve(graph, prompts))
    assert got == want
    assert got_counts == want_counts
