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
    # the 2 Qwen3 head-shape cases among n_paged repeat their launch twice
    assert counts["paged_decode_attention"] == n_paged + 2 * 2 + 3 * n_paged_split, counts
    attention = ("flash_attention", "decode_attention", "paged_decode_attention", "paged_flash_attention",
                 "ragged_paged_attention")
    assert all(counts[name] > 0 for name in attention), counts


@pytest.mark.gpu
def test_qwen3_int4_projections_and_quantized_experts_on_the_card(cuda_card):
    """B6 at Qwen3-30B-A3B's 2D int4 projections (fused QKV 2048 -> 5120,
    o 4096 -> 2048, lm head 2048 -> 151936) at 1 and 8 rows, bf16 and fp32,
    against its plain version, each case launched twice more,
    bit-identical (chip_smoke.qwen3_qmm_parity); and modules/moe.moe_layer
    on int8 (per channel, per tensor, blockwise), fp8 and grouped int4
    experts on the card against the same call on the CPU, fp32, on the
    dense, grouped and capacity routes, the same route counted on both and
    no kernel launched (chip_smoke.quant_moe_parity)."""
    sys.path.insert(0, REPO)
    import chip_smoke
    from neuronx_distributed_inference_tpu_torch.ops import _cuda
    from neuronx_distributed_inference_tpu_torch.ops import quant_matmul as qmm

    _cuda.reset_launch_counts()
    n = chip_smoke.qwen3_qmm_parity(torch, qmm)
    assert n == len(chip_smoke.QWEN3_QMM_SHAPES) * len(chip_smoke.QWEN3_QMM_ROWS) * 2
    assert _cuda.launch_counts()["quant_matmul"] == 3 * n
    assert chip_smoke.quant_moe_parity(torch) == 14


@pytest.mark.gpu
def test_qwen3_head_shape_kernels_match_plain_on_the_card(cuda_card):
    """B4, B5 and B3 at Qwen3-30B-A3B's head shape (32 q / 4 kv heads of
    128, n_rep 8, blocks of 32, bf16) against their plain versions: B4 at
    batch 1 and the serving decode step's 8 rows, B5 on the 128-token
    chunk at batch 1 and 8, B3 at the serving row's three points, the last
    two on random and exact-score inputs and each launched twice more,
    bit-identical (chip_smoke.qwen3_*_parity; B4's check launches it once
    and its repeat twice)."""
    sys.path.insert(0, REPO)
    import chip_smoke
    from neuronx_distributed_inference_tpu_torch.ops import _cuda
    from neuronx_distributed_inference_tpu_torch.ops import decode_attention as da
    from neuronx_distributed_inference_tpu_torch.ops import paged_flash_attention as pf
    from neuronx_distributed_inference_tpu_torch.ops import ragged_paged_attention as rp

    _cuda.reset_launch_counts()
    n_b4 = chip_smoke.qwen3_paged_decode_parity(torch, da)
    n_b5 = chip_smoke.qwen3_paged_flash_parity(torch, pf)
    n_b3 = chip_smoke.qwen3_ragged_parity(torch, rp)
    assert (n_b4, n_b5, n_b3) == (2, 4, 6)
    counts = _cuda.launch_counts()
    assert counts["paged_decode_attention"] == 3 * n_b4, counts
    assert counts["paged_flash_attention"] == 3 * n_b5, counts
    assert counts["ragged_paged_attention"] == 3 * n_b3, counts


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


# ---------------------------------------------------------------------------
# the quantized KV cache: the code modes of B1, B4, B5 and B3
# ---------------------------------------------------------------------------


@pytest.mark.gpu
def test_kv_code_modes_match_plain_on_the_card(cuda_card):
    """Each code mode (int8, e4m3, e5m2) against its plain version in fp32
    on the same codes and scales (chip_smoke.phase_kvq_parity): B1 at the 1B
    shape, buckets 512 and 8704, batch 1 and 4, q_len 1 and 4, at 16896,
    and at Qwen3's; B4 at blocks of 32 and 16; B1 and B4 with an fp32 q at
    four shapes each; B5 and B3 at D 64 and 128, blocks of 16 and 32, bf16
    (random and exact-score inputs) and fp32 q, B3 with several live decode
    splits, then at both RAGGED_POINTS. Each case launches its code mode
    three times (the check and two bit-identical repeats) and no other
    kernel."""
    sys.path.insert(0, REPO)
    import chip_smoke
    from neuronx_distributed_inference_tpu_torch.ops import _cuda
    from neuronx_distributed_inference_tpu_torch.ops import decode_attention as da
    from neuronx_distributed_inference_tpu_torch.ops import paged_flash_attention as pf
    from neuronx_distributed_inference_tpu_torch.ops import ragged_paged_attention as rp

    _cuda.reset_launch_counts()
    n = chip_smoke.phase_kvq_parity(torch, da, pf, rp)
    counts = _cuda.launch_counts()
    per_code = {"decode_attention_codes": 14, "paged_decode_attention_codes": 6, "paged_flash_attention_codes": 12,
                "ragged_paged_attention_codes": 18}
    assert n == 3 * sum(per_code.values())
    want = {name: 3 * k * 3 for name, k in per_code.items()}
    assert {name: counts[name] for name in want} == want, counts
    assert all(counts[name] == 0 for name in counts if name not in want), counts


@pytest.mark.gpu
@pytest.mark.parametrize("code", ["int8", "float8_e4m3fn", "float8_e5m2"])
def test_b5_b3_code_modes_are_one_launch(cuda_card, code):
    """A bf16-q code-mode call of B5 (8 x 128 new tokens after a 64-token
    prefix) and of B3 (the serving row's mixed point: a chunk and split
    decode rows), given the layer's running scales and qmax as the model
    passes them, agrees with its plain version on the card
    (chip_smoke.check_paged_flash / check_ragged), and under torch.profiler
    it is exactly its kernel's one launch (B3's split combine included): no
    fold, rescale or factor division runs around it."""
    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, REPO)
    import chip_smoke
    import numpy as np
    from neuronx_distributed_inference_tpu_torch.ops import paged_flash_attention as pf
    from neuronx_distributed_inference_tpu_torch.ops import ragged_paged_attention as rp
    from neuronx_distributed_inference_tpu_torch.ops.roofline import RAGGED_POINTS

    rng = np.random.RandomState(21)
    q, kc, vc, bt, pos, lim, codes, factors = chip_smoke.kvq_chunk_case(torch, rng, code)
    kw = dict(scale=0.125, n_rep=4)
    chip_smoke.check_paged_flash(torch, pf, q, kc, vc, bt, pos, lim, kw, f"{code} one launch", False, codes, factors)
    pt = RAGGED_POINTS["mixed"]
    inputs, rcodes, rfactors = chip_smoke.kvq_ragged_case(torch, rng, code, pt["row_len"], pt["ctx_len"],
                                                          pt["block_size"], pt["width"])
    chip_smoke.check_ragged(torch, rp, inputs, f"{code} one launch", chip_smoke.DECODE_ATOL, False, rcodes, rfactors)
    qr, kr, vr, table, rs, rl, cl, _ = inputs
    calls = {
        "paged_flash_mma": lambda: pf.paged_flash_attention(q, kc, vc, bt, pos, lim, **codes, **kw),
        "ragged_bf16_kernel": lambda: rp.ragged_paged_attention(qr, kr, vr, table, rs, rl, cl, **rcodes, **kw),
    }
    for kernel, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        assert len(names) == 1 and kernel in names[0], names


@pytest.mark.gpu
def test_long_context_shapes_match_plain_on_the_card(cuda_card):
    """The bf16 twins' kernels at the long-context rows' shapes
    (chip_smoke.phase_long_context_parity): B1's bf16 mode at buckets 8704
    and 16896 and B2 at 8192- and 16384-token prompts against their plain
    versions, each launched three times."""
    sys.path.insert(0, REPO)
    import chip_smoke
    from neuronx_distributed_inference_tpu_torch.ops import _cuda
    from neuronx_distributed_inference_tpu_torch.ops import decode_attention as da
    from neuronx_distributed_inference_tpu_torch.ops import flash_attention as fa

    _cuda.reset_launch_counts()
    assert chip_smoke.phase_long_context_parity(torch, da, fa) == 4
    counts = _cuda.launch_counts()
    assert {n: c for n, c in counts.items() if c} == {"decode_attention": 6, "flash_attention": 6}, counts


@pytest.mark.gpu
def test_kv_codes_on_the_card_match_the_cpu(cuda_card):
    """The card's casts give the CPU's codes byte for byte, rounding ties
    included; NaN gives code 0 in int8 and 0x7F in e4m3 (the same as the
    CPU stacks of both packages), a NaN code in e5m2."""
    import numpy as np

    from neuronx_distributed_inference_tpu_torch.modules.kvcache import quantize_kv_codes

    rng = np.random.RandomState(0)
    for dt, qmax in ((torch.int8, 127.0), (torch.float8_e4m3fn, 448.0), (torch.float8_e5m2, 57344.0)):
        x = rng.randn(64, 2, 64).astype(np.float32) * qmax / 3
        x[0, 0, :6] = [0.5, 1.5, -2.5, 1.0625, 1.125, qmax * 2]
        x[0, 1, :3] = [np.nan, np.inf, -np.inf]
        s = torch.full((2,), qmax)
        cpu = quantize_kv_codes(torch.from_numpy(x), s, dt)
        gpu = quantize_kv_codes(torch.from_numpy(x).cuda(), s.cuda(), dt).cpu()
        nan = torch.isnan(cpu.float())  # int8 codes are never NaN
        assert torch.equal(nan, torch.isnan(gpu.float()))
        assert torch.equal(cpu.view(torch.uint8)[~nan], gpu.view(torch.uint8)[~nan])
        nan_code = gpu.view(torch.uint8)[0, 1, 0].item()
        if dt == torch.int8:
            assert nan_code == 0
        elif dt == torch.float8_e4m3fn:
            assert nan_code == 0x7F
        else:
            assert nan[0, 1, 0]


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["generate", "split_1ahead", "ragged_sync"])
def test_graphs_match_eager_kv_int8(cuda_card, mode):
    """An int8 KV cache through captured graphs: byte-identical greedy
    tokens, equal launch counts (the code modes' among them) and
    bit-identical final (L, Hkv) scales against the same programs run
    eagerly; the scales live at fixed addresses and are updated in place."""
    import numpy as np

    kw = dict(kv_cache_dtype="int8")
    if mode != "generate":
        kw.update(
            is_continuous_batching=True, batch_size=4, is_block_kv_layout=True, pa_block_size=16, pa_num_blocks=96,
            is_chunked_prefill=True, chunked_prefill_config=dict(max_num_seqs=2, kernel_q_tile_size=32),
            async_mode=mode.endswith("1ahead"), serving_ragged=mode.startswith("ragged"),
        )
    eager, graph = _pair(**kw)
    ptrs = (graph.kv_cache.k.scale.data_ptr(), graph.kv_cache.v.scale.data_ptr())
    if mode == "generate":
        ids, mask = _prompt_batch()
        run = lambda app: app.generate(ids, mask, max_new_tokens=100).sequences  # noqa: E731
        code = "decode_attention_codes"
    else:
        rng = np.random.RandomState(5)
        prompts = [rng.randint(1, 256, size=n).tolist() for n in (40, 9, 77, 20, 33, 5)]
        run = lambda app: _serve(app, prompts)  # noqa: E731
        code = "ragged_paged_attention_codes" if mode.startswith("ragged") else "paged_decode_attention_codes"
    want, want_counts = _counted(lambda: run(eager))
    got, got_counts = _counted(lambda: run(graph))
    if mode == "generate":
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want
    assert got_counts == want_counts and got_counts[code] > 0, got_counts
    for s in ("k", "v"):
        assert torch.equal(getattr(graph.kv_cache, s).scale, getattr(eager.kv_cache, s).scale)
    assert (graph.kv_cache.k.scale.data_ptr(), graph.kv_cache.v.scale.data_ptr()) == ptrs


@pytest.mark.gpu
def test_decode_attention_under_tree_masks_on_the_card(cuda_card):
    """B1 under token-tree ancestry masks (non-causal over the K rows, at
    the cache tail) at Llama-3.1-8B's heads: both trees' verify masks (K =
    16 and 13) and a draft level of each (K = 4 and 3), batch 1 and 4,
    buckets 512 and 1024, bf16 and fp32, a tree across a kv split boundary
    and rows whose later splits are all masked, against the plain version,
    each case launched twice more, bit-identical
    (chip_smoke.eagle_tree_parity)."""
    sys.path.insert(0, REPO)
    import chip_smoke
    from neuronx_distributed_inference_tpu_torch.ops import _cuda
    from neuronx_distributed_inference_tpu_torch.ops import decode_attention as da

    _cuda.reset_launch_counts()
    n = chip_smoke.eagle_tree_parity(torch, da)
    assert n == 32
    assert _cuda.launch_counts()["decode_attention_verify"] == 3 * n


@pytest.mark.gpu
def test_decode_attention_row_chunks_on_the_card(cuda_card):
    """B1 and B4 at n_rep 8 with K = 9, 12 and 16 queries a row (two row
    chunks of at most 64 query rows a kv head), GPT-OSS's heads with the
    window mask and the sink and Qwen3's without, against the plain version,
    each case twice more, bit-identical (chip_smoke.row_chunk_parity)."""
    sys.path.insert(0, REPO)
    import chip_smoke
    from neuronx_distributed_inference_tpu_torch.ops import _cuda
    from neuronx_distributed_inference_tpu_torch.ops import decode_attention as da

    _cuda.reset_launch_counts()
    n = chip_smoke.row_chunk_parity(torch, da)
    assert n == 2 * 2 * 2 * len(chip_smoke.ROW_CHUNK_K)
    counts = _cuda.launch_counts()
    assert counts["decode_attention_verify"] == counts["paged_decode_attention"] == 3 * n


@pytest.mark.gpu
def test_dbrx_head_shape_kernels_match_plain_on_the_card(cuda_card):
    """B2a, B1, B4 and B5 at DBRX's heads (48 q / 8 kv of 128, n_rep 6, no
    power of two): B2a at S 256 (batch 1 and 8) and 77 with a padded row,
    B1 at batch 1 and 8 with 1, 4 and 11 queries a row (11: two row
    chunks), bf16 and fp32, B4 and B5 at the serving shapes, each against
    its plain version and launched twice more, bit-identical
    (chip_smoke.dbrx_kernel_parity)."""
    sys.path.insert(0, REPO)
    import chip_smoke
    from neuronx_distributed_inference_tpu_torch.ops import _cuda
    from neuronx_distributed_inference_tpu_torch.ops import decode_attention as da
    from neuronx_distributed_inference_tpu_torch.ops import flash_attention as fa
    from neuronx_distributed_inference_tpu_torch.ops import paged_flash_attention as pf

    _cuda.reset_launch_counts()
    assert chip_smoke.dbrx_kernel_parity(torch, fa, da, pf) == 4 + 12 + 2 + 4
    counts = _cuda.launch_counts()
    assert counts["paged_decode_attention"] == 3 * 2 and counts["paged_flash_attention"] == 3 * 4, counts
    assert all(counts[name] > 0 for name in ("flash_attention", "decode_attention", "decode_attention_verify")), counts


@pytest.mark.gpu
@pytest.mark.parametrize("model", ["dbrx", "deepseek"])
def test_moe_decode_at_a9_widths_on_the_card(cuda_card, model):
    """B7 against its plain version at DBRX's widths (H 6144, I 10752, 16
    experts top-4: 4 and 32 rows) and DeepSeek-V3's (H 7168, I 2048, 256
    experts top-8: 8 and 64 rows, the kernel's limit), bf16, on seeded
    full-width leaves, each case launched twice more, bit-identical
    (chip_smoke.check_moe)."""
    sys.path.insert(0, REPO)
    import chip_smoke
    from neuronx_distributed_inference_tpu_torch.ops import _cuda
    from neuronx_distributed_inference_tpu_torch.ops import moe_decode as md

    E, k, H, I = {"dbrx": (16, 4, 6144, 10752), "deepseek": (256, 8, 7168, 2048)}[model]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(34)
    _, _, _, wg, wu, wd = chip_smoke.moe_inputs(torch, gen, 1, k, E, H, I, torch.bfloat16)
    for T in (1, 8):
        x, idx, w = chip_smoke.moe_inputs(torch, gen, T, k, E, 8, 8, torch.bfloat16)[:3]
        x = torch.randn((T, H), generator=gen, device="cuda").to(torch.bfloat16)
        args = (x, idx, w, wg, wu, wd)
        case = f"{model} widths T={T} k={k} ({T * k} rows) E={E} H={H} I={I} bf16"
        chip_smoke.check_moe(torch, md, args, {}, case)
        _cuda.reset_launch_counts()
        chip_smoke.check_repeat(torch, "fused_moe_decode", lambda: md.fused_moe_decode(*args), case)
        assert _cuda.launch_counts()["moe_decode"] == 2


@pytest.mark.gpu
def test_qkv_clip_on_the_card(cuda_card):
    """DBRX's qkv clip through the kernels: a 2-layer DBRX of head_dim 128 at
    fp32 on the card (B2a, B1, B7 launched) against the same weights on the
    CPU (their plain versions) with a clip of 0.05 that changes the logits
    on the card: the same greedy tokens, logits within 2e-3."""
    from neuronx_distributed_inference_tpu_torch.config import MoEConfig
    from neuronx_distributed_inference_tpu_torch.models.dbrx import DbrxInferenceConfig
    from neuronx_distributed_inference_tpu_torch.ops import _cuda
    from neuronx_distributed_inference_tpu_torch.runtime.application import ModelForCausalLM

    def app(device, clip, params=None):
        attrs = dict(model_type="dbrx", d_model=256, n_heads=2, n_layers=2, max_seq_len=256, vocab_size=512,
                     attn_config=dict(kv_n_heads=1, clip_qkv=clip, rope_theta=10000.0),
                     ffn_config=dict(ffn_hidden_size=128, moe_num_experts=16, moe_top_k=4))
        cfg = DbrxInferenceConfig(
            MoEConfig(batch_size=2, seq_len=128, dtype="float32", output_logits=True, device=device, seed=3,
                      context_encoding_buckets=[32], token_generation_buckets=[128]),
            load_config=lambda c: [setattr(c, name, v) for name, v in attrs.items()],
        )
        a = ModelForCausalLM(None, cfg)
        return a.load(params=params) if params is not None else a.load(random_weights=True)

    ids = torch.randint(0, 512, (2, 24), generator=torch.Generator().manual_seed(5)).numpy()
    outs = {}
    for clip in (None, 0.05):
        card = app("cuda", clip)
        host_params = _to(card.params, "cpu")
        _cuda.reset_launch_counts()
        outs[clip] = card.generate(ids, max_new_tokens=8)
        counts = _cuda.launch_counts()
        assert counts["flash_attention"] == 2 and counts["decode_attention"] > 0 and counts["moe_decode"] > 0, counts
        host = app("cpu", clip, host_params).generate(ids, max_new_tokens=8)
        assert (host.sequences == outs[clip].sequences).all()
        assert abs(host.logits - outs[clip].logits).max() < 2e-3
    assert abs(outs[None].logits - outs[0.05].logits).max() > 1e-2


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


@pytest.mark.gpu
def test_chunked_masks_at_llama4_heads_on_the_card(cuda_card):
    """B2a, B1 and B4 under Llama4's chunk masks at Llama-4-Scout's heads (40
    q / 8 kv of 128, n_rep 5): B2a at S 8448 with the chunk boundary between
    tiles and inside one, B1 over an 8448-position cache at batch 1 and 8
    with 1 and 4 queries a row at positions just before and just past 8192
    (past it the chunk mask empties every kv split of chunk 0), bf16 and
    fp32, and the NoPE layers' global mask there, B4 on a paged pool at the
    same positions, each against its plain version and launched twice
    more, bit-identical (chip_smoke.llama4_kernel_parity)."""
    sys.path.insert(0, REPO)
    import chip_smoke
    from neuronx_distributed_inference_tpu_torch.ops import _cuda
    from neuronx_distributed_inference_tpu_torch.ops import decode_attention as da
    from neuronx_distributed_inference_tpu_torch.ops import flash_attention as fa

    _cuda.reset_launch_counts()
    # B2a 2; B1 chunked: (bf16, fp32) x (batch 1 at two depths, batch 8) x
    # K (1, 4), global: batch 1 at two depths and batch 8; B4 4
    assert chip_smoke.llama4_kernel_parity(torch, fa, da) == 2 + 2 * 3 * 2 + 3 + 4
    counts = _cuda.launch_counts()
    assert counts["flash_attention"] == 3 * 2, counts
    assert counts["decode_attention"] == 3 * (2 * 3 + 3) and counts["decode_attention_verify"] == 3 * 2 * 3, counts
    assert counts["paged_decode_attention"] == 3 * 4, counts


@pytest.mark.gpu
def test_llama4_generate_on_the_card_matches_the_cpu(cuda_card):
    """A tiny Llama4 (head_dim 64, chunk 8 and floor_scale 8, so both bite
    inside 24 + 8 tokens; dense and MoE layers interleaved) through B2 and
    B1 on the card: the same greedy tokens as the plain versions on the
    CPU, logits within 2e-3 at fp32, every attention call launched."""
    from neuronx_distributed_inference_tpu_torch.config import Config
    from neuronx_distributed_inference_tpu_torch.models.llama4 import Llama4TextInferenceConfig
    from neuronx_distributed_inference_tpu_torch.ops import _cuda
    from neuronx_distributed_inference_tpu_torch.runtime.application import ModelForCausalLM

    attrs = dict(model_type="llama4_text", hidden_size=128, intermediate_size=64, intermediate_size_mlp=128,
                 num_hidden_layers=4, num_attention_heads=4, num_key_value_heads=2, head_dim=64,
                 num_local_experts=4, num_experts_per_tok=1, interleave_moe_layer_step=2, vocab_size=512,
                 attention_chunk_size=8, use_qk_norm=True, attn_temperature_tuning=True, floor_scale=8,
                 attn_scale=0.1, rms_norm_eps=1e-5, rope_theta=500000.0, hidden_act="silu",
                 tie_word_embeddings=False)

    def app(device, params=None):
        cfg = Llama4TextInferenceConfig(
            Config(batch_size=2, seq_len=64, dtype="float32", output_logits=True, device=device, seed=3,
                   context_encoding_buckets=[32], token_generation_buckets=[64]),
            load_config=lambda c: [setattr(c, name, v) for name, v in attrs.items()],
        )
        a = ModelForCausalLM(None, cfg)
        return a.load(params=params) if params is not None else a.load(random_weights=True)

    ids = torch.randint(0, 512, (2, 24), generator=torch.Generator().manual_seed(5)).numpy()
    card = app("cuda")
    host_params = _to(card.params, "cpu")
    _cuda.reset_launch_counts()
    out = card.generate(ids, max_new_tokens=8)
    counts = _cuda.launch_counts()
    assert counts["flash_attention"] == 4 and counts["decode_attention"] == 4 * 8, counts
    host = app("cpu", host_params).generate(ids, max_new_tokens=8)
    assert (host.sequences == out.sequences).all()
    assert abs(host.logits - out.logits).max() < 2e-3


def _lora_state_dicts(n, r=16, seed=0):
    """``n`` seeded PEFT-layout adapters on q/k/v/o of the TINY model."""
    gen = torch.Generator().manual_seed(seed)
    H, D = TINY["hidden_size"], TINY["hidden_size"] // TINY["num_attention_heads"]
    out = dict(q_proj=H, k_proj=TINY["num_key_value_heads"] * D, v_proj=TINY["num_key_value_heads"] * D, o_proj=H)
    adapters = {}
    for a in range(n):
        sd = {}
        for i in range(TINY["num_hidden_layers"]):
            for mod, width in out.items():
                p = f"base_model.model.model.layers.{i}.self_attn.{mod}."
                sd[p + "lora_A.weight"] = torch.randn((r, H), generator=gen) * 0.1
                sd[p + "lora_B.weight"] = torch.randn((width, r), generator=gen) * 0.1
        adapters[f"ad{a}"] = (sd, {"lora_alpha": 2 * r, "use_rslora": a % 2 == 1})
    return adapters


@pytest.mark.gpu
def test_lora_rows_on_the_card(cuda_card):
    """Multi-adapter LoRA on the card, bf16, the fused decode layer asked
    for: (1) a batch of 4 rows with 4 distinct adapters equals each row
    alone on the same app (the compiled batch, so the same shapes); (2) B2
    launches once a layer a prefill and B1 once a layer a decode step, and
    neither B8 nor B9 launches (adapter ids keep them off); (3) with the
    dynamic cache (1 slot), graphs captured while adapter ad0 held the
    slot replay after ad1 is swapped in, in place: no new capture, and the
    tokens of an eager app with ad1."""
    import numpy as np

    from neuronx_distributed_inference_tpu_torch.runtime.application import _pick_chunk

    lora = dict(lora_config=dict(max_loras=4, max_lora_rank=16, max_loras_on_cpu=4), fused_qkv=False,
                fused_attn_block_kernel_enabled=True, fused_mlp_kernel_enabled=True, batch_size=4)
    adapters = _lora_state_dicts(4)
    app = _tiny_app(**lora).load_lora_adapters(adapters)
    ids = np.random.RandomState(3).randint(1, 256, size=(4, 12))
    names = list(adapters)
    L, n_new = TINY["num_hidden_layers"], 24
    out, counts = _counted(lambda: app.generate(ids, max_new_tokens=n_new, lora_adapter_names=names))
    # the decode chunk runs _pick_chunk's steps (surplus ones discarded)
    steps = _pick_chunk(n_new - 1, False, 1 << 20)
    assert counts["flash_attention"] == L and counts["decode_attention"] == L * steps, counts
    assert counts["fused_attn_block"] == 0 and counts["fused_mlp_block"] == 0, counts
    base = app.generate(ids, max_new_tokens=n_new, lora_adapter_names=[None] * 4).sequences
    for i, name in enumerate(names):
        alone = app.generate(ids[i : i + 1], max_new_tokens=n_new, lora_adapter_names=[name]).sequences[0]
        np.testing.assert_array_equal(out.sequences[i], alone)
    assert (out.sequences != base).any()

    dyn = dict(lora, lora_config=dict(max_loras=1, max_lora_rank=16, max_loras_on_cpu=4), batch_size=1)
    graph = _tiny_app(params=app.params, **dyn)
    eager = _tiny_app(params=app.params, cuda_graphs=False, **dyn)
    # the apps share the base tensors; each attaches its own slots
    for a in (graph, eager):
        a.params = dict(a.params, layers=[_copy_dicts(lp) for lp in a.params["layers"]])
        a.load_lora_adapters(adapters, dynamic=True)
    first = graph.generate(ids[:1], max_new_tokens=n_new, lora_adapter_names=["ad0"]).sequences
    np.testing.assert_array_equal(first[0], eager.generate(ids[:1], max_new_tokens=n_new,
                                                            lora_adapter_names=["ad0"]).sequences[0])
    captures = graph.graphs.captures
    assert captures > 0
    got = graph.generate(ids[:1], max_new_tokens=n_new, lora_adapter_names=["ad1"]).sequences
    assert graph.graphs.captures == captures and graph.lora_manager.swaps == 2
    want = eager.generate(ids[:1], max_new_tokens=n_new, lora_adapter_names=["ad1"]).sequences
    np.testing.assert_array_equal(got, want)
    assert (got != first).any()


def _copy_dicts(tree):
    """New dicts over the same tensors."""
    return {k: _copy_dicts(v) for k, v in tree.items()} if isinstance(tree, dict) else tree


@pytest.mark.gpu
def test_vision_text_kernels_match_plain_on_the_card(cuda_card):
    """B2a and B1 at the vision-language paths' text shapes (32 q / 8 kv
    heads of 128): Pixtral-12B's 4224-token prefill program and 4288 cache
    at batch 1, its 1152 / 1216 at batch 4, Llama-3.2-11B-Vision's 64-token
    prefill and 128 cache at batch 1 and 4; each against its plain version
    (B1 in bf16 and fp32) and launched twice more, bit-identical
    (chip_smoke.vlm_kernel_parity)."""
    sys.path.insert(0, REPO)
    import chip_smoke
    from neuronx_distributed_inference_tpu_torch.ops import _cuda
    from neuronx_distributed_inference_tpu_torch.ops import decode_attention as da
    from neuronx_distributed_inference_tpu_torch.ops import flash_attention as fa

    _cuda.reset_launch_counts()
    n = chip_smoke.vlm_kernel_parity(torch, fa, da)
    n_flash, n_decode = len(chip_smoke.VLM_FLASH_POINTS), 2 * len(chip_smoke.VLM_DECODE_POINTS)
    assert n == n_flash + n_decode
    counts = _cuda.launch_counts()
    assert counts["flash_attention"] == 3 * n_flash and counts["decode_attention"] == 3 * n_decode, counts


@pytest.mark.gpu
def test_embeds_cte_graph_replays_bit_identically(cuda_card):
    """A tiny Pixtral app (text heads of 128, seeded random weights) on the
    card: the first image request runs the inputs_embeds context program
    eagerly and captures it; the second replays it, with the same tokens
    and logits bit for bit, as an app with graphs off gives them; a
    text-only call between them takes its own program and leaves the
    embeds graph as it was."""
    import numpy as np

    from neuronx_distributed_inference_tpu_torch.config import Config, InferenceConfig
    from neuronx_distributed_inference_tpu_torch.ops import _cuda
    from neuronx_distributed_inference_tpu_torch.runtime.image_to_text import ImageToTextModel

    attrs = dict(
        text_config=dict(model_type="mistral", hidden_size=256, head_dim=128, intermediate_size=256,
                         num_attention_heads=2, num_key_value_heads=1, num_hidden_layers=2, vocab_size=256,
                         rms_norm_eps=1e-5, rope_theta=1e9, sliding_window=None, tie_word_embeddings=False),
        vision_config=dict(model_type="pixtral", hidden_size=64, head_dim=16, image_size=64, intermediate_size=128,
                           num_attention_heads=4, num_hidden_layers=2, patch_size=16),
        image_token_index=10, projector_hidden_act="gelu",
    )

    def app(graphs, params=None):
        cfg = InferenceConfig(
            Config(batch_size=1, seq_len=64, dtype="bfloat16", output_logits=True, device="cuda", seed=4,
                   cuda_graphs=graphs, context_encoding_buckets=[32]),
            load_config=lambda c: [setattr(c, k, v) for k, v in attrs.items()],
        )
        a = ImageToTextModel(None, cfg)
        return a.load(params=params) if params is not None else a.load(random_weights=True)

    on = app(True)
    off = app(False, params=dict(text=on.text.params, vision=on.vision_params, projector=on.projector))
    ids = np.array([[1] + [10] * 16 + [20, 30, 40]])
    px = np.random.RandomState(2).randn(1, 3, 64, 64).astype(np.float32)
    first = on.generate(ids, pixel_values=px, max_new_tokens=6)
    captures = on.text.graphs.captures
    assert captures > 0
    on.generate(ids[:, -3:], max_new_tokens=6)
    text_captures = on.text.graphs.captures
    assert text_captures > captures
    _cuda.reset_launch_counts()
    again = on.generate(ids, pixel_values=px, max_new_tokens=6)
    assert on.text.graphs.captures == text_captures
    assert _cuda.launch_counts()["flash_attention"] == 2
    ref = off.generate(ids, pixel_values=px, max_new_tokens=6)
    np.testing.assert_array_equal(again.sequences, first.sequences)
    np.testing.assert_array_equal(again.logits, first.logits)
    np.testing.assert_array_equal(ref.sequences, first.sequences)
    np.testing.assert_array_equal(ref.logits, first.logits)


@pytest.mark.gpu
def test_mllama_graphed_decode_matches_eager_on_the_card(cuda_card):
    """A small Mllama app on the card (text heads of 128 with cross layers 1
    and 3, a 4-tile tower of 64, seeded random bf16 weights, every gate
    tanh ~ 0.5), two rows each with its own 2 x 2-tile image: the graphed
    decode (the first step eager, then one graph replayed) against an app
    with graphs off on the same params and inputs gives the same tokens and
    launch counts, and leaves the self and cross K / V streams equal bit for
    bit; a second call replays with no new capture and the same tokens."""
    sys.path.insert(0, REPO)
    import numpy as np

    import chip_smoke
    from neuronx_distributed_inference_tpu_torch.models.mllama import LLAMA32_11B_VISION
    from neuronx_distributed_inference_tpu_torch.runtime.mllama import MllamaForConditionalGeneration

    text = dict(LLAMA32_11B_VISION["text_config"], hidden_size=256, num_hidden_layers=5, cross_attention_layers=[1, 3],
                num_attention_heads=2, num_key_value_heads=1, intermediate_size=256, vocab_size=512)
    vision = dict(LLAMA32_11B_VISION["vision_config"], hidden_size=64, attention_heads=4, intermediate_size=128,
                  num_hidden_layers=3, num_global_layers=2, image_size=28, intermediate_layers_indices=[0, 2],
                  vision_output_dim=64 * 3)
    model = dict(LLAMA32_11B_VISION, text_config=text, vision_config=vision, image_token_index=512)

    def app(graphs):
        return MllamaForConditionalGeneration(None, chip_smoke._config_mllama(2, model=model, cuda_graphs=graphs))

    on = app(True)
    text_params = chip_smoke._mllama_text_params(torch, on, torch.bfloat16, 3)
    on.load(params=dict(text_params, vision=chip_smoke._mllama_vision_params(torch, vision, torch.bfloat16, 4)))
    off = app(False).load(params=on.params)
    ids, ar, am, xmask = chip_smoke._mllama_inputs(np.random.RandomState(0), 2, on)
    px = chip_smoke._mllama_pixels(torch, on, 2, 5)

    def generate(a):
        return a.generate(ids, None, px, ar, am, xmask, max_new_tokens=8)

    from neuronx_distributed_inference_tpu_torch.ops import _cuda

    _cuda.reset_launch_counts()
    graphed = generate(on)
    counts = chip_smoke.all_counts()
    assert on.graphs.captures == 1
    assert counts["flash_attention"] == 3 and counts["decode_attention"] == 3 * 7, counts
    _cuda.reset_launch_counts()
    eager = generate(off)
    assert chip_smoke.all_counts() == counts
    np.testing.assert_array_equal(graphed.sequences, eager.sequences)
    for name in ("k", "v", "cross_k", "cross_v"):
        assert torch.equal(getattr(on.cache, name), getattr(off.cache, name)), name
    again = generate(on)
    assert on.graphs.captures == 1
    np.testing.assert_array_equal(again.sequences, eager.sequences)


@pytest.mark.gpu
def test_decode_attention_row_chunks_timed_points_on_the_card(cuda_card):
    """B1 and B4 at the timed row-chunk points (GPT-OSS-20B's heads with
    the sink, K = 16, batch 1 and 8, bucket 1024, ~200 deep) against their
    plain versions (chip_smoke.row_chunk_times), each with its time, plain
    time, SDPA time and bound."""
    sys.path.insert(0, REPO)
    import chip_smoke
    from neuronx_distributed_inference_tpu_torch.ops import decode_attention as da

    rows = chip_smoke.row_chunk_times(torch, da)
    assert set(rows) == {(n, B) for n in ("decode_attention_row_chunks", "paged_decode_attention_row_chunks")
                         for B in (1, 8)}
    for row in rows.values():
        assert row["ms"] > 0 and row["plain_ms"] > 0 and row["library_ms"] > 0 and row["bound_ms"] > 0
        assert row["max_abs_err"] < 0.05


def _small_whisper(graphs, batch=2):
    from neuronx_distributed_inference_tpu_torch.config import Config, InferenceConfig
    from neuronx_distributed_inference_tpu_torch.runtime.encoder_decoder import WhisperModel

    hf = dict(d_model=256, encoder_layers=2, decoder_layers=3, encoder_attention_heads=4, decoder_attention_heads=4,
              encoder_ffn_dim=512, decoder_ffn_dim=512, num_mel_bins=32, vocab_size=512, max_source_positions=64,
              max_target_positions=96, decoder_start_token_id=1)
    cfg = InferenceConfig(Config(batch_size=batch, seq_len=96, dtype="bfloat16", device="cuda", cuda_graphs=graphs),
                          load_config=lambda c: [setattr(c, k, v) for k, v in hf.items()])
    return WhisperModel(None, cfg)


@pytest.mark.gpu
def test_whisper_graphed_decode_matches_eager_on_the_card(cuda_card):
    """A small Whisper on the card (seeded bf16 weights, heads of 64): the
    graphed decode (one graph a batch) against an app with graphs off on
    the same params and inputs: the same tokens and launch counts (none),
    the self-attention K / V streams equal bit for bit; with an EOS list
    whose first id one row emits early, the finished row's fill matches
    too; a second call replays with no new capture."""
    sys.path.insert(0, REPO)
    import numpy as np

    import chip_smoke
    from neuronx_distributed_inference_tpu_torch.ops import _cuda

    on = _small_whisper(True)
    params = chip_smoke.whisper_params(torch, on.spec, ffn=512)
    on.load(params=params)
    off = _small_whisper(False).load(params=params)
    feats = torch.randn((2, 32, 128), generator=torch.Generator("cuda").manual_seed(3), device="cuda")
    forced = np.array([[1, 7, 9], [1, 8, 10]])
    _cuda.reset_launch_counts()
    graphed = on.generate(feats, decoder_input_ids=forced, max_new_tokens=24)
    counts = chip_smoke.all_counts()
    eager = off.generate(feats, decoder_input_ids=forced, max_new_tokens=24)
    assert chip_smoke.all_counts() == counts and not any(counts.values())
    assert on.graphs.captures == 1 and off.graphs.captures == 0
    np.testing.assert_array_equal(graphed.sequences, eager.sequences)
    for name in ("k", "v"):
        assert torch.equal(getattr(on.kv_cache, name), getattr(off.kv_cache, name)), name
    eos = [int(graphed.sequences[0, 6]), 3]
    a = on.generate(feats, decoder_input_ids=forced, max_new_tokens=24, eos_token_id=eos)
    b = off.generate(feats, decoder_input_ids=forced, max_new_tokens=24, eos_token_id=eos)
    np.testing.assert_array_equal(a.sequences, b.sequences)
    assert (a.sequences[0, 7:] == eos[0]).all()
    again = on.generate(feats, decoder_input_ids=forced, max_new_tokens=24)
    assert on.graphs.captures == 2  # the EOS list's key, then no new one
    np.testing.assert_array_equal(again.sequences, graphed.sequences)


@pytest.mark.gpu
def test_flux_step_on_the_card_against_its_fp32_twin(cuda_card):
    """One velocity of a small FLUX DiT (heads of 128, 1 dual and 2 single
    blocks, a non-square 6 x 10 grid) on the card in bf16 within 5% rel rms
    of its fp32 twin, the fp32 twin within 1e-4 of the same call on the
    CPU, and one pipeline step's image finite in [0, 1]."""
    sys.path.insert(0, REPO)
    import numpy as np

    from neuronx_distributed_inference_tpu_torch.models.flux import FluxSpec, flux_forward, flux_random_params, latent_image_ids

    spec = FluxSpec(dim=256, num_heads=2, head_dim=128, num_dual=1, num_single=2, in_channels=64, joint_dim=128,
                    pooled_dim=64, axes_dims_rope=(16, 56, 56))
    p32 = flux_random_params(spec, seed=3)
    rng = np.random.RandomState(0)
    args = [torch.from_numpy(a) for a in (
        rng.randn(1, 60, 64).astype(np.float32), rng.randn(1, 12, 128).astype(np.float32),
        rng.randn(1, 64).astype(np.float32), np.full(1, 0.6, np.float32), latent_image_ids(6, 10),
        np.zeros((12, 3), np.float32))]

    def run(tree, dt, dev):
        on = [a.to(dev) for a in args]
        for i in range(3):
            on[i] = on[i].to(dt)
        with torch.no_grad():
            return flux_forward(_cast_tree(tree, dt, dev), *on, spec=spec).float().cpu().numpy()

    cpu = run(p32, torch.float32, "cpu")
    f32 = run(p32, torch.float32, "cuda")
    bf16 = run(p32, torch.bfloat16, "cuda")
    np.testing.assert_allclose(f32, cpu, atol=1e-4, rtol=0)
    assert np.sqrt(np.mean((bf16 - f32) ** 2)) / np.sqrt(np.mean(f32 ** 2)) < 0.05


def _cast_tree(tree, dt, dev):
    if isinstance(tree, dict):
        return {k: _cast_tree(v, dt, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast_tree(v, dt, dev) for v in tree]
    return tree.to(device=dev, dtype=dt) if tree.is_floating_point() else tree.to(dev)


@pytest.mark.gpu
def test_mla_int8_latent_cache_on_the_card_against_its_fp32_twin(cuda_card):
    """A small DeepSeek-V3 (MLA, 1 dense + 2 MoE layers) on the int8 latent
    cache on the card: bf16 logits of a 6-token generate() within 5% rel
    rms of the fp32 app's on the same int8 cache and the same params, the
    fp32 app's tokens equal to the same app's on the CPU, each stream's
    (L, 1) scales raised."""
    import numpy as np

    from neuronx_distributed_inference_tpu_torch.config import MoEConfig
    from neuronx_distributed_inference_tpu_torch.models.deepseek import DeepseekV3InferenceConfig
    from neuronx_distributed_inference_tpu_torch.runtime.application import ModelForCausalLM

    hf = dict(model_type="deepseek_v3", vocab_size=512, hidden_size=256, intermediate_size=384,
              moe_intermediate_size=64, num_hidden_layers=3, num_attention_heads=4, num_key_value_heads=4,
              n_shared_experts=1, n_routed_experts=8, routed_scaling_factor=2.5, kv_lora_rank=64, q_lora_rank=96,
              qk_rope_head_dim=32, v_head_dim=32, qk_nope_head_dim=32, n_group=2, topk_group=1,
              num_experts_per_tok=2, first_k_dense_replace=1, norm_topk_prob=True, rms_norm_eps=1e-5,
              max_position_embeddings=256, tie_word_embeddings=False)

    def app(dtype, device):
        cfg = DeepseekV3InferenceConfig(
            MoEConfig(batch_size=2, seq_len=64, dtype=dtype, device=device, kv_cache_dtype="int8", output_logits=True,
                      moe_fused_kernel_enabled=False),
            load_config=lambda c: [setattr(c, k, v) for k, v in hf.items()])
        return ModelForCausalLM(None, cfg)

    a32 = app("float32", "cuda").load(random_weights=True)
    params = a32.params
    a16 = app("bfloat16", "cuda").load(params=_cast_tree(params, torch.bfloat16, "cuda"))
    cpu = app("float32", "cpu").load(params=_cast_tree(params, torch.float32, "cpu"))
    ids = np.random.RandomState(1).randint(0, 512, size=(2, 10))
    o32, o16, oc = (x.generate(ids, max_new_tokens=6) for x in (a32, a16, cpu))
    np.testing.assert_array_equal(o32.sequences, oc.sequences)
    rel = np.sqrt(np.mean((o16.logits - o32.logits) ** 2)) / np.sqrt(np.mean(o32.logits ** 2))
    assert rel < 0.05, rel
    for x in (a32, a16):
        for stream in (x.kv_cache.k, x.kv_cache.v):
            assert tuple(stream.scale.shape) == (3, 1) and float(stream.scale.min()) > 0
