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
def test_qwen3_head_shape_kernels_match_plain_on_the_card(cuda_card):
    """B4, B5 and B3 at Qwen3-30B-A3B's head shape (32 q / 4 kv heads of
    128, n_rep 8, blocks of 32, bf16) against their plain versions: B4 at
    batch 1 and the serving decode step's 8 rows, B5 on the 128-token
    chunk at batch 1 and 8, B3 at the serving row's three points, the last
    two on random and exact-score inputs and each launched twice more,
    bit-identical (chip_smoke.qwen3_*_parity)."""
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
    assert counts["paged_decode_attention"] == n_b4, counts
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
                "ragged_paged_attention_codes": 16}
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
