"""Quantized MoE experts in the port, held against the JAX package on the
CPU at fp32 with inputs made by numpy from a seed:

- ``moe_layer`` with every expert format (int8 per channel, int8 per
  tensor, fp8 e4m3 per channel, int8 blockwise in blocks of 16, grouped
  int4) on the dense, grouped and capacity routes (blockwise has no
  capacity route: the config refuses it, and ``moe_layer`` keeps blockwise
  experts dense), within 2e-5;
- quantize-at-load: the codes and scales of a stacked (L, E, in, out)
  leaf equal the JAX package's byte for byte, and the port's sliced
  quantize equals its whole-leaf quantize bit for bit;
- ``generate()`` on tiny Mixtral and Qwen3-MoE models with
  ``quantized=True`` (per channel and blockwise) and ``weight_dtype="int4"``:
  greedy tokens byte-identical to the JAX app's, logits within 1e-4;
- the split and ragged ``ServingSession`` with int8 experts byte-identical
  to the JAX sessions, and a blockwise app's ragged steps all captured;
- the ``capacity_factor`` plus blockwise refusal in both packages.

On CPU tensors every kernel wrapper takes its plain version."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
import transformers

from neuronx_distributed_inference_tpu.config import ChunkedPrefillConfig as JaxChunked
from neuronx_distributed_inference_tpu.config import MoETpuConfig
from neuronx_distributed_inference_tpu.models.llama import LlamaInferenceConfig as JaxConfig
from neuronx_distributed_inference_tpu.modules import moe as jmoe
from neuronx_distributed_inference_tpu.ops import quant as jquant
from neuronx_distributed_inference_tpu.runtime.application import TpuModelForCausalLM
from neuronx_distributed_inference_tpu.runtime.serving import ServingSession as JaxSession
from neuronx_distributed_inference_tpu_torch.config import ChunkedPrefillConfig, InferenceConfig, MoEConfig
from neuronx_distributed_inference_tpu_torch.models.builder import params_from_jax
from neuronx_distributed_inference_tpu_torch.modules import moe as tmoe
from neuronx_distributed_inference_tpu_torch.ops import _cuda
from neuronx_distributed_inference_tpu_torch.ops import quant as tquant
from neuronx_distributed_inference_tpu_torch.runtime.application import ModelForCausalLM
from neuronx_distributed_inference_tpu_torch.runtime.serving import ServingSession
from tests.test_torch_moe_serving import _RecordingGraphs, _RouteRecorder, _staggered

H, I = 32, 48
ATOL = 2e-5

#: expert formats: (quant dtype, block size, per channel), as
#: ``quantize_params`` takes them
FORMATS = {
    "int8 per channel": ("int8", 0, True),
    "int8 per tensor": ("int8", 0, False),
    "fp8 e4m3 per channel": ("fp8", 0, True),
    "int8 blockwise": ("int8", 16, True),
    "int4 grouped": ("int4", 16, True),
}

#: routes: (spec kwargs, B, S, the route the port counts)
ROUTES = {
    "dense": (dict(num_experts=32, top_k=2), 4, 1, "moe_dense"),
    "grouped": (dict(num_experts=32, top_k=2), 1, 64, "moe_grouped"),
    "capacity": (dict(num_experts=8, top_k=2, capacity_factor=1.0), 2, 64, "moe_capacity"),
}


def _t(a):
    if a.dtype in (ml_dtypes.float8_e4m3fn, ml_dtypes.float8_e5m2):
        code = torch.float8_e4m3fn if a.dtype == ml_dtypes.float8_e4m3fn else torch.float8_e5m2
        return torch.from_numpy(np.array(a).view(np.uint8)).view(code)
    return torch.from_numpy(np.array(a))


def _tree(p, conv):
    return {k: _tree(v, conv) if isinstance(v, dict) else conv(v) for k, v in p.items()}


def _bytes(t):
    return t.detach().contiguous().reshape(-1).view(torch.uint8).numpy()


def _np_bytes(a):
    return np.ascontiguousarray(np.asarray(a)).reshape(-1).view(np.uint8)


def _moe_params(rng, E):
    return {
        "router": {"weight": rng.randn(H, E).astype(np.float32)},
        "experts": {
            "gate_proj": {"weight": rng.randn(E, H, I).astype(np.float32) * 0.1},
            "up_proj": {"weight": rng.randn(E, H, I).astype(np.float32) * 0.1},
            "down_proj": {"weight": rng.randn(E, I, H).astype(np.float32) * 0.1},
        },
    }


#: every (format, route) but blockwise on the capacity route, which the
#: config refuses (test_capacity_blockwise_refused_in_both_packages)
LAYER_CASES = [(f, r) for f in sorted(FORMATS) for r in sorted(ROUTES) if (f, r) != ("int8 blockwise", "capacity")]


@pytest.mark.parametrize("fmt, route", LAYER_CASES)
def test_quantized_moe_layer_matches_jax(fmt, route):
    """Both packages quantize the same numpy experts (the JAX package's
    quantize_params on numpy, the port's on torch); the layer's output
    agrees within 2e-5, and the port counts the route the reference's rule
    picks (blockwise experts: dense on every route)."""
    qdt, block, per_channel = FORMATS[fmt]
    kw, B, S, counted = ROUTES[route]
    rng = np.random.RandomState(11)
    p = _moe_params(rng, kw["num_experts"])
    jp = jquant.quantize_params(_tree(p, np.array), qdt, block_size=block, per_channel=per_channel)
    tp = tquant.quantize_params(_tree(p, lambda a: torch.from_numpy(np.array(a))), qdt, block_size=block,
                                per_channel=per_channel)
    for name in ("gate_proj", "up_proj", "down_proj"):
        for leaf in ("weight", "scale"):
            np.testing.assert_array_equal(_bytes(tp["experts"][name][leaf]), _np_bytes(jp["experts"][name][leaf]))
    assert "scale" not in tp["router"]
    x = rng.randn(B, S, H).astype(np.float32) * 0.3
    ref = jmoe.moe_layer(_tree(jp, jnp.asarray), jnp.asarray(x), jmoe.MoESpec(**kw))
    _cuda.reset_launch_counts()
    out = tmoe.moe_layer(tp, torch.from_numpy(x), tmoe.MoESpec(**kw))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=ATOL)
    if fmt == "int8 blockwise":
        counted = "moe_dense"
    want = {"int4_dense": 0, "moe_dense": 0, "moe_grouped": 0, "moe_capacity": 0, counted: 1}
    assert _cuda.route_counts() == want
    assert _cuda.launch_counts() == {n: 0 for n in _cuda.KERNELS}


@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_quantize_at_load_is_sliced_and_matches_jax(fmt):
    """A stacked (L, E, in, out) expert leaf, a stacked (L, in, out) dense
    leaf and a 2D leaf: the port's codes and scales equal the JAX
    package's byte for byte; sliced along the leading axes (one trailing
    matrix per slice, and three per slice with a ragged last one) they
    equal the whole-leaf quantize bit for bit; the source leaf is gone
    from the tree."""
    qdt, block, per_channel = FORMATS[fmt]
    rng = np.random.RandomState(12)
    leaves = {
        "experts": rng.randn(2, 4, 64, 48).astype(np.float32) * 0.1,
        "dense": rng.randn(2, 64, 80).astype(np.float32),
        "flat": rng.randn(64, 40).astype(np.float32),
    }
    if qdt == "int4":
        def fn(w):
            from neuronx_distributed_inference_tpu_torch.ops.quant_matmul import quantize_tensor_int4

            return quantize_tensor_int4(w, block)
    elif block:
        def fn(w):
            return tquant.quantize_tensor_blockwise(w, qdt, block)
    else:
        def fn(w):
            return tquant.quantize_tensor(w, qdt, per_channel)
    for name, a in leaves.items():
        jq = jquant.quantize_params({"x": {"weight": np.array(a)}}, qdt, block_size=block, per_channel=per_channel)
        src = torch.from_numpy(np.array(a))
        whole = fn(src)
        tree = {"x": {"weight": src}}
        tq = tquant.quantize_params(tree, qdt, block_size=block, per_channel=per_channel)
        assert tq["x"]["weight"] is not src
        for slice_elements in (1, 3 * a.shape[-2] * a.shape[-1]):
            sliced = tquant.quantize_sliced(src, fn, slice_elements)
            for leaf in ("weight", "scale"):
                assert sliced[leaf].dtype == whole[leaf].dtype and sliced[leaf].shape == whole[leaf].shape
                np.testing.assert_array_equal(_bytes(sliced[leaf]), _bytes(whole[leaf]))
        for leaf in ("weight", "scale"):
            np.testing.assert_array_equal(_bytes(tq["x"][leaf]), _bytes(whole[leaf]))
            np.testing.assert_array_equal(_bytes(tq["x"][leaf]), _np_bytes(jq["x"][leaf]))


def test_grouped_int4_dequantizes_each_expert_as_the_whole_stack():
    """The grouped route dequantizes one non-empty expert at a time; each
    slice equals the whole stack's dequantize bit for bit, in fp32 and in
    bf16 (the product rounded once), and equals the JAX package's."""
    from neuronx_distributed_inference_tpu.ops.quant_matmul import dequantize_int4 as jax_dequantize
    from neuronx_distributed_inference_tpu_torch.ops import quant_matmul as qmm

    rng = np.random.RandomState(13)
    q = qmm.quantize_tensor_int4(torch.from_numpy(rng.randn(6, 40, 24).astype(np.float32)), 16)
    for dtype in (torch.float32, torch.bfloat16):
        whole = qmm.dequantize_int4(q["weight"], q["scale"], 40, dtype)
        assert whole.shape == (6, 40, 24) and whole.dtype == dtype
        for e in range(6):
            one = qmm.dequantize_int4(q["weight"][e], q["scale"][e], 40, dtype)
            np.testing.assert_array_equal(_bytes(one), _bytes(whole[e]))
    ref = np.asarray(jax_dequantize(q["weight"].numpy(), q["scale"].numpy(), 40))
    np.testing.assert_array_equal(qmm.dequantize_int4(q["weight"], q["scale"], 40).numpy(), ref)
    entry = dict(q, bias=torch.ones(6, 24))
    plain = qmm.maybe_dequantize_int4(entry, 40, torch.float32)
    assert set(plain) == {"weight", "bias"} and plain["bias"] is entry["bias"]
    int8 = {"weight": torch.zeros(6, 40, 24, dtype=torch.int8), "scale": torch.ones(6, 24)}
    assert qmm.maybe_dequantize_int4(int8, 40, torch.float32) is int8


def test_capacity_blockwise_refused_in_both_packages():
    """capacity_factor with blockwise-quantized experts raises in both
    packages' MoE configs; per-channel experts with a capacity factor, and
    blockwise ones without, are accepted."""
    kw = dict(batch_size=1, seq_len=64, dtype="float32", quantized=True, quantization_type="blockwise",
              capacity_factor=1.0)
    with pytest.raises(NotImplementedError, match="capacity_factor with blockwise-quantized experts"):
        MoETpuConfig(**kw)
    with pytest.raises(NotImplementedError, match="capacity_factor with blockwise-quantized experts"):
        MoEConfig(**kw, device="cpu")
    for ok in (dict(kw, quantization_type="per_channel_symmetric"), dict(kw, capacity_factor=None)):
        MoETpuConfig(**ok)
        MoEConfig(**ok, device="cpu")


# ---------------------------------------------------------------------------
# generate() and serving on tiny Mixtral and Qwen3-MoE models
# ---------------------------------------------------------------------------

COMMON = dict(
    vocab_size=128, hidden_size=128, num_hidden_layers=2, num_attention_heads=2, num_key_value_heads=1,
    rms_norm_eps=1e-5, max_position_embeddings=256, tie_word_embeddings=False, attn_implementation="eager",
    eos_token_id=None, bos_token_id=None,
)
MODELS = {
    "mixtral": (
        transformers.MixtralConfig, transformers.MixtralForCausalLM,
        dict(intermediate_size=96, num_local_experts=8, num_experts_per_tok=2, head_dim=64),
    ),
    "qwen3_moe": (
        transformers.Qwen3MoeConfig, transformers.Qwen3MoeForCausalLM,
        dict(intermediate_size=256, moe_intermediate_size=64, num_experts=32, num_experts_per_tok=2,
             norm_topk_prob=True, head_dim=64, decoder_sparse_step=1),
    ),
}
#: quantized app settings (blocks of 32 divide every input width: 64, 96, 128)
WEIGHTS = {
    "int8": dict(quantized=True),
    "int8 blockwise": dict(quantized=True, quantization_type="blockwise", blockwise_matmul_block_size=32),
    "int4": dict(weight_dtype="int4"),
}
TC = dict(
    batch_size=2, seq_len=128, dtype="float32", context_encoding_buckets=[16, 64],
    token_generation_buckets=[128], output_logits=True,
)
SHORT = np.array([[5, 17, 92, 41, 33, 88, 2, 11], [64, 3, 27, 9, 0, 0, 0, 0]])
SHORT_MASK = np.array([[1] * 8, [1, 1, 1, 1, 0, 0, 0, 0]])
LONG = np.random.RandomState(7).randint(1, 128, size=(2, 40))
LONG_MASK = np.ones_like(LONG)
LONG_MASK[1, 29:] = 0
N_NEW = 8


def _attrs(name):
    cls, _, extra = MODELS[name]
    cfg = cls(**COMMON, **extra)
    attrs = dict(model_type=name, hidden_act="silu", rope_theta=getattr(cfg, "rope_theta", 10000.0))
    for k in ("hidden_size", "intermediate_size", "num_hidden_layers", "num_attention_heads",
              "num_key_value_heads", "vocab_size", "rms_norm_eps", "tie_word_embeddings", "num_local_experts",
              "num_experts", "num_experts_per_tok", "moe_intermediate_size", "norm_topk_prob", "head_dim",
              "decoder_sparse_step"):
        if getattr(cfg, k, None) is not None:
            attrs[k] = getattr(cfg, k)
    return attrs


def _load(attrs):
    return lambda c: [setattr(c, k, v) for k, v in attrs.items()]


_SDS = {}


def _state_dict(name):
    if name not in _SDS:
        torch.set_num_threads(1)
        cls, model_cls, extra = MODELS[name]
        torch.manual_seed(0)
        hf = model_cls(cls(**COMMON, **extra)).eval().float()
        _SDS[name] = {k: v.detach().numpy() for k, v in hf.state_dict().items()}
    return _SDS[name]


def _tree_equal_bytes(port, jax_tree):
    if isinstance(port, dict):
        assert set(port) == set(jax_tree)
        for k in port:
            _tree_equal_bytes(port[k], jax_tree[k])
    elif isinstance(port, list):
        for i, p in enumerate(port):
            _tree_equal_bytes(p, {k: v[i] for k, v in jax_tree.items()} if isinstance(jax_tree, dict) else jax_tree[i])
    else:
        np.testing.assert_array_equal(_bytes(port), _np_bytes(jax.device_get(jax_tree)))


@pytest.mark.parametrize("weights", sorted(WEIGHTS))
@pytest.mark.parametrize("name", sorted(MODELS))
def test_quantized_moe_generate_matches_jax(name, weights):
    """Both prompt buckets (16: B7 or dense at prefill; 64: the grouped
    route, or dense with blockwise experts). The port quantizes the same HF
    state dict at load: its expert codes and scales equal the JAX app's;
    and the port on the JAX app's params (``params_from_jax``) gives the
    same tokens."""
    sd = _state_dict(name)
    load = _load(_attrs(name))
    jax_app = TpuModelForCausalLM(None, JaxConfig(MoETpuConfig(**TC, **WEIGHTS[weights]), load_config=load))
    jax_app.load(state_dict=sd)
    port = ModelForCausalLM(None, InferenceConfig(MoEConfig(**TC, **WEIGHTS[weights], device="cpu"), load_config=load))
    port.load(state_dict=sd)
    jexperts = jax.device_get(jax_app.params["layers"]["mlp"]["experts"])
    for layer, p in enumerate(port.params["layers"]):
        for proj, entry in p["mlp"]["experts"].items():
            for leaf, t in entry.items():
                np.testing.assert_array_equal(_bytes(t), _np_bytes(jexperts[proj][leaf][layer]))
    assert port.builder.host_read_tokens() == (None if weights == "int8 blockwise" else
                                               (64 if name == "qwen3_moe" else None))
    on_jax = ModelForCausalLM(None, InferenceConfig(MoEConfig(**TC, **WEIGHTS[weights], device="cpu"),
                                                    load_config=load))
    on_jax.load(params=params_from_jax(jax.device_get(jax_app.params), torch.float32, "cpu"))
    for ids, mask in ((SHORT, SHORT_MASK), (LONG, LONG_MASK)):
        ref = jax_app.generate(ids, mask, max_new_tokens=N_NEW)
        for app in (port, on_jax):
            _cuda.reset_launch_counts()
            out = app.generate(ids, mask, max_new_tokens=N_NEW)
            np.testing.assert_array_equal(out.sequences, ref.sequences)
            np.testing.assert_allclose(out.logits, np.asarray(ref.logits), atol=1e-4, rtol=0)
            assert _cuda.launch_counts() == {n: 0 for n in _cuda.KERNELS}
            counts = _cuda.route_counts()
            if weights == "int8 blockwise" or name == "mixtral":
                assert counts["moe_grouped"] == 0
            elif ids is LONG:
                assert counts["moe_grouped"] == 2  # the 64-token prefill, once a layer


SERVE = dict(
    is_continuous_batching=True, batch_size=4, ctx_batch_size=1, seq_len=64, dtype="float32",
    is_block_kv_layout=True, pa_block_size=16, pa_num_blocks=24, is_chunked_prefill=True,
)
MODES = {"split": dict(async_mode=True), "ragged": dict(serving_ragged=True)}


def _serving_apps(name, mode, weights):
    kw = {**SERVE, **MODES[mode], **WEIGHTS[weights]}
    chunked = dict(max_num_seqs=2, kernel_q_tile_size=16)
    load = _load(_attrs(name))
    sd = _state_dict(name)
    jax_app = TpuModelForCausalLM(
        None, JaxConfig(MoETpuConfig(**kw, chunked_prefill_config=JaxChunked(**chunked)), load_config=load)
    ).load(state_dict=sd)
    port_app = ModelForCausalLM(None, InferenceConfig(
        MoEConfig(**kw, chunked_prefill_config=ChunkedPrefillConfig(**chunked), device="cpu"), load_config=load,
    )).load(state_dict=sd)
    return jax_app, port_app


@pytest.mark.parametrize(
    "name, mode, weights",
    [("qwen3_moe", "split", "int8"), ("qwen3_moe", "ragged", "int8"), ("mixtral", "split", "int8"),
     ("mixtral", "ragged", "int8"), ("qwen3_moe", "ragged", "int8 blockwise")],
)
def test_quantized_moe_serving_matches_jax(monkeypatch, name, mode, weights):
    """The staggered mix through the JAX and the port sessions: tokens and
    statuses equal; every MoE call's route is the reference rule's, with B7
    refused for scaled experts (they decode dense); a blockwise app's
    ragged runner captures every bucket (no host read: its experts never
    take the grouped route)."""
    jax_app, port_app = _serving_apps(name, mode, weights)
    spec = port_app.builder.moe_spec()
    rec = _RouteRecorder(monkeypatch, spec)
    j = _staggered(JaxSession(jax_app))
    ts = ServingSession(port_app)
    t = _staggered(ts)
    assert t == j and all(len(v) >= 6 for v in t.values())
    assert rec.b7 == 0
    want = rec.expected()
    # scaled experts: every call B7 would have taken goes dense; blockwise
    # ones never group
    want["moe_dense"] += want.pop("b7")
    if weights == "int8 blockwise":
        want["moe_dense"] += want["moe_grouped"]
        want["moe_grouped"] = 0
    obs = rec.observed()
    obs.pop("b7")
    assert rec.calls and obs == want
    if mode == "ragged":
        runner = port_app.mixed_step_model
        eager_from = None if weights == "int8 blockwise" or name == "mixtral" else 64
        assert runner._prog.host_read_tokens == eager_from == port_app.builder.host_read_tokens()
        if eager_from is None and name == "qwen3_moe":
            gs, graphs = _RecordingGraphs(), runner._prog.graphs
            runner.bind_graphs(gs)
            try:
                for bucket in runner.buckets:
                    runner(port_app.params, port_app.kv_cache, runner.example_inputs(bucket))
            finally:
                runner.bind_graphs(graphs)
            assert [k[1] for k in gs.captures] == runner.buckets and max(runner.buckets) >= 64
            assert _cuda.route_counts()["moe_grouped"] == 0
