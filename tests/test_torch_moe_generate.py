"""The MoE slice of the port as a whole, held against the JAX package and
HF transformers on the CPU at fp32: greedy ``generate()`` on tiny Mixtral,
Qwen3-MoE and Qwen3 (dense, qk-norm) models, 2 layers, head_dim 64.

Each tiny model is built in-process by ``transformers`` from a seed, and
both packages load its state dict (the port also takes the JAX app's params
through ``params_from_jax``). Greedy tokens must be identical to the JAX
app's, logits within 1e-4, and within 1e-3 of HF's.

Routes: the tiny Qwen3-MoE has E = 32 = 16 k, so a prefill in the
64-token bucket takes the grouped route; the 16-token bucket sends prefill
(2 rows x 16 tokens x top-2 = 64 rows) to B7, as decode always goes. The
tiny Mixtral (E = 4 < 16 k) prefills dense in the 64-token bucket. The JAX
app runs with ``moe_fused_kernel_enabled=True`` (its Pallas kernel in
interpret mode), or with its default (the dense all-experts decode) where
named. On CPU tensors B7's wrapper takes its plain version."""

import functools

import numpy as np
import pytest
import torch
import transformers

from neuronx_distributed_inference_tpu.config import MoETpuConfig, TpuConfig
from neuronx_distributed_inference_tpu.models.llama import LlamaInferenceConfig as JaxConfig
from neuronx_distributed_inference_tpu.runtime.application import TpuModelForCausalLM
from neuronx_distributed_inference_tpu_torch.config import Config, InferenceConfig, MoEConfig
from neuronx_distributed_inference_tpu_torch.models.builder import params_from_jax
from neuronx_distributed_inference_tpu_torch.ops import _cuda
from neuronx_distributed_inference_tpu_torch.runtime.application import ModelForCausalLM

COMMON = dict(
    vocab_size=128, hidden_size=128, num_hidden_layers=2, num_attention_heads=2, num_key_value_heads=1,
    rms_norm_eps=1e-5, max_position_embeddings=256, tie_word_embeddings=False,
    attn_implementation="eager", eos_token_id=None, bos_token_id=None,
)
MODELS = {
    "mixtral": (
        transformers.MixtralConfig, transformers.MixtralForCausalLM,
        dict(intermediate_size=96, num_local_experts=4, num_experts_per_tok=2),
    ),
    "qwen3_moe": (
        transformers.Qwen3MoeConfig, transformers.Qwen3MoeForCausalLM,
        dict(intermediate_size=256, moe_intermediate_size=64, num_experts=32, num_experts_per_tok=2,
             norm_topk_prob=True, head_dim=64, decoder_sparse_step=1),
    ),
    "qwen3": (
        transformers.Qwen3Config, transformers.Qwen3ForCausalLM,
        dict(intermediate_size=256, head_dim=64),
    ),
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
N_NEW = 10
ATOL = 1e-4


def _attrs(name):
    cls, _, extra = MODELS[name]
    cfg = cls(**COMMON, **extra)
    attrs = dict(model_type=name, hidden_act="silu", rope_theta=getattr(cfg, "rope_theta", 10000.0))
    for k in ("hidden_size", "intermediate_size", "num_hidden_layers", "num_attention_heads",
              "num_key_value_heads", "vocab_size", "rms_norm_eps", "tie_word_embeddings",
              "num_local_experts", "num_experts", "num_experts_per_tok", "moe_intermediate_size",
              "norm_topk_prob", "head_dim", "decoder_sparse_step"):
        if getattr(cfg, k, None) is not None:
            attrs[k] = getattr(cfg, k)
    return attrs


def _load(attrs):
    return lambda c: [setattr(c, k, v) for k, v in attrs.items()]


@functools.lru_cache(maxsize=None)
def _hf_model(name):
    """(name, HF model, state dict), built from seed 0."""
    torch.set_num_threads(1)
    cls, model_cls, extra = MODELS[name]
    torch.manual_seed(0)
    hf = model_cls(cls(**COMMON, **extra)).eval().float()
    sd = {k: v.detach().numpy() for k, v in hf.state_dict().items()}
    return name, hf, sd


@pytest.fixture(params=sorted(MODELS))
def model(request):
    return _hf_model(request.param)


@pytest.fixture(params=["mixtral", "qwen3_moe"])
def moe_model(request):
    return _hf_model(request.param)


def _jax_app(name, sd, fused=True, **tc):
    moe = name != "qwen3"
    kw = {**TC, **tc}
    if moe and fused:
        kw["moe_fused_kernel_enabled"] = True
    tcfg = (MoETpuConfig if moe else TpuConfig)(**kw)
    return TpuModelForCausalLM(None, JaxConfig(tcfg, load_config=_load(_attrs(name)))).load(state_dict=sd)


def _port_app(name, sd=None, params=None, **tc):
    cls = MoEConfig if name != "qwen3" else Config
    cfg = InferenceConfig(cls(**{**TC, **tc, "device": "cpu"}), load_config=_load(_attrs(name)))
    app = ModelForCausalLM(None, cfg)
    return app.load(params=params) if params is not None else app.load(state_dict=sd)


def _routes():
    return {k: v for k, v in _cuda.route_counts().items() if k != "int4_dense"}


@pytest.mark.parametrize("prompt", ["short", "long"])
@pytest.mark.parametrize("fused_qkv", [False, True])
def test_moe_generate_matches_jax(model, prompt, fused_qkv):
    """Both prompt buckets, both QKV layouts; the port on the JAX app's
    params. Route counts of the port's prefill: the 16-token bucket goes to
    B7 (no route counted), the 64-token bucket to the grouped route
    (Qwen3-MoE) or the dense route (Mixtral)."""
    import jax

    name, _, sd = model
    ids, mask = (SHORT, SHORT_MASK) if prompt == "short" else (LONG, LONG_MASK)
    jax_app = _jax_app(name, sd, fused_qkv=fused_qkv)
    ref = jax_app.generate(ids, mask, max_new_tokens=N_NEW)
    port = _port_app(name, params=params_from_jax(jax.device_get(jax_app.params), torch.float32, "cpu"),
                     fused_qkv=fused_qkv)
    _cuda.reset_launch_counts()
    out = port.generate(ids, mask, max_new_tokens=N_NEW)
    np.testing.assert_array_equal(out.sequences, ref.sequences)
    np.testing.assert_allclose(out.logits, np.asarray(ref.logits), atol=ATOL, rtol=0)
    assert _cuda.launch_counts() == {n: 0 for n in _cuda.KERNELS}
    L = 2
    want = {"moe_dense": 0, "moe_grouped": 0, "moe_capacity": 0}
    if prompt == "long" and name == "qwen3_moe":
        want["moe_grouped"] = L
    elif prompt == "long" and name == "mixtral":
        want["moe_dense"] = L
    assert _routes() == want


def test_moe_decode_matches_jax_dense_default(moe_model):
    """The JAX app's default MoE decode is the dense all-experts route; the
    port's is B7 (its plain version here): the same tokens and logits."""
    name, _, sd = moe_model
    ref = _jax_app(name, sd, fused=False).generate(SHORT, SHORT_MASK, max_new_tokens=N_NEW)
    out = _port_app(name, sd=sd).generate(SHORT, SHORT_MASK, max_new_tokens=N_NEW)
    np.testing.assert_array_equal(out.sequences, ref.sequences)
    np.testing.assert_allclose(out.logits, np.asarray(ref.logits), atol=ATOL, rtol=0)


def test_moe_dense_route_when_the_kernel_is_off(moe_model):
    """``moe_fused_kernel_enabled=False`` sends every call to the dense
    route, counted once per layer and pass; the tokens do not change."""
    name, _, sd = moe_model
    on = _port_app(name, sd=sd).generate(SHORT, SHORT_MASK, max_new_tokens=N_NEW)
    off_app = _port_app(name, sd=sd, moe_fused_kernel_enabled=False)
    _cuda.reset_launch_counts()
    off = off_app.generate(SHORT, SHORT_MASK, max_new_tokens=N_NEW)
    np.testing.assert_array_equal(off.sequences, on.sequences)
    np.testing.assert_allclose(off.logits, on.logits, atol=ATOL, rtol=0)
    # one prefill and N_NEW - 1 decode steps (one chunk of 16) over 2 layers
    assert _routes() == {"moe_dense": 2 * (1 + 16), "moe_grouped": 0, "moe_capacity": 0}


def test_moe_generate_matches_hf(model):
    """Greedy tokens per unpadded row against HF transformers, logits within
    1e-3, the port loading the HF state dict itself."""
    name, hf, sd = model
    port = _port_app(name, sd=sd)
    for ids, mask in ((SHORT, SHORT_MASK), (LONG, LONG_MASK)):
        S = ids.shape[1]
        out = port.generate(ids, mask, max_new_tokens=8)
        for b in range(2):
            valid = int(mask[b].sum())
            row = np.concatenate([ids[b, :valid], out.sequences[b, S:]])
            with torch.no_grad():
                hf_out = hf.generate(
                    input_ids=torch.tensor(ids[b : b + 1, :valid]), max_new_tokens=8, do_sample=False,
                    pad_token_id=0,
                )
                hf_logits = hf(input_ids=torch.tensor(row[None, :])).logits[0].numpy()
            np.testing.assert_array_equal(out.sequences[b, S:], hf_out[0, valid:].numpy())
            for i in range(8):
                np.testing.assert_allclose(out.logits[b, i], hf_logits[valid + i - 1], atol=1e-3, rtol=1e-3)


def test_random_params_fill_one_layer_slice_at_a_time(monkeypatch):
    """random_params allocates each leaf once in the target dtype and draws
    its fp32 numbers one layer's slice at a time: the largest draw is one
    layer of the expert leaf, never a whole stacked leaf, so the load's peak
    stays near the params' own bytes. Norms (q/k norms too) are ones, the
    rest std 0.02, and the same seed gives the same weights."""
    name = "qwen3_moe"
    cfg = InferenceConfig(MoEConfig(**{**TC, "dtype": "bfloat16", "device": "cpu"}), load_config=_load(_attrs(name)))
    builder = ModelForCausalLM(None, cfg).builder
    draws = []
    randn = torch.randn

    def spy(*args, **kw):
        out = randn(*args, **kw)
        draws.append(out.numel())
        return out

    monkeypatch.setattr(torch, "randn", spy)
    params = builder.random_params()
    monkeypatch.setattr(torch, "randn", randn)
    L, E, H, I = 2, 32, 128, 64
    assert max(draws) == E * H * I
    gate = params["layers"]["mlp"]["experts"]["gate_proj"]["weight"]
    assert tuple(gate.shape) == (L, E, H, I) and gate.dtype == torch.bfloat16
    assert abs(gate.float().std().item() - 0.02) < 1e-3
    layers = params["layers"]
    for norm in (layers["input_layernorm"], layers["post_attention_layernorm"], params["norm"],
                 layers["self_attn"]["q_norm"], layers["self_attn"]["k_norm"]):
        assert norm["weight"].dtype == torch.bfloat16 and bool((norm["weight"] == 1).all())
    assert tuple(layers["self_attn"]["q_norm"]["weight"].shape) == (L, 64)
    again = builder.random_params()
    assert torch.equal(again["layers"]["mlp"]["router"]["weight"], layers["mlp"]["router"]["weight"])
    assert torch.equal(again["lm_head"]["weight"], params["lm_head"]["weight"])
