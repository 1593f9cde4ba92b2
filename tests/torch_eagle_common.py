"""Shared builders of the EAGLE, token-tree and Medusa tests: one tiny
head_dim-64 Llama target (2 or 4 layers) and EAGLE / EAGLE3 drafts as HF
state dicts made from a seed with numpy, loaded into the JAX package's app
and the port's, fp32 on the CPU; and the per-round acceptance counts of
either app's generate()."""

import numpy as np

from neuronx_distributed_inference_tpu.config import FusedSpecConfig as JaxFusedSpecConfig
from neuronx_distributed_inference_tpu.config import TpuConfig
from neuronx_distributed_inference_tpu.models.llama import LlamaInferenceConfig as JaxLlamaConfig
from neuronx_distributed_inference_tpu_torch.config import Config, FusedSpecConfig
from neuronx_distributed_inference_tpu_torch.models.llama import LlamaInferenceConfig
from tests.conftest import make_random_hf_state_dict

HF = dict(
    model_type="llama", hidden_size=256, intermediate_size=256, num_attention_heads=4,
    num_key_value_heads=2, num_hidden_layers=2, vocab_size=128, rms_norm_eps=1e-5,
    rope_theta=10000.0, max_position_embeddings=256, hidden_act="silu", tie_word_embeddings=False,
)
GEN = dict(batch_size=2, seq_len=64, dtype="float32")
PROMPTS = np.array([[5, 17, 92, 41, 33, 88, 2, 11], [64, 3, 27, 9, 14, 0, 0, 0]])
MASK = np.array([[1, 1, 1, 1, 1, 1, 1, 1], [1, 1, 1, 1, 1, 0, 0, 0]])
#: the EAGLE chain's speculation length in these tests
K = 4


def hf_attrs(**kw):
    attrs = dict(HF, **kw)

    def load(c):
        for k, v in attrs.items():
            setattr(c, k, v)

    return load


def jax_cfg(hf=None, **tc):
    return JaxLlamaConfig(TpuConfig(**dict(GEN, **tc)), load_config=hf_attrs(**(hf or {})))


def port_cfg(hf=None, **tc):
    return LlamaInferenceConfig(Config(**dict(GEN, **tc), device="cpu"), load_config=hf_attrs(**(hf or {})))


def target_sd(seed, layers=2):
    return make_random_hf_state_dict(jax_cfg(dict(num_hidden_layers=layers)), seed=seed)


def eagle_draft_sd(seed, tsd=None, eagle3=False, draft_vocab=None, input_norm=False, correlated=False):
    """An EAGLE draft's HF state dict. v1: one llama layer, ``fc.weight``
    (H, 2H) and, with ``input_norm``, ``input_norm.weight``. EAGLE3 (H,
    2H)-wide q/k/v, ``hidden_norm``, ``fc.weight`` (H, 3H) and, with
    ``draft_vocab``, a reduced lm head and a ``d2t`` table mapping draft
    token d to a distinct target token (a seeded permutation).
    ``correlated`` (v1): the target's embedding, lm head, final norm and
    layer 0 with a pass-through fc (the reference's spec_bench draft)."""
    rng = np.random.RandomState(seed)
    H, I, V = HF["hidden_size"], HF["intermediate_size"], HF["vocab_size"]
    D = H // HF["num_attention_heads"]
    Hq, Hkv = HF["num_attention_heads"], HF["num_key_value_heads"]

    def w(*shape):
        return (rng.randn(*shape) * 0.05).astype(np.float32)

    if correlated and not eagle3:
        sd = {k: v for k, v in tsd.items() if not k.startswith("model.layers.") or k.startswith("model.layers.0.")}
        fc = np.zeros((2 * H, H), np.float32)
        fc[H:, :] = np.eye(H)
        sd["fc.weight"] = fc.T.copy()
        return sd
    fan = 2 * H if eagle3 else H
    p = "model.layers.0."
    sd = {
        "model.embed_tokens.weight": w(V, H),
        "model.norm.weight": (1 + 0.1 * rng.randn(H)).astype(np.float32),
        "lm_head.weight": w(draft_vocab or V, H),
        p + "self_attn.q_proj.weight": w(Hq * D, fan),
        p + "self_attn.k_proj.weight": w(Hkv * D, fan),
        p + "self_attn.v_proj.weight": w(Hkv * D, fan),
        p + "self_attn.o_proj.weight": w(H, Hq * D),
        p + "mlp.gate_proj.weight": w(I, H),
        p + "mlp.up_proj.weight": w(I, H),
        p + "mlp.down_proj.weight": w(H, I),
        p + "input_layernorm.weight": (1 + 0.1 * rng.randn(H)).astype(np.float32),
        p + "post_attention_layernorm.weight": (1 + 0.1 * rng.randn(H)).astype(np.float32),
        "fc.weight": w(H, (3 if eagle3 else 2) * H),
    }
    if eagle3:
        sd[p + "hidden_norm.weight"] = (1 + 0.1 * rng.randn(H)).astype(np.float32)
        ids = np.arange(V)
        if draft_vocab:
            ids = rng.permutation(V)[:draft_vocab]
            sd["d2t"] = (ids - np.arange(draft_vocab)).astype(np.int64)
        if correlated:
            # the target's embedding, final norm and lm head (the d2t rows
            # of it), no attention or MLP output, and fc passing the first
            # tap through: the draft proposes what the target's first
            # tapped layer predicts
            sd["model.embed_tokens.weight"] = tsd["model.embed_tokens.weight"]
            sd["model.norm.weight"] = tsd["model.norm.weight"]
            sd["lm_head.weight"] = tsd["lm_head.weight"][ids]
            sd[p + "self_attn.o_proj.weight"] = np.zeros((H, Hq * D), np.float32)
            sd[p + "mlp.down_proj.weight"] = np.zeros((H, I), np.float32)
            fc = np.zeros((3 * H, H), np.float32)
            fc[:H, :] = np.eye(H)
            sd["fc.weight"] = fc.T.copy()
    if input_norm:
        sd["input_norm.weight"] = (1 + 0.1 * rng.randn(H)).astype(np.float32)
    return sd


def _spec_tc(k, tree, eagle3, input_norm, sample):
    tc = dict(
        speculation_length=k, enable_fused_speculation=True, enable_eagle_speculation=True, is_eagle3=eagle3,
        enable_eagle_draft_input_norm=input_norm, token_tree_config=tree,
    )
    if sample:
        tc["on_device_sampling_config"] = dict(do_sample=True, top_k=sample)
    return tc


def eagle_apps(tsd, dsd, *, k=K, tree=None, eagle3=False, draft_vocab=None, input_norm=False, layers=2,
               sample=None, seed=0, jax=True, **extra):
    """(the JAX app, the port's app) loaded from the same HF state dicts;
    the JAX app is None with ``jax=False``. ``extra``: more config fields of
    both apps and their drafts (the fused decode layer, fused QKV)."""
    from neuronx_distributed_inference_tpu.config import OnDeviceSamplingConfig
    from neuronx_distributed_inference_tpu.runtime.fused_spec import TpuEagleSpecModelForCausalLM
    from neuronx_distributed_inference_tpu_torch.runtime.fused_spec import EagleSpecModelForCausalLM

    tc = dict(_spec_tc(k, tree, eagle3, input_norm, sample), **extra)
    draft_hf = dict(num_hidden_layers=1, model_type="llama-eagle3" if eagle3 else "llama-eagle")
    if draft_vocab:
        draft_hf["draft_vocab_size"] = draft_vocab
    japp = None
    if jax:
        jtc = dict(tc, seed=seed)
        if sample:
            jtc["on_device_sampling_config"] = OnDeviceSamplingConfig(**tc["on_device_sampling_config"])
        jcfg = jax_cfg(dict(num_hidden_layers=layers), **jtc)
        jcfg.fused_spec_config = JaxFusedSpecConfig(
            draft_model_name="tiny-eagle",
            draft_config=jax_cfg(draft_hf, enable_eagle_draft_input_norm=input_norm, **extra),
        )
        japp = TpuEagleSpecModelForCausalLM(None, jcfg).load(target_state_dict=tsd, draft_state_dict=dsd)
    cfg = port_cfg(dict(num_hidden_layers=layers), seed=seed, **tc)
    cfg.fused_spec_config = FusedSpecConfig(
        draft_config=port_cfg(draft_hf, enable_eagle_draft_input_norm=input_norm, **extra)
    )
    app = EagleSpecModelForCausalLM(None, cfg).load(target_state_dict=tsd, draft_state_dict=dsd)
    return japp, app


def jax_rounds(japp, *args, **kw):
    """generate() of a JAX speculation app and each decode round's counts."""
    counts = []
    orig = japp._call_tkg

    def call(inputs, key):
        out = orig(inputs, key)
        counts.append(np.asarray(out.counts).copy())
        return out

    japp._call_tkg = call
    try:
        return japp.generate(*args, **kw), counts
    finally:
        japp._call_tkg = orig


def port_rounds(app, *args, **kw):
    """generate() of a port speculation app and each decode round's counts."""
    counts = []
    orig = app._call

    def call(prog, phase, arrs, bucket, fn):
        tokens, c = orig(prog, phase, arrs, bucket, fn)
        if phase == "tkg":
            counts.append(c.numpy().copy())
        return tokens, c

    app._call = call
    try:
        return app.generate(*args, **kw), counts
    finally:
        del app._call
