"""DBRX in the port, held against the JAX package (and HF ``transformers``'
``DbrxForCausalLM`` built in-process from a seed) on the CPU:

- ``layer_norm`` / ``apply_norm`` against the reference's, fp32 and bf16;
- the JAX oracle's config (``tests/test_model_hub2.py::test_dbrx_hf_parity``:
  head_dim 16, so the attention kernels' wrappers, which take 64 or 128,
  are off) and a head_dim-64 config through the kernels' plain versions:
  greedy tokens identical to JAX's and HF's, logits within 1e-4 of JAX's
  at fp32 (ATOL); p-norm routing at p = 1, 2 and None; a ``clip_qkv``
  small enough to change the logits, on the split and the fused QKV;
  bf16 within BF16_ATOL of JAX's bf16 logits at every generated position;
- the paged ``ServingSession``, split (chunked prefill) and ragged: streams
  equal to the JAX sessions' and to isolated ``generate()`` runs;
- the B8 gate: LayerNorm and the clip keep a decode step off the fused
  attention block."""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from transformers import DbrxConfig, DbrxForCausalLM

from neuronx_distributed_inference_tpu.config import ChunkedPrefillConfig as JaxChunked
from neuronx_distributed_inference_tpu.config import TpuConfig
from neuronx_distributed_inference_tpu.models.dbrx import DbrxInferenceConfig as JaxDbrxConfig
from neuronx_distributed_inference_tpu.modules.norm import apply_norm as jax_apply_norm
from neuronx_distributed_inference_tpu.runtime.application import TpuModelForCausalLM
from neuronx_distributed_inference_tpu.runtime.serving import ServingSession as JaxSession
from neuronx_distributed_inference_tpu_torch.config import ChunkedPrefillConfig, MoEConfig
from neuronx_distributed_inference_tpu_torch.models.builder import params_from_jax
from neuronx_distributed_inference_tpu_torch.models.dbrx import DbrxInferenceConfig
from neuronx_distributed_inference_tpu_torch.modules.attention import AttnSpec
from neuronx_distributed_inference_tpu_torch.modules.norm import apply_norm, layer_norm
from neuronx_distributed_inference_tpu_torch.ops import _cuda, kernel_mode
from neuronx_distributed_inference_tpu_torch.runtime.application import ModelForCausalLM
from neuronx_distributed_inference_tpu_torch.runtime.serving import ServingSession

PROMPT = np.array([[5, 17, 92, 41, 33, 88, 2, 11], [64, 3, 27, 9, 14, 0, 0, 0]])
MASK = np.array([[1] * 8, [1] * 5 + [0] * 3])
N_NEW = 6
ATOL = 1e-4
#: bf16 logits of the two packages, each rounding its own bf16 products:
#: about 3x the largest gap measured on test_bf16_matches_jax_within_tolerance's
#: inputs (4.2e-3, every position; typical |logit| 0.18)
BF16_ATOL = 1.2e-2
#: the JAX oracle's config (head_dim 16)
ORACLE = dict(
    d_model=64, n_heads=4, n_layers=2, max_seq_len=256, vocab_size=128,
    attn_config=dict(kv_n_heads=2, rope_theta=10000.0, clip_qkv=8.0),
    ffn_config=dict(ffn_hidden_size=32, moe_num_experts=4, moe_top_k=2),
)
#: the kernels' head_dim: 2 q / 1 kv heads of 64
WIDE = dict(
    d_model=128, n_heads=2, n_layers=2, max_seq_len=256, vocab_size=128,
    attn_config=dict(kv_n_heads=1, rope_theta=10000.0, clip_qkv=8.0),
    ffn_config=dict(ffn_hidden_size=64, moe_num_experts=4, moe_top_k=2),
)
KERNELS_OFF = dict(attn_kernel_enabled=False, attn_block_tkg_kernel_enabled=False)
GEN = dict(batch_size=2, seq_len=64, dtype="float32", output_logits=True)
SERVE = dict(is_continuous_batching=True, batch_size=3, ctx_batch_size=1, seq_len=64, dtype="float32")
PAGED = dict(is_block_kv_layout=True, pa_block_size=16, pa_num_blocks=16, is_chunked_prefill=True)
REQS = {"short": [5, 17, 92, 41], "long": list(range(30, 44)), "mid": [64, 3, 27, 9, 14, 33]}


def _hf(cfg: dict, seed=0, **ffn):
    cfg = dict(cfg, ffn_config=dict(cfg["ffn_config"], **ffn))
    torch.manual_seed(seed)
    hf = DbrxForCausalLM(DbrxConfig(**cfg, attn_implementation="eager", pad_token_id=0)).eval().float()
    return hf, {k: v.float().numpy() for k, v in hf.state_dict().items()}


def _loader(hf, **over):
    attrs = dict(hf.config.to_dict(), **over)

    def load(c):
        c.model_type = "dbrx"
        for k, v in attrs.items():
            setattr(c, k, v)

    return load


def _jax_app(hf, sd, over=None, **kw):
    kw = {**GEN, **kw}
    if "chunked" in kw:
        kw["chunked_prefill_config"] = JaxChunked(**kw.pop("chunked"))
    cfg = JaxDbrxConfig(TpuConfig(**kw), load_config=_loader(hf, **(over or {})))
    return TpuModelForCausalLM(None, cfg).load(state_dict=sd)


def _port_app(hf, sd=None, over=None, params=None, **kw):
    kw = {**GEN, **kw}
    if "chunked" in kw:
        kw["chunked_prefill_config"] = ChunkedPrefillConfig(**kw.pop("chunked"))
    app = ModelForCausalLM(None, DbrxInferenceConfig(MoEConfig(**kw, device="cpu"), load_config=_loader(hf, **(over or {}))))
    return app.load(params=params) if params is not None else app.load(state_dict=sd)


def _same(port_out, jax_out, atol=ATOL):
    np.testing.assert_array_equal(port_out.sequences, np.asarray(jax_out.sequences))
    np.testing.assert_allclose(port_out.logits, np.asarray(jax_out.logits), atol=atol, rtol=0)


def _hf_tokens(hf, n=N_NEW):
    out = []
    for b in range(PROMPT.shape[0]):
        v = int(MASK[b].sum())
        with torch.no_grad():
            seq = hf.generate(torch.tensor(PROMPT[b : b + 1, :v]), max_new_tokens=n, do_sample=False, pad_token_id=0)
        out.append(seq[0, v:].numpy())
    return np.stack(out)


@pytest.fixture(scope="module", autouse=True)
def _threads():
    torch.set_num_threads(1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_bias", [False, True])
def test_layer_norm_matches_reference(dtype, with_bias):
    rng = np.random.RandomState(7)
    x = (rng.randn(3, 5, 96) * 3 + 1.5).astype(np.float32)
    w = rng.randn(96).astype(np.float32)
    b = rng.randn(96).astype(np.float32) if with_bias else None
    jdt = {"float32": jax.numpy.float32, "bfloat16": jax.numpy.bfloat16}[dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    want = np.asarray(
        jax_apply_norm(jax.numpy.asarray(x, jdt), jax.numpy.asarray(w), 1e-5, "layernorm",
                       bias=None if b is None else jax.numpy.asarray(b)).astype(jax.numpy.float32)
    )
    tb = None if b is None else torch.from_numpy(b)
    got = apply_norm(torch.from_numpy(x).to(tdt), torch.from_numpy(w), 1e-5, "layernorm", bias=tb)
    assert got.dtype == tdt
    # fp32: the frameworks' reductions round differently; bf16: one bf16
    # ulp of the output
    tol = 2e-6 if dtype == "float32" else 2 ** -7 * float(np.abs(want).max())
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=0)
    assert torch.equal(layer_norm(torch.from_numpy(x), torch.from_numpy(w), tb), apply_norm(
        torch.from_numpy(x), torch.from_numpy(w), 1e-5, "layernorm", bias=tb))
    with pytest.raises(ValueError, match="norm kind"):
        apply_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5, "groupnorm")


def test_oracle_config_matches_jax_and_hf():
    """The JAX oracle's config: tokens equal to JAX's and HF's, logits
    within ATOL of JAX's; the plain attention (head_dim 16)."""
    hf, sd = _hf(ORACLE)
    port = _port_app(hf, sd, **KERNELS_OFF)
    assert port.spec.norm_type == "layernorm" and port.spec.attn.qkv_clip == 8.0
    assert port.builder.moe_spec().norm_weights_p == 1.0
    out = port.generate(PROMPT, MASK, max_new_tokens=N_NEW)
    _same(out, _jax_app(hf, sd).generate(PROMPT, MASK, max_new_tokens=N_NEW))
    np.testing.assert_array_equal(out.sequences[:, PROMPT.shape[1]:], _hf_tokens(hf))


@pytest.mark.parametrize("p", [1, 2, None])
def test_p_norm_routing_matches_jax_and_hf(p):
    """p-norm renormalized routing (None: the softmax weights as they are)
    at the kernels' head_dim: tokens equal to JAX's and HF's, no kernel
    launched on the CPU (B2 / B1 / B7 take their plain versions)."""
    hf, sd = _hf(WIDE, seed=1, moe_normalize_expert_weights=p)
    port = _port_app(hf, sd)
    assert port.builder.moe_spec().norm_weights_p == (None if p is None else float(p))
    _cuda.reset_launch_counts()
    out = port.generate(PROMPT, MASK, max_new_tokens=N_NEW)
    assert _cuda.launch_counts() == {n: 0 for n in _cuda.KERNELS}
    _same(out, _jax_app(hf, sd).generate(PROMPT, MASK, max_new_tokens=N_NEW))
    np.testing.assert_array_equal(out.sequences[:, PROMPT.shape[1]:], _hf_tokens(hf))


def test_biting_clip_matches_jax_on_both_qkv_layouts():
    """At clip 0.05 the clamp changes the logits (against no clip) in both
    packages; with it the port equals JAX, on the split q/k/v and on the
    fused QKV."""
    hf, sd = _hf(WIDE, seed=2)
    logits = {}
    for clip in (None, 0.05):
        over = dict(attn_config=dict(WIDE["attn_config"], clip_qkv=clip))
        jax_out = _jax_app(hf, sd, over).generate(PROMPT, MASK, max_new_tokens=N_NEW)
        for fused in (False, True):
            port = _port_app(hf, sd, over, fused_qkv=fused)
            assert port.spec.attn.qkv_clip == clip
            _same(port.generate(PROMPT, MASK, max_new_tokens=N_NEW), jax_out)
        logits[clip] = np.asarray(jax_out.logits)
    assert np.abs(logits[None] - logits[0.05]).max() > 1e-2


def test_bf16_matches_jax_within_tolerance():
    hf, sd = _hf(WIDE, seed=3)
    port = _port_app(hf, sd, dtype="bfloat16")
    jax_out = _jax_app(hf, sd, dtype="bfloat16").generate(PROMPT, MASK, max_new_tokens=N_NEW)
    out = port.generate(PROMPT, MASK, max_new_tokens=N_NEW)
    np.testing.assert_array_equal(out.sequences, np.asarray(jax_out.sequences))
    np.testing.assert_allclose(out.logits, np.asarray(jax_out.logits, np.float32), atol=BF16_ATOL, rtol=0)


def test_weight_carry_and_random_params():
    """The JAX app's params, fetched as numpy, run in the port as they are;
    the port's random params carry every leaf of them (norms ones)."""
    hf, sd = _hf(WIDE, seed=4)
    jax_app = _jax_app(hf, sd)
    tree = jax.tree.map(np.asarray, jax_app.params)
    port = _port_app(hf, params=params_from_jax(tree, torch.float32, "cpu"))
    _same(port.generate(PROMPT, MASK, max_new_tokens=N_NEW), jax_app.generate(PROMPT, MASK, max_new_tokens=N_NEW))

    def shapes(t):
        return {k: shapes(v) for k, v in t.items()} if isinstance(t, dict) else tuple(t.shape)

    rnd = port.builder.random_params()
    assert shapes(rnd) == shapes(tree)
    assert torch.equal(rnd["norm"]["weight"], torch.ones_like(rnd["norm"]["weight"]))


def _drive(sess):
    items = list(REQS.items())
    assert sess.add_request(items[0][0], items[0][1], max_new_tokens=6)
    sess.step()
    for rid, p in items[1:]:
        assert sess.add_request(rid, p, max_new_tokens=6)
    return sess.run_to_completion()


@pytest.mark.parametrize("layout", ["paged_split", "paged_ragged"])
def test_serving_session_matches_generate_and_jax(layout):
    hf, sd = _hf(WIDE, seed=5)
    kw = dict(SERVE, **PAGED, chunked=dict(max_num_seqs=2, kernel_q_tile_size=16))
    if layout == "paged_ragged":
        kw["serving_ragged"] = True
    gen = _port_app(hf, sd, batch_size=1)
    golden = {}
    for rid, p in REQS.items():
        ids = np.asarray(p)[None, :]
        golden[rid] = gen.generate(ids, np.ones_like(ids), max_new_tokens=6).sequences[0, ids.shape[1]:].tolist()
    port = _port_app(hf, sd, **kw)
    assert (port.mixed_step_model is not None) == (layout == "paged_ragged")
    got = _drive(ServingSession(port))
    assert got == golden
    assert got == _drive(JaxSession(_jax_app(hf, sd, **kw)))


def test_fused_block_gate_keeps_layernorm_and_clip_off_b8():
    """B8 with fused_attn_block_kernel_enabled: DBRX (LayerNorm, clip)
    never reaches it, and a clip alone keeps an rmsnorm spec off it."""
    spec = AttnSpec(num_heads=2, num_kv_heads=1, head_dim=64, use_fused_block=True)
    assert kernel_mode.use_fused_attn_block(spec, 1)
    assert not kernel_mode.use_fused_attn_block(dataclasses.replace(spec, qkv_clip=8.0), 1)
    hf, sd = _hf(WIDE, seed=6)
    port = _port_app(hf, sd, fused_qkv=True, fused_attn_block_kernel_enabled=True, fused_mlp_kernel_enabled=True)
    from neuronx_distributed_inference_tpu_torch.ops import decode_block

    calls = []
    real = decode_block.fused_attn_block
    decode_block.fused_attn_block = lambda *a, **k: calls.append(1) or real(*a, **k)
    try:
        out = port.generate(PROMPT, MASK, max_new_tokens=N_NEW)
    finally:
        decode_block.fused_attn_block = real
    assert calls == []
    # the JAX package converts DBRX unfused (its fused_qkv layout is the
    # same product)
    _same(out, _jax_app(hf, sd).generate(PROMPT, MASK, max_new_tokens=N_NEW))
