"""The port's fused speculation (``runtime/fused_spec.py``) and its device
functions (``modules/speculation.py``), held against the JAX package's on
the CPU, fp32, with the same tiny head_dim-64 Llama target (one HF state
dict loaded into both) and a draft from its own seed (7), or the target's
weights as the draft (0).

- Greedy ``generate()`` streams equal the JAX fused app's and plain
  ``generate()``'s, with a right-padded row and with an EOS.
- A draft equal to the target accepts every draft: each round commits k.
- ``speculative_token_selection``'s first-token marginal matches the
  target distribution whatever q is (total variation under 0.05 over 6000
  draws); the port's generator differs from JAX's keys, so the sampled
  paths are held by distribution, not by token. Its greedy limit (one-hot
  p and q) truncates at the first mismatch.
- The programs seal: a generate() of the warmed shapes builds nothing.
- The EAGLE app builds beside it (``tests/test_torch_eagle.py`` holds it
  against JAX), and the reference's cross-checks of the EAGLE, tree and
  Medusa fields raise its ValueError."""

import numpy as np
import pytest
import torch

from neuronx_distributed_inference_tpu.config import FusedSpecConfig as JaxFusedSpecConfig
from neuronx_distributed_inference_tpu.config import TpuConfig
from neuronx_distributed_inference_tpu.models.llama import LlamaInferenceConfig as JaxLlamaConfig
from neuronx_distributed_inference_tpu.runtime.fused_spec import TpuFusedSpecModelForCausalLM
from neuronx_distributed_inference_tpu_torch.analysis.retrace_guard import RetraceGuard
from neuronx_distributed_inference_tpu_torch.config import Config, FusedSpecConfig
from neuronx_distributed_inference_tpu_torch.models.llama import LlamaInferenceConfig
from neuronx_distributed_inference_tpu_torch.modules.speculation import speculative_token_selection
from neuronx_distributed_inference_tpu_torch.ops import _cuda
from neuronx_distributed_inference_tpu_torch.runtime.application import ModelForCausalLM
from neuronx_distributed_inference_tpu_torch.runtime.fused_spec import (
    EagleSpecModelForCausalLM,
    FusedSpecModelForCausalLM,
)
from tests.conftest import make_random_hf_state_dict

K = 4
HF = dict(
    model_type="llama", hidden_size=256, intermediate_size=256, num_attention_heads=4,
    num_key_value_heads=2, num_hidden_layers=2, vocab_size=128, rms_norm_eps=1e-5,
    rope_theta=10000.0, max_position_embeddings=256, hidden_act="silu", tie_word_embeddings=False,
)
GEN = dict(batch_size=2, seq_len=64, dtype="float32")
SPEC = dict(GEN, speculation_length=K, enable_fused_speculation=True)
PROMPTS = np.array([[5, 17, 92, 41, 33, 88, 2, 11], [64, 3, 27, 9, 14, 0, 0, 0]])
MASK = np.array([[1, 1, 1, 1, 1, 1, 1, 1], [1, 1, 1, 1, 1, 0, 0, 0]])


def _load(c):
    for k, v in HF.items():
        setattr(c, k, v)


def _port_cfg(**kw):
    return LlamaInferenceConfig(Config(**kw, device="cpu"), load_config=_load)


def _port_fused(sds, draft_seed, **kw):
    cfg = _port_cfg(**SPEC, **kw)
    cfg.fused_spec_config = FusedSpecConfig(draft_config=_port_cfg(**GEN, **kw))
    return FusedSpecModelForCausalLM(None, cfg).load(target_state_dict=sds[0], draft_state_dict=sds[draft_seed])


@pytest.fixture(scope="module")
def sds():
    torch.set_num_threads(1)
    cfg = JaxLlamaConfig(TpuConfig(**GEN), load_config=_load)
    return {seed: make_random_hf_state_dict(cfg, seed=seed) for seed in (0, 7)}


@pytest.fixture(scope="module")
def plain(sds):
    return ModelForCausalLM(None, _port_cfg(**GEN)).load(state_dict=sds[0])


@pytest.mark.parametrize("draft_seed", [7, 0])
def test_fused_greedy_matches_jax_and_generate(sds, plain, draft_seed):
    ref = plain.generate(PROMPTS, MASK, max_new_tokens=12).sequences
    jcfg = JaxLlamaConfig(TpuConfig(**SPEC), load_config=_load)
    jcfg.fused_spec_config = JaxFusedSpecConfig(
        draft_model_name="tiny-draft", draft_config=JaxLlamaConfig(TpuConfig(**GEN), load_config=_load)
    )
    japp = TpuFusedSpecModelForCausalLM(None, jcfg).load(target_state_dict=sds[0], draft_state_dict=sds[draft_seed])
    app = _port_fused(sds, draft_seed)
    _cuda.reset_launch_counts()
    for eos in (None, int(ref[0, 8 + 5])):
        jout = japp.generate(PROMPTS, MASK, max_new_tokens=12, eos_token_id=eos)
        out = app.generate(PROMPTS, MASK, max_new_tokens=12, eos_token_id=eos)
        np.testing.assert_array_equal(out.sequences, np.asarray(jout.sequences))
        assert out.num_generated == jout.num_generated
        if eos is None:
            np.testing.assert_array_equal(out.sequences[:, : ref.shape[1]], ref)
    assert set(_cuda.launch_counts().values()) == {0}  # CPU: plain versions only


def test_full_acceptance_when_the_draft_is_the_target(sds, plain):
    app = _port_fused(sds, 0)
    counts = []
    orig = app._call

    def call(prog, phase, arrs, bucket, fn):
        tokens, c = orig(prog, phase, arrs, bucket, fn)
        if phase == "tkg":
            counts.append(c.numpy().copy())
        return tokens, c

    app._call = call
    out = app.generate(PROMPTS[:, :4], np.ones((2, 4), np.int64), max_new_tokens=9)
    # 9 tokens: the prefill's first, then two rounds of k
    assert out.num_generated == 9 and len(counts) == 2
    assert all((c == K).all() for c in counts)
    ref = plain.generate(PROMPTS[:, :4], np.ones((2, 4), np.int64), max_new_tokens=9).sequences
    np.testing.assert_array_equal(out.sequences, ref)


def test_seal_and_sampled_generate(sds):
    app = _port_fused(sds, 7)
    first = app.generate(PROMPTS, MASK, max_new_tokens=12).sequences
    app.seal()
    with RetraceGuard() as guard:
        again = app.generate(PROMPTS, MASK, max_new_tokens=12).sequences
    assert guard.traces == [] and (again == first).all()

    sampled = _port_fused(sds, 7, on_device_sampling_config={"do_sample": True, "top_k": 5})
    out = sampled.generate(PROMPTS, MASK, max_new_tokens=12, top_k=5).sequences[:, 8:]
    assert out.shape == (2, 12) and out.min() >= 0 and out.max() < 128
    with pytest.raises(ValueError, match="draft_config"):
        FusedSpecModelForCausalLM(None, _port_cfg(**SPEC))
    eagle_cfg = _port_cfg(**SPEC, enable_eagle_speculation=True)
    eagle_cfg.fused_spec_config = FusedSpecConfig(
        draft_config=LlamaInferenceConfig(
            Config(**GEN, device="cpu"), load_config=_load, model_type="llama-eagle", num_hidden_layers=1
        )
    )
    eagle = EagleSpecModelForCausalLM(None, eagle_cfg).load(random_weights=True)
    assert eagle.hidden_buffer.shape == (3, 256) and eagle.draft_params["fc"]["weight"].shape == (512, 256)


def test_speculative_selection_marginal_matches_target():
    """The first emitted token's marginal is p_0 whatever q is (the
    spec-sampling theorem): 6000 draws at once, TV distance under 0.05."""
    V, k, n = 16, 3, 6000
    rng = np.random.RandomState(0)
    p = torch.from_numpy(rng.dirichlet(np.ones(V), size=k).astype(np.float32))  # (k, V)
    q = torch.from_numpy(rng.dirichlet(np.ones(V), size=k - 1).astype(np.float32))  # (k-1, V)
    gen = torch.Generator().manual_seed(42)
    drafts = torch.stack([torch.multinomial(q[i], n, replacement=True, generator=gen) for i in range(k - 1)], dim=1)
    cand = torch.cat([torch.zeros((n, 1), dtype=torch.int64), drafts], dim=1).to(torch.int32)
    tokens, counts = speculative_token_selection(
        cand, q[None].expand(n, -1, -1), p[None].expand(n, -1, -1), gen
    )
    emp = np.bincount(tokens[:, 0].numpy(), minlength=V) / n
    tv = 0.5 * np.abs(emp - p[0].numpy()).sum()
    assert tv < 0.05, f"TV(emp, p0) = {tv:.3f}"
    assert counts.min() >= 1 and counts.max() <= k


def test_speculative_selection_greedy_limit():
    V, k = 8, 4
    p = torch.zeros((1, k, V))
    q = torch.zeros((1, k - 1, V))
    for i, t in enumerate([1, 2, 3, 4]):
        p[0, i, t] = 1.0
    for i, t in enumerate([1, 2, 7]):
        q[0, i, t] = 1.0
    tokens, counts = speculative_token_selection(
        torch.tensor([[0, 1, 2, 7]], dtype=torch.int32), q, p, torch.Generator().manual_seed(0)
    )
    assert counts.tolist() == [3]
    assert tokens[0, :3].tolist() == [1, 2, 3]


@pytest.mark.parametrize(
    "kw, match",
    [
        (dict(enable_eagle_speculation=True, speculation_length=4), "EAGLE speculation requires fused"),
        (dict(is_eagle3=True), "is_eagle3 requires enable_eagle_speculation"),
        (dict(token_tree_config={"step": 2}), "token_tree_config requires enable_eagle_speculation"),
        (dict(medusa_speculation_length=2), "medusa requires num_medusa_heads"),
    ],
)
def test_speculation_outside_the_slice_raises(kw, match):
    """Speculation settings outside what the reference's cross-checks allow
    (its config.py:797-808: EAGLE without fused speculation, EAGLE3 or a
    tree without EAGLE, Medusa without heads) raise its ValueError."""
    with pytest.raises(ValueError, match=match):
        Config(device="cpu", **kw)
