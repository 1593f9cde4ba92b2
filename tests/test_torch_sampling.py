"""Multinomial sampling of the PyTorch port against the JAX package on the
CPU.

- ``warped_probs`` (the distribution ``sample`` draws from: temperature,
  a top-k window, top-p) equals the reference's within 1e-6 over top_k,
  top_p and temperature, ties across the window's edge and top_k = 1
  included.
- 20k draws of the port's ``sample`` pass a chi-square test (scipy, fixed
  seed, p > 1e-3) against ``warped_probs``.
- ``generate()`` with ``do_sample``: the same seed gives the same tokens,
  successive calls draw differently, and ``do_sample=False`` is still the
  JAX package's greedy generate().
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from neuronx_distributed_inference_tpu.config import TpuConfig
from neuronx_distributed_inference_tpu.models.llama import LlamaInferenceConfig as JaxLlamaConfig
from neuronx_distributed_inference_tpu.modules import sampling as jsamp
from neuronx_distributed_inference_tpu.runtime.application import TpuModelForCausalLM
from neuronx_distributed_inference_tpu_torch.config import Config
from neuronx_distributed_inference_tpu_torch.models.llama import LlamaInferenceConfig
from neuronx_distributed_inference_tpu_torch.modules import sampling as tsamp
from neuronx_distributed_inference_tpu_torch.runtime.application import ModelForCausalLM
from tests.conftest import make_random_hf_state_dict

PARAMS = [
    # (top_k, top_p, temperature)
    (1, 1.0, 1.0),
    (5, 1.0, 1.0),
    (-1, 0.9, 1.0),
    (20, 0.7, 0.5),
    (50, 0.95, 1.7),
    (256, 1.0, 0.0),  # temperature 0 clamps to 1e-6: the argmax alone
    (3, 0.3, 2.0),
]


def _logits(B, V, seed, ties=False):
    rng = np.random.RandomState(seed)
    x = (rng.randn(B, V) * 2.0).astype(np.float32)
    if ties:
        # equal values straddling the window's edge and the top-k cut
        top = np.argsort(-x, axis=1)
        for b in range(B):
            x[b, top[b, 3:7]] = x[b, top[b, 3]]
            x[b, top[b, 60:70]] = x[b, top[b, 60]]
    return x


@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
@pytest.mark.parametrize("max_topk", [64, 256])
def test_warped_probs_matches_jax(ties, max_topk):
    B, V = len(PARAMS), 300
    x = _logits(B, V, seed=1 + ties, ties=ties)
    sp = np.array(PARAMS, np.float32)
    ref = np.asarray(jsamp.warped_probs(jnp.asarray(x), jnp.asarray(sp), max_topk))
    out = tsamp.warped_probs(torch.from_numpy(x), torch.from_numpy(sp), max_topk).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(out > 0, ref > 0)
    # top_k = 1 keeps the first maximum only
    assert out[0].argmax() == x[0].argmax() and out[0].max() == 1.0


@pytest.mark.parametrize("params", [(8, 1.0, 0.7), (-1, 0.9, 1.3), (4, 0.8, 1.0)])
def test_draws_match_warped_probs_chi_square(params):
    V, n = 16, 20000
    x = np.tile(_logits(1, V, seed=3), (n, 1))
    sp = np.tile(np.array(params, np.float32), (n, 1))
    probs = tsamp.warped_probs(torch.from_numpy(x[:1]), torch.from_numpy(sp[:1]), 256).numpy()[0]
    gen = torch.Generator().manual_seed(1234)
    draws = tsamp.sample(torch.from_numpy(x), torch.from_numpy(sp), gen, 256).numpy()
    counts = np.bincount(draws, minlength=V)
    kept = probs > 0
    assert counts[~kept].sum() == 0, "a draw outside the warped window"
    expected = probs[kept].astype(np.float64)
    _, p = stats.chisquare(counts[kept], expected / expected.sum() * n)
    assert p > 1e-3, f"chi-square p = {p}"


def test_sample_tokens_per_position_params():
    """(B, K, V) logits draw each position with its row's params; without
    do_sample (or a generator) the call is greedy."""
    x = torch.from_numpy(_logits(6, 40, seed=5)).reshape(2, 3, 40)
    sp = torch.tensor([[1, 1.0, 1.0], [40, 1.0, 1.0]], dtype=torch.float32)
    toks = tsamp.sample_tokens(x, sp, torch.Generator().manual_seed(0), 256, True)
    assert toks.shape == (2, 3) and toks.dtype == torch.int32
    np.testing.assert_array_equal(toks[0].numpy(), x[0].argmax(-1).numpy())  # top_k 1
    np.testing.assert_array_equal(tsamp.sample_tokens(x, sp, None, 256, True).numpy(), x.argmax(-1).numpy())


# ---------------------------------------------------------------------------
# generate()
# ---------------------------------------------------------------------------

HF = dict(
    model_type="llama", hidden_size=256, intermediate_size=512, num_attention_heads=4,
    num_key_value_heads=2, num_hidden_layers=2, vocab_size=128, rms_norm_eps=1e-5,
    rope_theta=10000.0, max_position_embeddings=512, hidden_act="silu", tie_word_embeddings=False,
)
TC = dict(
    batch_size=2, seq_len=128, dtype="float32", context_encoding_buckets=[32],
    token_generation_buckets=[64, 128], fused_qkv=True,
)
IDS = np.array([[5, 17, 92, 41, 33, 88, 2, 11], [64, 3, 27, 9, 0, 0, 0, 0]])
MASK = np.array([[1] * 8, [1, 1, 1, 1, 0, 0, 0, 0]])
SAMPLED = dict(top_k=20, top_p=0.9, temperature=1.0)


def _load(c):
    for k, v in HF.items():
        setattr(c, k, v)


@pytest.fixture(scope="module")
def sd():
    torch.set_num_threads(1)
    return make_random_hf_state_dict(JaxLlamaConfig(TpuConfig(**TC), load_config=_load), seed=21)


def _port(sd, do_sample, seed=0):
    ods = dict(do_sample=do_sample, top_k=20) if do_sample is not None else None
    cfg = LlamaInferenceConfig(
        Config(**TC, seed=seed, on_device_sampling_config=ods, device="cpu"), load_config=_load
    )
    return ModelForCausalLM(None, cfg).load(state_dict=sd)


def test_same_seed_same_tokens_and_successive_calls_differ(sd):
    a, b = _port(sd, True, seed=7), _port(sd, True, seed=7)
    first = [app.generate(IDS, MASK, max_new_tokens=24, **SAMPLED).sequences for app in (a, b)]
    np.testing.assert_array_equal(first[0], first[1])
    second = a.generate(IDS, MASK, max_new_tokens=24, **SAMPLED).sequences
    assert (second != first[0]).any(), "a second generate() call repeated the first one's draws"
    np.testing.assert_array_equal(b.generate(IDS, MASK, max_new_tokens=24, **SAMPLED).sequences, second)
    other = _port(sd, True, seed=8).generate(IDS, MASK, max_new_tokens=24, **SAMPLED).sequences
    assert (other != first[0]).any()
    gen = first[0][:, 8:]
    assert gen.min() >= 0 and gen.max() < HF["vocab_size"]


def test_sampled_eos_chunks_keep_drawing(sd):
    """With an EOS the decode runs in 8-step chunks; every chunk draws
    afresh and the same seed repeats the whole run."""
    runs = [_port(sd, True, seed=3).generate(IDS, MASK, max_new_tokens=30, eos_token_id=127, **SAMPLED) for _ in range(2)]
    np.testing.assert_array_equal(runs[0].sequences, runs[1].sequences)
    gen = runs[0].sequences[0, 8:]
    assert len(set(gen.tolist())) > 3


@pytest.mark.parametrize("do_sample", [None, False])
def test_greedy_unchanged(sd, do_sample):
    """do_sample=False (and no sampling config) is the JAX package's greedy
    generate(), whatever sampling params the call passes."""
    jax_app = TpuModelForCausalLM(None, JaxLlamaConfig(TpuConfig(**TC), load_config=_load)).load(state_dict=sd)
    ref = jax_app.generate(IDS, MASK, max_new_tokens=12)
    out = _port(sd, do_sample).generate(IDS, MASK, max_new_tokens=12, **SAMPLED)
    np.testing.assert_array_equal(out.sequences, ref.sequences)
