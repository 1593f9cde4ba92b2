"""Windowed prefill, windowed admission and left padding of the PyTorch
port, held against the JAX package on the CPU (fp32, the same tiny
head_dim-64 Llama loaded into both from one HF state dict).

- ``generate()`` of prompts longer than ``max_context_length``: window 0
  through the context program, later windows as multi-token passes over
  the contiguous cache; greedy tokens byte-identical, logits within 1e-4.
- A ``ServingSession`` on the contiguous cache admitting prompts longer
  than the largest context bucket in slot-aligned windows, synchronously
  and 1-ahead, beside short requests and mid-drain: tokens byte-identical
  to the JAX session's.
- A left-padded batch (``padding_side="left"``), read through the mask as
  the reference reads it.
"""

import numpy as np
import pytest
import torch

from neuronx_distributed_inference_tpu.config import TpuConfig
from neuronx_distributed_inference_tpu.models.llama import LlamaInferenceConfig as JaxLlamaConfig
from neuronx_distributed_inference_tpu.runtime.application import TpuModelForCausalLM
from neuronx_distributed_inference_tpu.runtime.serving import ServingSession as JaxSession
from neuronx_distributed_inference_tpu_torch.config import Config
from neuronx_distributed_inference_tpu_torch.models.llama import LlamaInferenceConfig
from neuronx_distributed_inference_tpu_torch.runtime.application import ModelForCausalLM
from neuronx_distributed_inference_tpu_torch.runtime.serving import ServingSession
from tests.conftest import make_random_hf_state_dict

HF = dict(
    model_type="llama", hidden_size=256, intermediate_size=512, num_attention_heads=4,
    num_key_value_heads=2, num_hidden_layers=2, vocab_size=128, rms_norm_eps=1e-5,
    rope_theta=10000.0, max_position_embeddings=512, hidden_act="silu", tie_word_embeddings=False,
)
# windows of 32 tokens: a 90-token prompt runs the context program once and
# two 32-token passes, over kv buckets 64 and 128
WINDOWED = dict(
    batch_size=2, seq_len=160, max_context_length=32, dtype="float32",
    context_encoding_buckets=[16, 32], token_generation_buckets=[64, 128, 160],
    fused_qkv=True, output_logits=True,
)
ATOL = 1e-4
N_NEW = 10


def _load(c):
    for k, v in HF.items():
        setattr(c, k, v)


@pytest.fixture(scope="module")
def sd():
    torch.set_num_threads(1)
    return make_random_hf_state_dict(JaxLlamaConfig(TpuConfig(**WINDOWED), load_config=_load), seed=11)


def _apps(sd, **tc):
    kw = {**WINDOWED, **tc}
    jax_app = TpuModelForCausalLM(None, JaxLlamaConfig(TpuConfig(**kw), load_config=_load)).load(state_dict=sd)
    port = ModelForCausalLM(None, LlamaInferenceConfig(Config(**kw, device="cpu"), load_config=_load))
    return jax_app, port.load(state_dict=sd)


def _prompts(lengths, width, seed=0):
    rng = np.random.RandomState(seed)
    ids = np.zeros((len(lengths), width), np.int64)
    mask = np.zeros((len(lengths), width), np.int64)
    for i, n in enumerate(lengths):
        ids[i, :n] = rng.randint(1, HF["vocab_size"], size=n)
        mask[i, :n] = 1
    return ids, mask


@pytest.fixture(scope="module")
def windowed_apps(sd):
    return _apps(sd)


@pytest.mark.parametrize(
    "lengths", [(90,), (90, 45), (64, 33)], ids=["one_row", "rows_end_in_other_windows", "window_edges"]
)
def test_windowed_generate_matches_jax(windowed_apps, lengths):
    jax_app, port = windowed_apps
    ids, mask = _prompts(lengths, max(lengths), seed=len(lengths))
    ref = jax_app.generate(ids, mask, max_new_tokens=N_NEW)
    out = port.generate(ids, mask, max_new_tokens=N_NEW)
    np.testing.assert_array_equal(out.sequences, ref.sequences)
    np.testing.assert_allclose(out.logits, np.asarray(ref.logits), atol=ATOL, rtol=0)


def test_windowed_generate_with_eos_matches_jax(windowed_apps):
    jax_app, port = windowed_apps
    ids, mask = _prompts((90, 45), 90, seed=4)
    free = jax_app.generate(ids, mask, max_new_tokens=N_NEW).sequences
    eos = int(free[0, 90 + 3])
    ref = jax_app.generate(ids, mask, max_new_tokens=N_NEW, eos_token_id=eos)
    out = port.generate(ids, mask, max_new_tokens=N_NEW, eos_token_id=eos)
    np.testing.assert_array_equal(out.sequences, ref.sequences)
    np.testing.assert_allclose(out.logits, np.asarray(ref.logits), atol=ATOL, rtol=0)


# ---------------------------------------------------------------------------
# windowed admission
# ---------------------------------------------------------------------------

SESSION = dict(is_continuous_batching=True, batch_size=3, ctx_batch_size=1, output_logits=False)
REQUESTS = {
    "long": 70,  # three windows
    "short": 9,  # one context program
    "edge": 64,  # ends on a window edge
}


def _drive(sess, late=None, max_steps=300):
    for i in range(max_steps):
        if late is not None and i == 3:
            rid, prompt = late
            assert sess.add_request(rid, prompt, max_new_tokens=N_NEW)
        if i > 3 and not (sess.active or sess._readmit):
            break
        sess.step()
    else:
        raise AssertionError("session failed to drain within max_steps")
    return {rid: list(r.generated) for rid, r in sess.requests.items()}


@pytest.mark.parametrize("async_mode", [False, True], ids=["sync", "one_ahead"])
def test_windowed_admission_matches_jax(sd, async_mode):
    jax_app, port = _apps(sd, **SESSION, async_mode=async_mode)
    rng = np.random.RandomState(7)
    prompts = {rid: rng.randint(1, HF["vocab_size"], size=n).tolist() for rid, n in REQUESTS.items()}
    late = ("late_long", rng.randint(1, HF["vocab_size"], size=50).tolist())
    outs = []
    for sess in (JaxSession(jax_app), ServingSession(port)):
        for rid in ("long", "short"):
            assert sess.add_request(rid, prompts[rid], max_new_tokens=N_NEW)
        outs.append(_drive(sess, late=late))
        # the slots freed by the drain admit the edge case on their own
        assert sess.add_request("edge", prompts["edge"], max_new_tokens=N_NEW)
        outs[-1].update(_drive(sess))
    assert outs[0] == outs[1]
    assert set(outs[1]) == {"long", "short", "late_long", "edge"}
    assert all(len(v) == N_NEW for v in outs[1].values())


def test_windowed_admission_paged_raises(sd):
    """On the paged cache the windowed hand-off cannot write blocks: the
    reference's ValueError (chunked prefill is the way to admit)."""
    kw = dict(SESSION, is_block_kv_layout=True, pa_block_size=16, pa_num_blocks=40, max_context_length=160)
    port = ModelForCausalLM(None, LlamaInferenceConfig(Config(**{**WINDOWED, **kw}, device="cpu"), load_config=_load))
    sess = ServingSession(port.load(state_dict=sd))
    with pytest.raises(ValueError, match="chunked prefill"):
        sess._full_prefill(_long_request(sess))


def _long_request(sess):
    req = sess._new_request("long", np.arange(1, 71), 4, None, None)
    req.slot = 0
    return req


# ---------------------------------------------------------------------------
# left padding
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("eos", [False, True], ids=["no_eos", "eos"])
def test_left_padded_batch_matches_jax(sd, eos):
    """The padded query rows of a left-padded prompt see no valid key: the
    JAX app runs with its attention kernels forced on (interpret mode), as
    the port's kernels (their plain versions here) give such a row zeros,
    where the JAX native path gives it a uniform average."""
    jax_app, port = _apps(
        sd, padding_side="left", max_context_length=160, context_encoding_buckets=[128],
        attn_kernel_enabled=True, attn_block_tkg_kernel_enabled=True,
    )
    rng = np.random.RandomState(9)
    ids = np.zeros((2, 40), np.int64)
    mask = np.zeros((2, 40), np.int64)
    for i, n in enumerate((40, 23)):
        ids[i, 40 - n :] = rng.randint(1, HF["vocab_size"], size=n)
        mask[i, 40 - n :] = 1
    kw = {}
    if eos:
        kw["eos_token_id"] = int(jax_app.generate(ids, mask, max_new_tokens=N_NEW).sequences[1, 40 + 2])
    ref = jax_app.generate(ids, mask, max_new_tokens=N_NEW, **kw)
    out = port.generate(ids, mask, max_new_tokens=N_NEW, **kw)
    np.testing.assert_array_equal(out.sequences, ref.sequences)
    np.testing.assert_allclose(out.logits, np.asarray(ref.logits), atol=ATOL, rtol=0)
