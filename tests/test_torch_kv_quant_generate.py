"""The quantized KV cache end to end, held against the JAX package on the
CPU at fp32 (one HF state dict loaded into both).

- ``generate()`` with kv int8, fp8 (e4m3) and e5m2, with and without
  ``warmup()``: greedy tokens byte-identical, logits within 1e-4, and the
  final (L, Hkv) scales equal to fp32 rounding (rtol 1e-5: the two
  frameworks' fp32 projections differ in the last bits, so the absmax of
  the same K/V does too); the scales after ``warmup()`` equal the
  reference's, and the port's extra one-step decode warmups leave them
  bit-identical to a warmup without them.
- The deviation from the unquantized cache stays within the reference's
  ``LOGIT_TOL`` (tests/test_kv_quant.py) on every step the two runs reach
  with the same prefix; a greedy token flips only at a near tie.
- The contiguous, split (sync and 1-ahead) and ragged (sync and 1-ahead)
  serving drains at kv int8 drain the JAX package's tokens; a NaN row is
  quarantined and its quantized KV scrubbed as in the reference, and a
  poison fault raises as the reference's does (no NaN code exists).
- With both fused flags True on a quantized cache, B8 is not taken (the
  decode attention goes to B1's code mode) and B9 is.

On CPU tensors every wrapper takes its plain version: nothing launches."""

import numpy as np
import pytest
import torch

from neuronx_distributed_inference_tpu.config import ChunkedPrefillConfig as JaxChunked
from neuronx_distributed_inference_tpu.config import TpuConfig
from neuronx_distributed_inference_tpu.models.llama import LlamaInferenceConfig as JaxLlamaConfig
from neuronx_distributed_inference_tpu.runtime import faults as jfaults
from neuronx_distributed_inference_tpu.runtime.application import TpuModelForCausalLM
from neuronx_distributed_inference_tpu.runtime.serving import ServingSession as JaxSession
from neuronx_distributed_inference_tpu_torch.config import ChunkedPrefillConfig, Config
from neuronx_distributed_inference_tpu_torch.models.llama import LlamaInferenceConfig
from neuronx_distributed_inference_tpu_torch.modules.kvcache import QuantizedKV, cache_nbytes
from neuronx_distributed_inference_tpu_torch.ops import _cuda, decode_attention, decode_block
from neuronx_distributed_inference_tpu_torch.runtime import faults as tfaults
from neuronx_distributed_inference_tpu_torch.runtime import model_runner
from neuronx_distributed_inference_tpu_torch.runtime.application import ModelForCausalLM
from neuronx_distributed_inference_tpu_torch.runtime.serving import ServingSession
from tests.conftest import make_random_hf_state_dict

HF = dict(
    model_type="llama", hidden_size=256, intermediate_size=512, num_attention_heads=4,
    num_key_value_heads=2, num_hidden_layers=2, vocab_size=128, rms_norm_eps=1e-5,
    rope_theta=10000.0, max_position_embeddings=512, hidden_act="silu", tie_word_embeddings=False,
)
TC = dict(
    batch_size=2, seq_len=256, dtype="float32", context_encoding_buckets=[128],
    token_generation_buckets=[128, 256], fused_qkv=True, output_logits=True,
)
PROMPTS = np.array([[5, 17, 92, 41, 33, 88, 2, 11], [64, 3, 27, 9, 0, 0, 0, 0]])
MASK = np.array([[1] * 8, [1, 1, 1, 1, 0, 0, 0, 0]])
N_NEW = 10
ATOL = 1e-4
SCALE_RTOL = 1e-5
#: the reference's end-to-end deviation bounds against the unquantized
#: cache (tests/test_kv_quant.py LOGIT_TOL)
LOGIT_TOL = {"int8": 0.25, "fp8": 0.75}


def _load(c):
    for k, v in HF.items():
        setattr(c, k, v)


@pytest.fixture(scope="module")
def sd():
    torch.set_num_threads(1)
    return make_random_hf_state_dict(JaxLlamaConfig(TpuConfig(**TC), load_config=_load), seed=3)


def _apps(sd, **kw):
    jax_app = TpuModelForCausalLM(None, JaxLlamaConfig(TpuConfig(**TC, **kw), load_config=_load)).load(state_dict=sd)
    port = ModelForCausalLM(None, LlamaInferenceConfig(Config(**TC, **kw, device="cpu"), load_config=_load))
    return jax_app, port.load(state_dict=sd)


def _scales(cache):
    return [np.asarray(s.scale) if not isinstance(s, QuantizedKV) else s.scale.numpy() for s in (cache.k, cache.v)]


def _assert_scales(port_cache, jax_cache):
    for t, j in zip(_scales(port_cache), _scales(jax_cache)):
        np.testing.assert_allclose(t, j, rtol=SCALE_RTOL, atol=0)


@pytest.mark.parametrize("kvd, warm", [("int8", True), ("int8", False), ("fp8", True), ("fp8", False),
                                       ("float8_e5m2", False)])
def test_generate_matches_jax(sd, kvd, warm):
    jax_app, port = _apps(sd, kv_cache_dtype=kvd)
    assert isinstance(port.kv_cache.k, QuantizedKV) and port.kv_cache.k.dtype == port.config.torch_config.kv_dtype
    if warm:
        jax_app.warmup()
        port.warmup()
        _assert_scales(port.kv_cache, jax_app.kv_cache)
        assert port.kv_cache.k.scale.min() > 0  # warmup writes reached every (layer, head)
    ref = jax_app.generate(PROMPTS, MASK, max_new_tokens=N_NEW)
    _cuda.reset_launch_counts()
    out = port.generate(PROMPTS, MASK, max_new_tokens=N_NEW)
    assert _cuda.launch_counts() == {n: 0 for n in _cuda.KERNELS}
    np.testing.assert_array_equal(out.sequences, np.asarray(ref.sequences))
    np.testing.assert_allclose(out.logits, np.asarray(ref.logits), atol=ATOL, rtol=0)
    _assert_scales(port.kv_cache, jax_app.kv_cache)


@pytest.mark.parametrize("kvd", sorted(LOGIT_TOL))
def test_deviation_from_the_plain_cache_within_reference_bound(sd, kvd):
    """The reference's check (tests/test_kv_quant.py
    test_contiguous_e2e_logit_deviation) on the steps both runs reach with
    the same prefix: logits within LOGIT_TOL of the unquantized cache's and
    not equal (the quantized cache is in the loop). A greedy token may flip
    where the plain run's top-2 margin is within twice that deviation (a
    near tie); each row is compared up to its first differing token, the
    last step whose input both runs share."""
    plain = ModelForCausalLM(None, LlamaInferenceConfig(Config(**TC, device="cpu"), load_config=_load)).load(
        state_dict=sd)
    _, quant = _apps(sd, kv_cache_dtype=kvd)
    ref = plain.generate(PROMPTS, MASK, max_new_tokens=N_NEW)
    out = quant.generate(PROMPTS, MASK, max_new_tokens=N_NEW)
    gen_ref, gen = ref.sequences[:, -N_NEW:], out.sequences[:, -N_NEW:]
    dev = 0.0
    for b in range(len(PROMPTS)):
        differ = np.flatnonzero(gen_ref[b] != gen[b])
        last = differ[0] if len(differ) else N_NEW - 1
        d = np.abs(out.logits[b, : last + 1] - ref.logits[b, : last + 1]).max()
        dev = max(dev, d)
        if len(differ):
            top2 = np.sort(ref.logits[b, last])[-2:]
            assert top2[1] - top2[0] <= 2 * d, (b, last, top2, d)
    assert 0 < dev <= LOGIT_TOL[kvd], dev
    # codes at one byte an element plus fp32 (L, Hkv) scales per stream
    L, Hkv = HF["num_hidden_layers"], HF["num_key_value_heads"]
    assert cache_nbytes(quant.kv_cache) == cache_nbytes(plain.kv_cache) // 4 + 2 * L * Hkv * 4
    assert quant.kv_cache_nbytes == cache_nbytes(quant.kv_cache)


def test_decode_warmups_leave_the_scales_as_the_reference_warmup(sd, monkeypatch):
    """The port's one-step decode warmups write to the garbage line, which
    stays out of the scales: on a quantized contiguous cache warmup ends
    where a warmup without them ends, scales and live lines bit for bit."""
    runs = []
    for skip in (False, True):
        if skip:
            monkeypatch.setattr(model_runner.SubModelRunner, "_warm_decode", lambda *a, **k: None)
        _, port = _apps(sd, kv_cache_dtype="int8")
        port.warmup()
        runs.append((port.kv_cache.k.scale.clone(), port.kv_cache.v.scale.clone(),
                     port.kv_cache.k.data[:, :2].clone(), port.kv_cache.v.data[:, :2].clone()))
    assert all(torch.equal(a, b) for a, b in zip(*runs))


SERVE = dict(
    is_continuous_batching=True, batch_size=4, ctx_batch_size=1, seq_len=64, dtype="float32",
    is_block_kv_layout=True, pa_block_size=16, pa_num_blocks=24, is_chunked_prefill=True, kv_cache_dtype="int8",
)
SERVE_MODES = {
    "split_sync": dict(async_mode=False),
    "split_1ahead": dict(async_mode=True),
    "ragged_sync": dict(serving_ragged=True, serving_ragged_async=False),
    "ragged_1ahead": dict(serving_ragged=True, serving_ragged_async=True),
    "contiguous": dict(is_block_kv_layout=False, is_chunked_prefill=False, pa_block_size=None, pa_num_blocks=None),
}
SERVE_PROMPTS = {
    "r1": [5, 17, 92, 41, 8, 3, 77, 21, 60, 14, 2, 90],
    "r2": list(range(30, 52)),  # prefills across chunks
    "r3": [7, 7, 7],
}


def _serve_apps(sd, mode):
    kw = {**SERVE, **SERVE_MODES[mode]}
    kw = {k: v for k, v in kw.items() if v is not None}
    chunk = dict(max_num_seqs=2, kernel_q_tile_size=16) if kw["is_chunked_prefill"] else None
    jcfg = TpuConfig(**kw, **({"chunked_prefill_config": JaxChunked(**chunk)} if chunk else {}))
    pcfg = Config(**kw, device="cpu", **({"chunked_prefill_config": ChunkedPrefillConfig(**chunk)} if chunk else {}))
    jax_app = TpuModelForCausalLM(None, JaxLlamaConfig(jcfg, load_config=_load)).load(state_dict=sd)
    port = ModelForCausalLM(None, LlamaInferenceConfig(pcfg, load_config=_load)).load(state_dict=sd)
    return jax_app, port


def _drive(sess, max_steps=300):
    assert sess.add_request("r1", SERVE_PROMPTS["r1"][:4], max_new_tokens=6)
    sess.step()
    assert sess.add_request("r2", SERVE_PROMPTS["r2"], max_new_tokens=6)
    sess.step()
    assert sess.add_request("r3", SERVE_PROMPTS["r3"], max_new_tokens=5)
    for _ in range(max_steps):
        if not (sess.active or sess._readmit):
            break
        sess.step()
    else:
        raise AssertionError("session failed to drain within max_steps")
    return {rid: list(r.generated) for rid, r in sess.requests.items()}


@pytest.mark.parametrize("mode", sorted(SERVE_MODES))
def test_serving_drain_matches_jax(sd, mode):
    jax_app, port = _serve_apps(sd, mode)
    ref = _drive(JaxSession(jax_app))
    _cuda.reset_launch_counts()
    sess = ServingSession(port)
    got = _drive(sess)
    assert _cuda.launch_counts() == {n: 0 for n in _cuda.KERNELS}
    assert got == ref and all(len(v) in (5, 6) for v in got.values())
    assert all(r.status == "finished" for r in sess.requests.values())
    _assert_scales(port.kv_cache, jax_app.kv_cache)
    if mode.startswith("ragged"):
        assert set(sess.dispatches) == {"mixed_step"}


def test_int8_pool_admits_twice_the_blocks(sd):
    """A byte-budgeted pool (pa_pool_bytes) sizes itself in the cache dtype:
    int8 holds twice the bf16 blocks of the same budget, as the reference's
    does, and the session's block bytes halve."""
    n = {}
    for kvd in ("bf16", "int8"):
        kw = dict(SERVE, kv_cache_dtype=kvd, pa_num_blocks=None, pa_pool_bytes=1 << 20)
        jax_app = TpuModelForCausalLM(
            None, JaxLlamaConfig(TpuConfig(**kw, chunked_prefill_config=JaxChunked(2, 16)), load_config=_load)
        ).load(state_dict=sd)
        port = ModelForCausalLM(None, LlamaInferenceConfig(
            Config(**kw, device="cpu", chunked_prefill_config=ChunkedPrefillConfig(2, 16)), load_config=_load,
        )).load(state_dict=sd)
        n[kvd] = port.config.torch_config.pa_num_blocks
        assert n[kvd] == jax_app.config.tpu_config.pa_num_blocks
        assert ServingSession(port).block_bytes == JaxSession(jax_app).block_bytes
    assert n["int8"] == 2 * n["bf16"]


def test_nan_row_quarantined_and_its_quantized_kv_scrubbed(sd):
    jax_app, port = _serve_apps(sd, "split_1ahead")
    j = _drive(JaxSession(jax_app, fault_injector=jfaults.FaultInjector().nan_logits(step=5, slot=0)))
    ts = ServingSession(port, fault_injector=tfaults.FaultInjector().nan_logits(step=5, slot=0))
    t = _drive(ts)
    assert t == j
    assert ts.requests["r1"].fail_reason == "non_finite"
    assert len(ts.allocator.free) == ts.allocator.num_blocks
    _assert_scales(port.kv_cache, jax_app.kv_cache)


@pytest.mark.parametrize("fault", ["poison_kv_row", "poison_garbage_block"])
def test_poison_faults_raise_on_a_quantized_cache_like_the_reference(sd, fault):
    jax_app, port = _serve_apps(sd, "split_sync")
    args = dict(step=2) if fault == "poison_garbage_block" else dict(step=2, slot=0)
    for app, session, faults in ((jax_app, JaxSession, jfaults), (port, ServingSession, tfaults)):
        sess = session(app, fault_injector=getattr(faults.FaultInjector(), fault)(**args))
        with pytest.raises(ValueError, match="quantized KV stream"):
            _drive(sess)


FUSED_TC = dict(batch_size=2, seq_len=1024, dtype="float32", fused_qkv=True, token_generation_buckets=[512],
                output_logits=True, fused_attn_block_kernel_enabled=True, fused_mlp_kernel_enabled=True)


def test_fused_flags_on_a_quantized_cache_take_b9_and_b1(sd, monkeypatch):
    """B8 streams the cache in its storage dtype, so a quantized cache is
    not eligible (the reference's _fused_attn_eligible): the decode
    attention goes to B1's wrapper (its code mode on a card) and the MLP
    half still takes B9. The tokens match the JAX package with the same
    flags."""
    n = {"attn": 0, "mlp": 0, "b1": 0}
    for mod, name, key in ((decode_block, "fused_attn_block", "attn"), (decode_block, "fused_mlp_block", "mlp"),
                           (decode_attention, "tkg_decode_attention", "b1")):
        fn = getattr(mod, name)

        def counted(*a, _fn=fn, _key=key, **k):
            n[_key] += 1
            return _fn(*a, **k)

        monkeypatch.setattr(mod, name, counted)
    kw = dict(FUSED_TC, kv_cache_dtype="int8")
    jax_app = TpuModelForCausalLM(None, JaxLlamaConfig(TpuConfig(**kw), load_config=_load)).load(state_dict=sd)
    port = ModelForCausalLM(None, LlamaInferenceConfig(Config(**kw, device="cpu"), load_config=_load)).load(
        state_dict=sd)
    ref = jax_app.generate(PROMPTS, MASK, max_new_tokens=N_NEW)
    out = port.generate(PROMPTS, MASK, max_new_tokens=N_NEW)
    np.testing.assert_array_equal(out.sequences, np.asarray(ref.sequences))
    np.testing.assert_allclose(out.logits, np.asarray(ref.logits), atol=ATOL, rtol=0)
    assert n["attn"] == 0 and n["mlp"] == n["b1"] > 0
