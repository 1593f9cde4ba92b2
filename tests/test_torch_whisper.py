"""Whisper in the port, held against the JAX package's ``TpuWhisperModel``
and HF ``transformers``' ``WhisperForConditionalGeneration`` (built
in-process from a seed) on the CPU at fp32, on the reference tests' tiny
config (``tests/test_whisper.py``):

- the encoder within 1e-5 of JAX's (5e-4 of HF's, the reference's own
  bound); greedy transcription, forced ids and EOS with tokens identical to
  JAX's and HF's; rows that finish at different steps;
- a decoder pass's logits within 1e-5 of JAX's and the K / V it writes;
- the weight carry from the JAX tree, the ``whisper_encoder`` factory
  through ``EncoderApplication``, and bf16 within BF16_ATOL of JAX's fp32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from transformers import WhisperConfig, WhisperForConditionalGeneration

from neuronx_distributed_inference_tpu.config import InferenceConfig as JaxInferenceConfig
from neuronx_distributed_inference_tpu.config import TpuConfig
from neuronx_distributed_inference_tpu.models.whisper import whisper_decoder_step as jax_decoder_step
from neuronx_distributed_inference_tpu.modules.kvcache import init_cache as jax_init_cache
from neuronx_distributed_inference_tpu.runtime.encoder import TpuEncoderApplication
from neuronx_distributed_inference_tpu.runtime.encoder_decoder import TpuWhisperModel
from neuronx_distributed_inference_tpu_torch.config import Config, InferenceConfig
from neuronx_distributed_inference_tpu_torch.models.builder import params_from_jax
from neuronx_distributed_inference_tpu_torch.models.whisper import whisper_decoder_step
from neuronx_distributed_inference_tpu_torch.modules.kvcache import init_cache
from neuronx_distributed_inference_tpu_torch.runtime.encoder import EncoderApplication
from neuronx_distributed_inference_tpu_torch.runtime.encoder_decoder import WhisperModel

ATOL = 1e-5
#: the reference test's bound against HF
HF_ATOL = 5e-4
#: the port's bf16 encoder states against JAX's fp32 ones: about 3x the
#: largest gap measured on test_bf16_within_tolerance_of_jax_fp32's inputs
#: (0.0275, |h| up to 2.87)
BF16_ATOL = 0.08


@pytest.fixture(scope="module", autouse=True)
def _threads():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def hf():
    cfg = WhisperConfig(
        vocab_size=128, d_model=64, encoder_layers=2, decoder_layers=2,
        encoder_attention_heads=4, decoder_attention_heads=4,
        encoder_ffn_dim=128, decoder_ffn_dim=128, num_mel_bins=16,
        max_source_positions=32, max_target_positions=64,
        decoder_start_token_id=1, eos_token_id=None, pad_token_id=0,
        bos_token_id=None, suppress_tokens=[], begin_suppress_tokens=[],
        forced_decoder_ids=None, attn_implementation="eager",
    )
    torch.manual_seed(0)
    m = WhisperForConditionalGeneration(cfg).eval().float()
    m.generation_config.forced_decoder_ids = None
    m.generation_config.suppress_tokens = []
    m.generation_config.begin_suppress_tokens = []
    return m


def _sd(hf):
    return {k: v.float().numpy() for k, v in hf.state_dict().items()}


def _loader(hf):
    def load(cfg):
        for k, v in hf.config.to_dict().items():
            setattr(cfg, k, v)

    return load


def _jax(hf):
    def load(cfg):
        _loader(hf)(cfg)
        cfg.hidden_size = hf.config.d_model
        cfg.num_attention_heads = hf.config.decoder_attention_heads
        cfg.num_hidden_layers = hf.config.decoder_layers
        cfg.num_key_value_heads = hf.config.decoder_attention_heads
        cfg.intermediate_size = hf.config.decoder_ffn_dim

    cfg = JaxInferenceConfig(TpuConfig(batch_size=2, seq_len=64, dtype="float32"), load_config=load)
    return TpuWhisperModel(None, cfg).load(state_dict=_sd(hf))


def _port_cfg(hf, **kw):
    return InferenceConfig(Config(**{**dict(batch_size=2, seq_len=64, dtype="float32", device="cpu"), **kw}),
                           load_config=_loader(hf))


def _port(hf, params=None, **kw):
    app = WhisperModel(None, _port_cfg(hf, **kw))
    return app.load(params=params) if params is not None else app.load(state_dict=_sd(hf))


def _feats(B, seed):
    return np.random.RandomState(seed).randn(B, 16, 64).astype(np.float32)


@pytest.fixture(scope="module")
def apps(hf):
    return _port(hf), _jax(hf)


def test_encoder_matches_jax_and_hf(hf, apps):
    port, jax_app = apps
    feats = _feats(2, 0)
    got = port.encode(feats).numpy()
    assert got.shape == (2, 32, 64)
    np.testing.assert_allclose(got, np.asarray(jax_app.encode(feats)), atol=ATOL, rtol=0)
    with torch.no_grad():
        ref = hf.model.encoder(torch.tensor(feats)).last_hidden_state.numpy()
    np.testing.assert_allclose(got, ref, atol=HF_ATOL, rtol=HF_ATOL)


def test_greedy_transcription_matches_jax_and_hf(hf, apps):
    port, jax_app = apps
    feats = _feats(2, 1)
    out = port.generate(feats, max_new_tokens=10)
    np.testing.assert_array_equal(out.sequences, jax_app.generate(feats, max_new_tokens=10).sequences)
    with torch.no_grad():
        ref = hf.generate(input_features=torch.tensor(feats), max_new_tokens=10, do_sample=False, num_beams=1).numpy()
    np.testing.assert_array_equal(out.sequences[:, 1 : 1 + ref.shape[1]], ref)
    assert out.num_generated == 10


def test_forced_decoder_ids_and_eos_match_jax_and_hf(hf, apps):
    port, jax_app = apps
    feats = _feats(1, 2)
    forced = np.array([[1, 7, 3]])
    with torch.no_grad():
        ref = hf.generate(input_features=torch.tensor(feats), decoder_input_ids=torch.tensor(forced),
                          max_new_tokens=8, do_sample=False, num_beams=1).numpy()
    out = port.generate(feats, decoder_input_ids=forced, max_new_tokens=8)
    np.testing.assert_array_equal(out.sequences[:, 3 : 3 + ref.shape[1]], ref)
    np.testing.assert_array_equal(out.sequences, jax_app.generate(feats, decoder_input_ids=forced,
                                                                  max_new_tokens=8).sequences)
    eos = int(ref[0, 2])
    out2 = port.generate(feats, decoder_input_ids=forced, max_new_tokens=8, eos_token_id=eos)
    np.testing.assert_array_equal(
        out2.sequences, jax_app.generate(feats, decoder_input_ids=forced, max_new_tokens=8, eos_token_id=eos).sequences
    )
    row = out2.sequences[0, 3:]
    hit = np.where(row == eos)[0]
    assert hit.size and (row[hit[0]:] == eos).all()
    # one row, finished at its EOS: the loop stopped there
    assert out2.num_generated == hit[0] + 1


def test_rows_that_finish_at_different_steps_match_jax(apps):
    """Two rows, and an EOS id that row 1 emits first and row 0 only some
    steps later: each finished row then emits the list's FIRST id while the
    other runs on, and the loop ends when both are done, as JAX's."""
    port, jax_app = apps
    feats = _feats(2, 0)
    forced = np.array([[1, 50, 60], [1, 100, 11]])
    free = port.generate(feats, decoder_input_ids=forced, max_new_tokens=12).sequences[:, 3:]
    eos = int(free[1, 0])
    end0 = int(np.where(free[0] == eos)[0][0])
    assert end0 >= 3  # row 0 finishes steps after row 1
    for eos_ids in (eos, [99, eos]):
        got = port.generate(feats, decoder_input_ids=forced, max_new_tokens=12, eos_token_id=eos_ids)
        want = jax_app.generate(feats, decoder_input_ids=forced, max_new_tokens=12, eos_token_id=eos_ids)
        np.testing.assert_array_equal(got.sequences, want.sequences)
        assert got.num_generated == want.num_generated == end0 + 1
        fill = np.atleast_1d(eos_ids)[0]
        assert got.sequences[1, 3] == eos and (got.sequences[1, 4:] == fill).all()
        np.testing.assert_array_equal(got.sequences[0, 3 : 3 + end0 + 1], free[0, : end0 + 1])


def test_max_len_caps_the_loop_like_jax(hf):
    """max_len = min(seq_len, max_target_positions): the loop stops at it."""
    port = _port(hf, seq_len=8)
    jax_app = _jax(hf)
    jax_app.max_len = 8
    feats = _feats(2, 5)
    forced = np.array([[1, 7, 3], [1, 9, 3]])
    got = port.generate(feats, decoder_input_ids=forced, max_new_tokens=20)
    want = jax_app.generate(feats, decoder_input_ids=forced, max_new_tokens=20)
    assert port.max_len == 8 and got.num_generated == 8 - 3 + 1
    np.testing.assert_array_equal(got.sequences, want.sequences)


def test_decoder_step_logits_and_cache_match_jax(apps):
    """A forced-ids prefill then one decode step, teacher forced: logits
    within ATOL of JAX's and the self-attention K / V the step writes."""
    port, jax_app = apps
    feats = _feats(2, 6)
    enc_t, enc_j = port.encode(feats), jax_app.encode(feats)
    spec = port.spec
    cache = init_cache(spec.decoder_layers, 2, 64, spec.num_heads, spec.head_dim, torch.float32, device="cpu")
    jcache = jax_init_cache(spec.decoder_layers, 2, 64, spec.num_heads, spec.head_dim, jnp.float32)
    for toks, pos, valid in (([[1, 7, 3], [1, 9, 4]], [[0, 1, 2]] * 2, 3), ([[5], [6]], [[3], [3]], 4)):
        toks, pos = np.array(toks, np.int32), np.array(pos, np.int32)
        mask = np.tile((np.arange(64) < valid).astype(np.int32), (2, 1))
        got = whisper_decoder_step(port.params["decoder"], cache, torch.from_numpy(toks), torch.from_numpy(pos),
                                   torch.from_numpy(mask), enc_t, spec)
        want, jcache = jax_decoder_step(jax_app.params["decoder"], jcache, jnp.asarray(toks), jnp.asarray(pos),
                                        jnp.asarray(mask), enc_j, spec=jax_app.spec)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    np.testing.assert_allclose(cache.k[:, :2].numpy(), np.asarray(jcache.k)[:, :2], atol=ATOL, rtol=0)
    np.testing.assert_allclose(cache.v[:, :2].numpy(), np.asarray(jcache.v)[:, :2], atol=ATOL, rtol=0)


def test_weights_carried_from_jax_run_alike(hf, apps):
    """The JAX tree (``encoder`` / ``decoder`` stacks), fetched as numpy,
    runs in the port as it is: the same tokens."""
    _, jax_app = apps
    tree = jax.tree.map(np.asarray, jax_app.params)
    port = _port(hf, params=params_from_jax(tree, torch.float32, "cpu"))
    feats = _feats(2, 7)
    np.testing.assert_array_equal(port.generate(feats, max_new_tokens=8).sequences,
                                  jax_app.generate(feats, max_new_tokens=8).sequences)


def test_whisper_encoder_factory_through_encoder_application(hf):
    """The registered ``whisper_encoder``: the port's EncoderApplication
    equal to the JAX package's on the same state dict."""
    cfg = _port_cfg(hf)
    app = EncoderApplication.from_registry("whisper_encoder", cfg).load(state_dict=_sd(hf))
    jcfg = _jax(hf).config
    japp = TpuEncoderApplication.from_registry("whisper_encoder", jcfg)
    japp.load(state_dict=_sd(hf), dtype=jnp.float32)
    feats = _feats(2, 8)
    np.testing.assert_allclose(app(feats).numpy(), np.asarray(japp(jnp.asarray(feats))), atol=ATOL, rtol=0)
    assert set(app.params) == {"conv1", "conv2", "embed_positions", "layers", "layer_norm"}


def test_bf16_within_tolerance_of_jax_fp32(hf, apps):
    _, jax_app = apps
    port = _port(hf, dtype="bfloat16")
    assert port.params["encoder"]["layers"]["fc1"]["weight"].dtype == torch.bfloat16
    assert port.kv_cache.k.dtype == torch.bfloat16
    feats = _feats(2, 9)
    got = port.encode(feats).float().numpy()
    np.testing.assert_allclose(got, np.asarray(jax_app.encode(feats)), atol=BF16_ATOL, rtol=0)
    out = port.generate(feats, max_new_tokens=6)
    assert out.sequences.shape == (2, 7) and (out.sequences >= 0).all() and (out.sequences < 128).all()
