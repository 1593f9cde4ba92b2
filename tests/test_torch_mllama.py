"""The port's Mllama (Llama-3.2-Vision) held against the JAX package and HF
``MllamaForConditionalGeneration`` built in-process from a seed, on the CPU:

- the tiled vision tower against JAX and HF at fp32 (TOWER_ATOL), with two
  taps that differ, so that a tower that concatenates them instead of
  interleaving them fails;
- ``prepare_cross_attention_mask`` against JAX, a fully masked row among
  the rows;
- ``generate()`` against JAX and HF with every gate seeded to tanh(gate) =
  0.5 (HF initialises them to zero, where an image cannot move a logit): one
  image row, the reference's mixed-image-rows case, the kernels' head_dim
  64 through their plain versions, the cross-KV stream wider than the
  image (padded vision tokens never attended), weights carried from the
  JAX package by ``params_from_jax``, and bf16 against JAX's bf16;
- the cross-KV write sending out-of-range rows to the garbage line;
- the reference's refusals (the int8/fp8 KV cache and random weights),
  each naming its ROADMAP item;
- the ``mllama_vision`` encoder application against JAX."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuronx_distributed_inference_tpu.config import TpuConfig
from neuronx_distributed_inference_tpu.models.mllama import MllamaInferenceConfig as JaxMllamaConfig
from neuronx_distributed_inference_tpu.models.mllama import prepare_cross_attention_mask as jax_prepare_mask
from neuronx_distributed_inference_tpu.runtime.mllama import MllamaForConditionalGeneration as JaxMllama
from neuronx_distributed_inference_tpu_torch.config import Config
from neuronx_distributed_inference_tpu_torch.models.builder import params_from_jax
from neuronx_distributed_inference_tpu_torch.models.mllama import (
    MllamaCache,
    MllamaInferenceConfig,
    mllama_vision_encoder,
    prepare_cross_attention_mask,
    write_cross_kv,
)
from neuronx_distributed_inference_tpu_torch.modules.kvcache import slot_ids_from_seq_ids
from neuronx_distributed_inference_tpu_torch.runtime.encoder import EncoderApplication
from neuronx_distributed_inference_tpu_torch.runtime.mllama import MllamaForConditionalGeneration

#: fp32 tower features (the reference's own HF parity bound)
TOWER_ATOL = 2e-5
#: bf16 tower features of the two packages, each rounding its own bf16
#: products: about 2.5x the largest gap measured on test_bf16_matches_jax's
#: inputs (2.3e-2, 1.5 bf16 ulps at |feature| up to 3.1)
BF16_TOWER_ATOL = 6e-2
KERNELS_OFF = dict(attn_kernel_enabled=False, attn_block_tkg_kernel_enabled=False)
IMAGE_TOKEN = 255
#: every gate of the tower and the cross layers: tanh(GATE) ~ 0.5
GATE = 0.55


@pytest.fixture(scope="module", autouse=True)
def _threads():
    torch.set_num_threads(1)


def _tiny_hf(hidden=48, heads=4, kv=2, taps=(0, 2), gate=GATE, max_num_images=None):
    from transformers import MllamaConfig, MllamaForConditionalGeneration as HfMllama
    from transformers.models.mllama.configuration_mllama import MllamaTextConfig, MllamaVisionConfig

    vision = MllamaVisionConfig(
        hidden_size=32, attention_heads=4, intermediate_size=64, num_hidden_layers=3, num_global_layers=2,
        image_size=16, patch_size=8, max_num_tiles=2, intermediate_layers_indices=list(taps),
        supported_aspect_ratios=[[1, 1], [1, 2], [2, 1]], vision_output_dim=32 * (1 + len(taps)),
    )
    text = MllamaTextConfig(
        hidden_size=hidden, num_attention_heads=heads, num_key_value_heads=kv, intermediate_size=96,
        num_hidden_layers=5, cross_attention_layers=[1, 3], vocab_size=256, rope_theta=10000.0,
        rope_scaling={"rope_type": "default"}, rms_norm_eps=1e-5, max_position_embeddings=256,
        tie_word_embeddings=False, bos_token_id=None, eos_token_id=None, pad_token_id=0,
    )
    cfg = MllamaConfig(vision_config=vision, text_config=text, image_token_index=IMAGE_TOKEN)
    torch.manual_seed(0)
    hf = HfMllama(cfg).eval().float()
    if gate is not None:
        with torch.no_grad():
            for name, p in hf.named_parameters():
                if name.endswith(("gate", "gate_attn", "gate_ffn")):
                    p.fill_(gate)
    if max_num_images is not None:
        hf.config.text_config.max_num_images = max_num_images
    return hf


def _inputs(S=10, B=1, seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(1, 250, size=(B, S))
    ids[:, 0] = IMAGE_TOKEN
    mask = np.ones((B, S), np.int64)
    pixels = rng.randn(B, 1, 2, 3, 16, 16).astype(np.float32) * 0.3
    ar_ids = np.array([[2]] * B)  # aspect ratio [1, 2]: 2 tiles
    ar_mask = np.ones((B, 1, 2), np.int64)
    xmask = np.ones((B, S, 1, 2), np.int64)  # every token sees both tiles
    return ids, mask, pixels, ar_ids, ar_mask, xmask


def _loader(hf):
    hc = hf.config

    def load(c):
        c.model_type = "mllama"
        c.text_config = hc.text_config.to_dict()
        c.vision_config = hc.vision_config.to_dict()
        c.image_token_index = hc.image_token_index

    return load


def _sd(hf):
    return {k: v.float().numpy() for k, v in hf.state_dict().items()}


def _jax_app(hf, B=1, dtype="float32"):
    app = JaxMllama(None, JaxMllamaConfig(TpuConfig(batch_size=B, seq_len=64, dtype=dtype), load_config=_loader(hf)))
    app.load(state_dict=_sd(hf))
    return app


def _port_cfg(hf, B=1, **kw):
    tc = Config(**{**dict(batch_size=B, seq_len=64, dtype="float32", device="cpu"), **kw})
    return MllamaInferenceConfig(tc, load_config=_loader(hf))


def _port_app(hf, B=1, **kw):
    return MllamaForConditionalGeneration(None, _port_cfg(hf, B, **kw)).load(state_dict=_sd(hf))


def _hf_generate(hf, ids, mask, pixels, ar_ids, ar_mask, xmask, n):
    with torch.no_grad():
        return hf.generate(
            input_ids=torch.tensor(ids), attention_mask=torch.tensor(mask), pixel_values=torch.tensor(pixels),
            aspect_ratio_ids=torch.tensor(ar_ids), aspect_ratio_mask=torch.tensor(ar_mask),
            cross_attention_mask=torch.tensor(xmask), max_new_tokens=n, do_sample=False,
        ).numpy()


@pytest.fixture(scope="module")
def hf():
    return _tiny_hf()


@pytest.fixture(scope="module")
def jax_app(hf):
    return _jax_app(hf)


# ---------------------------------------------------------------------------
# the vision tower
# ---------------------------------------------------------------------------


def _port_tower(app, pixels, ar_ids, ar_mask):
    return mllama_vision_encoder(
        app.params["vision"], torch.from_numpy(pixels), torch.from_numpy(ar_ids), torch.from_numpy(ar_mask),
        app.vision_spec,
    ).float().numpy()


def test_tower_matches_jax_and_hf_with_distinct_taps(hf, jax_app):
    """The tower's output [final | taps] equals JAX's and HF's. The two taps
    differ, and interleaving them (HF's layout) is far from concatenating
    them, so a tower that concatenated would fail here."""
    _, _, pixels, ar_ids, ar_mask, _ = _inputs(B=2)
    app = _port_app(hf)
    got = _port_tower(app, pixels, ar_ids, ar_mask)
    want = np.asarray(jax_app._vision_fn(
        jax_app.params["vision"], jnp.asarray(pixels), jnp.asarray(ar_ids, jnp.int32), jnp.asarray(ar_mask, jnp.int32)
    ))
    np.testing.assert_allclose(got, want, atol=TOWER_ATOL, rtol=0)
    with torch.no_grad():
        ref = hf.model.vision_model(
            pixel_values=torch.tensor(pixels), aspect_ratio_ids=torch.tensor(ar_ids),
            aspect_ratio_mask=torch.tensor(ar_mask),
        ).last_hidden_state.numpy()
    np.testing.assert_allclose(got, ref.reshape(got.shape), atol=TOWER_ATOL, rtol=0)
    hs = app.vision_spec.hidden_size
    taps = got[..., hs:].reshape(got.shape[:-1] + (hs, 2))
    assert np.abs(taps[..., 0] - taps[..., 1]).max() > 1e-2
    concatenated = np.concatenate([taps[..., 0], taps[..., 1]], axis=-1)
    assert np.abs(concatenated - got[..., hs:]).max() > 1e-2


def test_tower_partial_aspect_mask_matches_jax(hf, jax_app):
    """One live tile of two (aspect ratio [1, 1]): the dead tile's patches
    masked by the NEG_INF outer product."""
    _, _, pixels, _, _, _ = _inputs(B=1, seed=3)
    ar_ids, ar_mask = np.array([[1]]), np.array([[[1, 0]]])
    app = _port_app(hf)
    got = _port_tower(app, pixels, ar_ids, ar_mask)
    want = np.asarray(jax_app._vision_fn(
        jax_app.params["vision"], jnp.asarray(pixels), jnp.asarray(ar_ids, jnp.int32), jnp.asarray(ar_mask, jnp.int32)
    ))
    np.testing.assert_allclose(got, want, atol=TOWER_ATOL, rtol=0)


def test_encoder_app_mllama_vision_matches_jax(hf, jax_app):
    class Cfg:
        vision_config = hf.config.vision_config.to_dict()
        torch_config = Config(batch_size=1, seq_len=16, dtype="float32", device="cpu")

    app = EncoderApplication.from_registry("mllama_vision", Cfg()).load(state_dict=_sd(hf))
    _, _, pixels, ar_ids, ar_mask, _ = _inputs(B=1, seed=2)
    got = app(pixels, ar_ids, ar_mask).numpy()
    want = np.asarray(jax_app._vision_fn(
        jax_app.params["vision"], jnp.asarray(pixels), jnp.asarray(ar_ids, jnp.int32), jnp.asarray(ar_mask, jnp.int32)
    ))
    np.testing.assert_allclose(got, want, atol=TOWER_ATOL, rtol=0)


# ---------------------------------------------------------------------------
# the cross-attention mask and the cross-KV stream
# ---------------------------------------------------------------------------


def test_prepare_cross_attention_mask_matches_jax():
    """A row that sees both tiles, one that sees one, and a fully masked
    row: the last attends to everything (additive 0) and is flagged 0."""
    x = np.zeros((1, 3, 1, 2), np.float32)
    x[0, 0] = 1
    x[0, 1, 0, 1] = 1
    add, full = prepare_cross_attention_mask(x, 3)
    j_add, j_full = jax_prepare_mask(x, 3)
    np.testing.assert_array_equal(add, np.asarray(j_add))
    np.testing.assert_array_equal(full, np.asarray(j_full))
    assert add.shape == (1, 1, 3, 6) and full.shape == (1, 3, 1)
    np.testing.assert_array_equal(full[0, :, 0], [1, 1, 0])
    assert (add[0, 0, 2] == 0).all() and (add[0, 0, 1, :3] == -1e30).all() and (add[0, 0, 1, 3:] == 0).all()


def test_cross_kv_write_sends_out_of_range_rows_to_the_garbage_line(hf):
    """seq ids -1 and 7 (past the batch) write the garbage line, never a
    live line; a valid id writes its own line."""
    app = _port_app(hf, B=2)
    c = app.cache
    B = 2
    cache = MllamaCache(k=c.k, v=c.v, cross_k=torch.zeros_like(c.cross_k), cross_v=torch.zeros_like(c.cross_v))
    states = torch.randn((3, c.cross_k.shape[2], app.hidden_size))
    slots = slot_ids_from_seq_ids(torch.tensor([-1, 1, 7]), B)
    write_cross_kv(app.params, cache, states, slots, app.spec.attn, app.spec.rms_eps)
    assert float(cache.cross_k[:, 0].abs().max()) == 0.0
    assert float(cache.cross_k[:, 1].abs().max()) > 0 and float(cache.cross_k[:, B].abs().max()) > 0
    assert cache.cross_k.shape[1] == B + 1


# ---------------------------------------------------------------------------
# generate()
# ---------------------------------------------------------------------------


def test_generate_matches_jax_and_hf(hf, jax_app):
    """One image row at non-zero gates: tokens equal JAX's and HF's, and
    another image changes them (the image moves the logits)."""
    ids, mask, pixels, ar_ids, ar_mask, xmask = _inputs()
    n = 8
    ref = _hf_generate(hf, ids, mask, pixels, ar_ids, ar_mask, xmask, n)
    want = np.asarray(jax_app.generate(ids, mask, pixels, ar_ids, ar_mask, xmask, max_new_tokens=n).sequences)
    app = _port_app(hf, **KERNELS_OFF)
    got = app.generate(ids, mask, pixels, ar_ids, ar_mask, xmask, max_new_tokens=n).sequences
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, ref)
    other = app.generate(ids, mask, -pixels, ar_ids, ar_mask, xmask, max_new_tokens=n).sequences
    assert (other != got).any()
    assert set(app._decode) == {1}


def test_mixed_image_rows_match_jax_and_hf(hf):
    """Row 1's tokens see no tile: its cross attention is neutralized and its
    cross MLP zeroed by the full-text-row mask (the reference's case)."""
    ids, mask, pixels, ar_ids, ar_mask, xmask = _inputs(S=8, B=2)
    xmask[1] = 0
    n = 6
    ref = _hf_generate(hf, ids, mask, pixels, ar_ids, ar_mask, xmask, n)
    want = np.asarray(_jax_app(hf, B=2).generate(ids, mask, pixels, ar_ids, ar_mask, xmask, max_new_tokens=n).sequences)
    got = _port_app(hf, B=2, **KERNELS_OFF).generate(ids, mask, pixels, ar_ids, ar_mask, xmask, max_new_tokens=n)
    np.testing.assert_array_equal(got.sequences, want)
    np.testing.assert_array_equal(got.sequences, ref)


def test_zero_gates_match_hf(hf):
    """HF's own initialisation (every gate zero) still matches."""
    zero = _tiny_hf(gate=None)
    ids, mask, pixels, ar_ids, ar_mask, xmask = _inputs(seed=4)
    ref = _hf_generate(zero, ids, mask, pixels, ar_ids, ar_mask, xmask, 6)
    got = _port_app(zero, **KERNELS_OFF).generate(ids, mask, pixels, ar_ids, ar_mask, xmask, max_new_tokens=6)
    np.testing.assert_array_equal(got.sequences, ref)


def test_params_carried_from_jax(hf, jax_app):
    """The JAX app's whole tree (vision, projector, the self_runs stacks,
    the cross_layers list) through params_from_jax: the same tokens."""
    ids, mask, pixels, ar_ids, ar_mask, xmask = _inputs(seed=1)
    want = np.asarray(jax_app.generate(ids, mask, pixels, ar_ids, ar_mask, xmask, max_new_tokens=6).sequences)
    params = params_from_jax(jax.device_get(jax_app.params), torch.float32, "cpu")
    app = MllamaForConditionalGeneration(None, _port_cfg(hf, **KERNELS_OFF)).load(params=params)
    assert len(app.params["self_runs"]) == 3 and len(app.params["cross_layers"]) == 2
    assert app.params["rope"]["inv_freq"].dtype == torch.float32
    got = app.generate(ids, mask, pixels, ar_ids, ar_mask, xmask, max_new_tokens=6).sequences
    np.testing.assert_array_equal(got, want)


def test_kernels_head_dim_matches_jax():
    """Text heads of 64 (2 q / 1 kv): the self layers' prefill and decode go
    through the B2 and B1 wrappers (their plain versions on the CPU)."""
    wide = _tiny_hf(hidden=128, heads=2, kv=1)
    ids, mask, pixels, ar_ids, ar_mask, xmask = _inputs(S=9, B=2, seed=5)
    xmask[1, :4] = 0
    want = np.asarray(_jax_app(wide, B=2).generate(ids, mask, pixels, ar_ids, ar_mask, xmask, max_new_tokens=6).sequences)
    app = _port_app(wide, B=2)
    assert app.spec.attn.head_dim == 64
    got = app.generate(ids, mask, pixels, ar_ids, ar_mask, xmask, max_new_tokens=6).sequences
    np.testing.assert_array_equal(got, want)


def test_wider_cross_stream_never_attends_padding(hf):
    """max_num_images 2 makes the stream twice the image's width; the padded
    vision tokens take NEG_INF, so the tokens equal the exact-width run."""
    ids, mask, pixels, ar_ids, ar_mask, xmask = _inputs(seed=6)
    exact = _port_app(hf, **KERNELS_OFF)
    wide = _port_app(_tiny_hf(max_num_images=2), **KERNELS_OFF)
    assert wide.max_sv == 2 * exact.max_sv
    a = exact.generate(ids, mask, pixels, ar_ids, ar_mask, xmask, max_new_tokens=6).sequences
    b = wide.generate(ids, mask, pixels, ar_ids, ar_mask, xmask, max_new_tokens=6).sequences
    np.testing.assert_array_equal(a, b)


def test_right_padded_rows_match_jax(hf):
    ids, mask, pixels, ar_ids, ar_mask, xmask = _inputs(S=10, B=2, seed=7)
    mask[1, 7:] = 0
    ids[1, 7:] = 0
    want = np.asarray(_jax_app(hf, B=2).generate(ids, mask, pixels, ar_ids, ar_mask, xmask, max_new_tokens=5).sequences)
    got = _port_app(hf, B=2, **KERNELS_OFF).generate(ids, mask, pixels, ar_ids, ar_mask, xmask, max_new_tokens=5)
    np.testing.assert_array_equal(got.sequences, want)


def test_bf16_matches_jax(hf):
    """bf16 on the same weights: the tower within BF16_TOWER_ATOL of JAX's
    bf16 tower and the greedy tokens equal."""
    ids, mask, pixels, ar_ids, ar_mask, xmask = _inputs(seed=8)
    japp = _jax_app(hf, dtype="bfloat16")
    app = _port_app(hf, dtype="bfloat16", **KERNELS_OFF)
    got = _port_tower(app, pixels, ar_ids, ar_mask)
    want = np.asarray(japp._vision_fn(
        japp.params["vision"], jnp.asarray(pixels), jnp.asarray(ar_ids, jnp.int32), jnp.asarray(ar_mask, jnp.int32)
    ).astype(jnp.float32))
    np.testing.assert_allclose(got, want, atol=BF16_TOWER_ATOL, rtol=0)
    a = app.generate(ids, mask, pixels, ar_ids, ar_mask, xmask, max_new_tokens=6).sequences
    b = np.asarray(japp.generate(ids, mask, pixels, ar_ids, ar_mask, xmask, max_new_tokens=6).sequences)
    np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kv", ["int8", "float8_e4m3"])
def test_quantized_kv_cache_refused(hf, kv):
    app = MllamaForConditionalGeneration(None, _port_cfg(hf, kv_cache_dtype=kv))
    with pytest.raises(NotImplementedError, match=r"ROADMAP C \(Mllama's quantized KV cache\)"):
        app.load(state_dict=_sd(hf))


def test_random_weights_refused(hf):
    app = MllamaForConditionalGeneration(None, _port_cfg(hf))
    with pytest.raises(NotImplementedError, match=r"random-weight init is test-only.*ROADMAP C"):
        app.load(random_weights=True)
    with pytest.raises(NotImplementedError, match="ROADMAP A11"):
        app.load()
