"""The port's image-to-text stacks held against the JAX package (and HF
``transformers`` models built in-process from a seed) on the CPU:

- the Pixtral tower and the Llama4 tower against JAX and HF (fp32 within
  TOWER_ATOL, the reference's own HF tolerance), the weights carried from
  the JAX package by ``params_from_jax``;
- ``ImageToTextModel.generate()`` for Pixtral (llava) and Llama4 against the
  JAX app: greedy tokens identical and logits within ATOL at fp32, with an
  image, without one (equal to the text app), on the kernels' head_dim 64
  through their plain versions, and with bf16 embeddings within BF16_ATOL
  of JAX's bf16 logits; the reference's refusals (placeholder count, an
  oversize image, a windowed prefill with embeddings, Llama4's random
  weights);
- the inputs_embeds prefill as a key of its own: its static inputs, its
  program key, the seal refusing an unwarmed embeds call and ``warmup()``
  capturing it under ``seal_suspended()``;
- ``EncoderApplication`` for the three registered towers, ``KeyError`` for
  an unknown name and ``NotImplementedError`` naming the ROADMAP item for
  ``whisper_encoder``."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuronx_distributed_inference_tpu.config import InferenceConfig as JaxInferenceConfig
from neuronx_distributed_inference_tpu.config import TpuConfig
from neuronx_distributed_inference_tpu.models.llama4_vision import llama4_vision_encoder as jax_llama4_tower
from neuronx_distributed_inference_tpu.models.pixtral import pixtral_vision_encoder as jax_pixtral_tower
from neuronx_distributed_inference_tpu.runtime.image_to_text import TpuImageToTextModel
from neuronx_distributed_inference_tpu_torch.analysis.retrace_guard import RetraceError
from neuronx_distributed_inference_tpu_torch.config import Config, InferenceConfig
from neuronx_distributed_inference_tpu_torch.models.builder import params_from_jax
from neuronx_distributed_inference_tpu_torch.models.llama4_vision import _pixel_shuffle, llama4_vision_encoder
from neuronx_distributed_inference_tpu_torch.models.pixtral import pixtral_rope_table, pixtral_vision_encoder
from neuronx_distributed_inference_tpu_torch.modules.sampling import prepare_sampling_params
from neuronx_distributed_inference_tpu_torch.runtime.encoder import EncoderApplication, get_encoder_factory
from neuronx_distributed_inference_tpu_torch.runtime.image_to_text import ImageToTextModel

#: fp32 logits of the two packages
ATOL = 1e-5
#: fp32 tower features (the reference's own HF parity bound)
TOWER_ATOL = 2e-5
#: bf16 logits of the two packages, each rounding its own bf16 products:
#: about 4x the largest gap measured on test_bf16_embeds_match_jax's inputs
#: (3.9e-3 over 4 steps for both towers; |logit| up to 0.66)
BF16_ATOL = 1.5e-2
#: bf16 merged embeddings: 3x the largest gap measured there (3.1e-5 at
#: |embedding| up to 0.066; the towers round at different places)
BF16_EMBED_ATOL = 1e-4
KERNELS_OFF = dict(attn_kernel_enabled=False, attn_block_tkg_kernel_enabled=False)
IMAGE_TOKEN = 99
N_NEW = 8


@pytest.fixture(scope="module", autouse=True)
def _threads():
    torch.set_num_threads(1)


def _hf_llava(text_hidden=64, heads=4, kv=2):
    from transformers import LlavaConfig, LlavaForConditionalGeneration, MistralConfig, PixtralVisionConfig

    vc = PixtralVisionConfig(
        hidden_size=64, intermediate_size=128, num_hidden_layers=2, num_attention_heads=4, image_size=64,
        patch_size=16, num_channels=3, rope_theta=10000.0,
    )
    tc = MistralConfig(
        vocab_size=128, hidden_size=text_hidden, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=heads, num_key_value_heads=kv, max_position_embeddings=256, sliding_window=None,
        tie_word_embeddings=False, eos_token_id=None, bos_token_id=None, attn_implementation="eager",
    )
    cfg = LlavaConfig(
        vision_config=vc, text_config=tc, image_token_index=IMAGE_TOKEN, projector_hidden_act="gelu",
        vision_feature_layer=-1, vision_feature_select_strategy="full",
    )
    torch.manual_seed(0)
    return LlavaForConditionalGeneration(cfg).eval().float()


def _hf_llama4():
    from transformers import Llama4Config, Llama4ForConditionalGeneration
    from transformers.models.llama4.configuration_llama4 import Llama4TextConfig, Llama4VisionConfig

    vision = Llama4VisionConfig(
        hidden_size=32, num_attention_heads=4, intermediate_size=128, num_hidden_layers=2, image_size=16,
        patch_size=8, pixel_shuffle_ratio=0.5, projector_input_dim=48, projector_output_dim=48,
        vision_output_dim=48, rope_theta=10000.0,
    )
    text = Llama4TextConfig(
        vocab_size=128, hidden_size=64, intermediate_size=128, intermediate_size_mlp=256, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, head_dim=16, num_local_experts=2, num_experts_per_tok=1,
        interleave_moe_layer_step=1, attention_chunk_size=4, max_position_embeddings=256, rope_theta=10000.0,
        rope_scaling=None, attn_implementation="eager", eos_token_id=None, bos_token_id=None, pad_token_id=0,
        tie_word_embeddings=False, attention_bias=False, use_qk_norm=True, attn_temperature_tuning=True,
        floor_scale=8, attn_scale=0.1,
    )
    cfg = Llama4Config(vision_config=vision, text_config=text, image_token_index=IMAGE_TOKEN)
    cfg._attn_implementation = "eager"
    torch.manual_seed(3)
    return Llama4ForConditionalGeneration(cfg).eval().float()


def _sd(hf):
    return {k: v.float().numpy() for k, v in hf.state_dict().items()}


def _loader(hf, llama4=False):
    hc = hf.config

    def load(c):
        if llama4:
            c.model_type = "llama4"
            c.text_config = hc.text_config.to_dict()
            c.vision_config = hc.vision_config.to_dict()
            c.image_token_index = hc.image_token_index
        else:
            for k, v in hc.to_dict().items():
                setattr(c, k, v)

    return load


def _jax_app(hf, llama4=False, **kw):
    tc = TpuConfig(**{**dict(batch_size=1, seq_len=64, dtype="float32", output_logits=True), **kw})
    app = TpuImageToTextModel(None, JaxInferenceConfig(tc, load_config=_loader(hf, llama4)))
    return app.load(state_dict=_sd(hf))


def _port_cfg(hf, llama4=False, **kw):
    tc = Config(**{**dict(batch_size=1, seq_len=64, dtype="float32", output_logits=True, device="cpu"), **kw})
    return InferenceConfig(tc, load_config=_loader(hf, llama4))


def _port_app(hf, llama4=False, jax_app=None, **kw):
    app = ImageToTextModel(None, _port_cfg(hf, llama4, **kw))
    if jax_app is None:
        return app.load(state_dict=_sd(hf))
    dt = torch.bfloat16 if kw.get("dtype") == "bfloat16" else torch.float32
    return app.load(params={
        "text": params_from_jax(jax_app.text.params, dt, "cpu"),
        "vision": params_from_jax(jax_app.vision_params, dt, "cpu"),
        "projector": params_from_jax(jax_app.projector, dt, "cpu"),
    })


@pytest.fixture(scope="module")
def llava():
    return _hf_llava()


@pytest.fixture(scope="module")
def llava_jax(llava):
    return _jax_app(llava)


@pytest.fixture(scope="module")
def llama4():
    return _hf_llama4()


@pytest.fixture(scope="module")
def llama4_jax(llama4):
    return _jax_app(llama4, llama4=True)


def _pixels(n, side, seed=1):
    return np.random.RandomState(seed).randn(n, 3, side, side).astype(np.float32)


#: one 64 x 64 image = 16 Pixtral features; one 16 x 16 image = 1 Llama4 feature
PIXTRAL_IDS = np.array([[1] + [IMAGE_TOKEN] * 16 + [5, 17, 9]])
LLAMA4_IDS = np.array([[1, IMAGE_TOKEN, 5, 17, 9, 22]])


def _same(port_out, jax_out, atol=ATOL):
    np.testing.assert_array_equal(port_out.sequences, np.asarray(jax_out.sequences))
    np.testing.assert_allclose(port_out.logits, np.asarray(jax_out.logits), atol=atol, rtol=0)


# ---------------------------------------------------------------------------
# the towers
# ---------------------------------------------------------------------------


def test_pixtral_rope_table_matches_jax():
    from neuronx_distributed_inference_tpu.models.pixtral import PixtralVisionSpec as JaxSpec
    from neuronx_distributed_inference_tpu.models.pixtral import pixtral_rope_table as jax_table
    from neuronx_distributed_inference_tpu_torch.models.pixtral import PixtralVisionSpec

    kw = dict(hidden_size=64, num_layers=1, num_heads=4, head_dim=16, patch_size=16, image_size=128)
    np.testing.assert_array_equal(pixtral_rope_table(PixtralVisionSpec(**kw)), np.asarray(jax_table(JaxSpec(**kw))))


@pytest.mark.parametrize("n_images", [1, 2])
def test_pixtral_tower_matches_jax_and_hf(llava, llava_jax, n_images):
    """Features of each image equal JAX's (weights carried by
    params_from_jax) and HF's PixtralVisionModel, called one image at a time
    (its batched call would attend across images)."""
    px = _pixels(n_images, 64)
    params = params_from_jax(llava_jax.vision_params, torch.float32, "cpu")
    app = _port_app(llava)
    got = pixtral_vision_encoder(params, torch.from_numpy(px), app.vision_spec).numpy()
    want = np.asarray(jax_pixtral_tower(llava_jax.vision_params, jnp.asarray(px), llava_jax.vision_spec))
    np.testing.assert_allclose(got, want, atol=TOWER_ATOL, rtol=0)
    mine = pixtral_vision_encoder(app.vision_params, torch.from_numpy(px), app.vision_spec).numpy()
    np.testing.assert_allclose(mine, got, atol=TOWER_ATOL, rtol=0)
    vt = llava.model.vision_tower
    with torch.no_grad():
        hf = np.concatenate([vt(torch.tensor(px[i : i + 1])).last_hidden_state.numpy() for i in range(n_images)], 0)
    np.testing.assert_allclose(got.reshape(hf.shape), hf, atol=5e-3, rtol=5e-3)


def test_pixtral_tower_smaller_image_uses_its_grid(llava, llava_jax):
    """A 32 x 32 image takes its 2 x 2 grid's rows of the rope table."""
    px = _pixels(1, 32, seed=5)
    app = _port_app(llava)
    got = pixtral_vision_encoder(app.vision_params, torch.from_numpy(px), app.vision_spec).numpy()
    want = np.asarray(jax_pixtral_tower(llava_jax.vision_params, jnp.asarray(px), llava_jax.vision_spec))
    assert got.shape == (1, 4, 64)
    np.testing.assert_allclose(got, want, atol=TOWER_ATOL, rtol=0)


def test_llama4_tower_matches_jax_and_hf(llama4, llama4_jax):
    px = _pixels(2, 16, seed=2)
    app = _port_app(llama4, llama4=True)
    got = llama4_vision_encoder(app.vision_params, torch.from_numpy(px), app.vision_spec).numpy()
    want = np.asarray(jax_llama4_tower(llama4_jax.vision_params, jnp.asarray(px), llama4_jax.vision_spec))
    np.testing.assert_allclose(got, want, atol=TOWER_ATOL, rtol=0)
    with torch.no_grad():
        hf = llama4.vision_model(torch.tensor(px)).last_hidden_state.numpy()
    np.testing.assert_allclose(got, hf, atol=TOWER_ATOL, rtol=0)
    carried = params_from_jax(llama4_jax.vision_params, torch.float32, "cpu")
    np.testing.assert_allclose(
        llama4_vision_encoder(carried, torch.from_numpy(px), app.vision_spec).numpy(), want, atol=TOWER_ATOL, rtol=0
    )


def test_llama4_pixel_shuffle_matches_jax():
    """The two transposes around the channel merges (a plain reshape would
    pass a test on a symmetric input; this one is a ramp)."""
    from neuronx_distributed_inference_tpu.models.llama4_vision import _pixel_shuffle as jax_shuffle

    x = np.arange(2 * 16 * 8, dtype=np.float32).reshape(2, 16, 8)
    got = _pixel_shuffle(torch.from_numpy(x), 0.5).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_shuffle(jnp.asarray(x), 0.5)))
    assert not np.array_equal(got, x.reshape(got.shape))


def test_llama4_vision_rope_matches_jax(llama4, llama4_jax):
    from neuronx_distributed_inference_tpu.models.llama4_vision import llama4_vision_rope as jax_rope
    from neuronx_distributed_inference_tpu_torch.models.llama4_vision import llama4_vision_rope

    app = _port_app(llama4, llama4=True)
    for got, want in zip(llama4_vision_rope(app.vision_spec), jax_rope(llama4_jax.vision_spec)):
        np.testing.assert_array_equal(got, np.asarray(want))
    # the class token (last row) does not rotate
    assert np.all(llama4_vision_rope(app.vision_spec)[0][-1] == 1.0)


# ---------------------------------------------------------------------------
# image-to-text generate()
# ---------------------------------------------------------------------------


def test_pixtral_generate_matches_jax(llava, llava_jax):
    px = _pixels(1, 64)
    mask = np.ones_like(PIXTRAL_IDS)
    want = llava_jax.generate(PIXTRAL_IDS, mask, pixel_values=px, max_new_tokens=N_NEW)
    got = _port_app(llava, **KERNELS_OFF).generate(PIXTRAL_IDS, mask, pixel_values=px, max_new_tokens=N_NEW)
    _same(got, want)
    carried = _port_app(llava, jax_app=llava_jax, **KERNELS_OFF)
    _same(carried.generate(PIXTRAL_IDS, mask, pixel_values=px, max_new_tokens=N_NEW), want)


def test_pixtral_generate_matches_hf(llava):
    px = _pixels(1, 64)
    mask = np.ones_like(PIXTRAL_IDS)
    with torch.no_grad():
        ref = llava.generate(
            input_ids=torch.tensor(PIXTRAL_IDS), attention_mask=torch.tensor(mask), pixel_values=torch.tensor(px),
            max_new_tokens=N_NEW, do_sample=False, pad_token_id=0,
        ).numpy()
    got = _port_app(llava, **KERNELS_OFF).generate(PIXTRAL_IDS, mask, pixel_values=px, max_new_tokens=N_NEW)
    np.testing.assert_array_equal(got.sequences, ref)


def test_pixtral_generate_on_the_kernels_head_dim_matches_jax():
    """Text heads of 64 (2 q / 1 kv): the prefill and decode go through the
    B2 and B1 wrappers (their plain versions on the CPU); the image moves
    the tokens."""
    hf = _hf_llava(text_hidden=128, heads=2, kv=1)
    japp = _jax_app(hf)
    px = _pixels(1, 64, seed=4)
    mask = np.ones_like(PIXTRAL_IDS)
    want = japp.generate(PIXTRAL_IDS, mask, pixel_values=px, max_new_tokens=N_NEW)
    app = _port_app(hf)
    assert app.text.spec.attn.head_dim == 64
    _same(app.generate(PIXTRAL_IDS, mask, pixel_values=px, max_new_tokens=N_NEW), want)
    blank = app.generate(PIXTRAL_IDS, mask, pixel_values=np.zeros_like(px), max_new_tokens=N_NEW)
    assert np.abs(blank.logits - np.asarray(want.logits)).max() > 1e-3


def test_pixtral_batch_of_two_images_matches_jax(llava):
    """Two rows, one image each, the second row right-padded: the features
    splice in raster order, row by row."""
    japp = _jax_app(llava, batch_size=2)
    ids = np.array([[1] + [IMAGE_TOKEN] * 16 + [5, 17, 9], [2, 3] + [IMAGE_TOKEN] * 16 + [8, 0]])
    mask = np.array([[1] * 20, [1] * 19 + [0]])
    px = _pixels(2, 64, seed=6)
    want = japp.generate(ids, mask, pixel_values=px, max_new_tokens=N_NEW)
    got = _port_app(llava, batch_size=2, **KERNELS_OFF).generate(ids, mask, pixel_values=px, max_new_tokens=N_NEW)
    _same(got, want)


@pytest.mark.parametrize("kind", ["pixtral", "llama4"])
def test_without_an_image_matches_the_text_app(llava, llama4, kind):
    hf = llava if kind == "pixtral" else llama4
    app = _port_app(hf, llama4=kind == "llama4", **KERNELS_OFF)
    ids = np.array([[1, 5, 17, 9, 22]])
    mask = np.ones_like(ids)
    out = app.generate(ids, mask, max_new_tokens=6)
    ref = app.text.generate(ids, mask, max_new_tokens=6)
    np.testing.assert_array_equal(out.sequences, ref.sequences)
    np.testing.assert_array_equal(out.logits, ref.logits)


@pytest.mark.parametrize("kind", ["pixtral", "llama4"])
def test_without_an_image_matches_jax(llava, llava_jax, llama4, llama4_jax, kind):
    hf, japp = (llava, llava_jax) if kind == "pixtral" else (llama4, llama4_jax)
    ids = np.array([[1, 5, 17, 9, 22]])
    mask = np.ones_like(ids)
    want = japp.generate(ids, mask, max_new_tokens=6)
    _same(_port_app(hf, llama4=kind == "llama4", **KERNELS_OFF).generate(ids, mask, max_new_tokens=6), want)


def test_llama4_generate_matches_jax(llama4, llama4_jax):
    px = _pixels(1, 16)
    mask = np.ones_like(LLAMA4_IDS)
    want = llama4_jax.generate(LLAMA4_IDS, mask, pixel_values=px, max_new_tokens=N_NEW)
    _same(_port_app(llama4, llama4=True, **KERNELS_OFF).generate(LLAMA4_IDS, mask, pixel_values=px,
                                                                max_new_tokens=N_NEW), want)
    carried = _port_app(llama4, llama4=True, jax_app=llama4_jax, **KERNELS_OFF)
    _same(carried.generate(LLAMA4_IDS, mask, pixel_values=px, max_new_tokens=N_NEW), want)


def test_llama4_generate_matches_hf(llama4):
    """Greedy tokens equal HF Llama4ForConditionalGeneration's (the JAX
    package runs this oracle marked slow; the port's stays small)."""
    px = _pixels(1, 16)
    mask = np.ones_like(LLAMA4_IDS)
    with torch.no_grad():
        ref = llama4.generate(
            input_ids=torch.tensor(LLAMA4_IDS), attention_mask=torch.tensor(mask), pixel_values=torch.tensor(px),
            max_new_tokens=N_NEW, do_sample=False, pad_token_id=0,
        ).numpy()
    got = _port_app(llama4, llama4=True, **KERNELS_OFF).generate(LLAMA4_IDS, mask, pixel_values=px,
                                                                 max_new_tokens=N_NEW)
    np.testing.assert_array_equal(got.sequences, ref)


@pytest.mark.parametrize("kind", ["pixtral", "llama4"])
def test_bf16_embeds_match_jax(llava, llama4, kind):
    """A bf16 app keeps bf16 embeddings through the multimodal path; its
    logits sit within BF16_ATOL of the JAX package's bf16 run on the same
    weights, its tokens equal."""
    hf, ids, side = (llava, PIXTRAL_IDS, 64) if kind == "pixtral" else (llama4, LLAMA4_IDS, 16)
    l4 = kind == "llama4"
    japp = _jax_app(hf, l4, dtype="bfloat16")
    app = _port_app(hf, l4, jax_app=japp, dtype="bfloat16", **KERNELS_OFF)
    px = _pixels(1, side, seed=3)
    embeds = app.merge_embeddings(ids, app.encode_images(px))
    assert embeds.dtype == torch.bfloat16
    jemb = np.asarray(japp.merge_embeddings(ids, japp.encode_images(px)).astype(jnp.float32))
    np.testing.assert_allclose(embeds.float().numpy(), jemb, atol=BF16_EMBED_ATOL, rtol=0)
    mask = np.ones_like(ids)
    got = app.generate(ids, mask, pixel_values=px, max_new_tokens=4)
    want = japp.generate(ids, mask, pixel_values=px, max_new_tokens=4)
    np.testing.assert_array_equal(got.sequences, np.asarray(want.sequences))
    np.testing.assert_allclose(got.logits, np.asarray(want.logits, np.float32), atol=BF16_ATOL, rtol=0)


@pytest.mark.parametrize("kind", ["pixtral", "llama4"])
def test_image_token_count_mismatch_raises(llava, llama4, kind):
    hf, side = (llava, 64) if kind == "pixtral" else (llama4, 16)
    app = _port_app(hf, llama4=kind == "llama4", **KERNELS_OFF)
    ids = np.array([[1, IMAGE_TOKEN, IMAGE_TOKEN, 5]])
    with pytest.raises(ValueError, match="image tokens"):
        app.generate(ids, np.ones_like(ids), pixel_values=np.zeros((1, 3, side, side), np.float32), max_new_tokens=2)


def test_oversize_image_raises(llava):
    app = _port_app(llava, **KERNELS_OFF)
    ids = np.array([[1] + [IMAGE_TOKEN] * 64])
    with pytest.raises(ValueError, match="rope table"):
        app.generate(ids, np.ones_like(ids), pixel_values=np.zeros((1, 3, 128, 128), np.float32), max_new_tokens=2)


@pytest.mark.parametrize("kind", ["pixtral", "llama4"])
def test_windowed_prefill_with_embeds_raises(llava, llama4, kind):
    """A prompt longer than max_context_length prefills in windows, which
    take no embeddings: the reference's refusal, naming its ROADMAP item."""
    hf, ids, side = (llava, PIXTRAL_IDS, 64) if kind == "pixtral" else (llama4, LLAMA4_IDS, 16)
    app = _port_app(hf, llama4=kind == "llama4", max_context_length=4, **KERNELS_OFF)
    with pytest.raises(NotImplementedError, match=r"inputs_embeds with windowed prefill.*ROADMAP C"):
        app.generate(ids, np.ones_like(ids), pixel_values=_pixels(1, side), max_new_tokens=2)


def test_llama4_random_weights_refused(llama4):
    with pytest.raises(NotImplementedError, match="llama4-vision random init"):
        ImageToTextModel(None, _port_cfg(llama4, llama4=True)).load(random_weights=True)


def test_pixtral_random_weights_mirror_the_reference(llava):
    """Seeded random weights: the tower's MLP 2 x hidden wide (the
    reference's random tower), the projector's biases zero; a generate()
    with an image runs and differs from the same prompt's placeholders."""
    app = ImageToTextModel(None, _port_cfg(llava, **KERNELS_OFF)).load(random_weights=True)
    H = app.vision_spec.hidden_size
    assert app.vision_params["layers"]["feed_forward"]["gate_proj"]["weight"].shape == (2, H, 2 * H)
    assert float(app.projector["linear_1"]["bias"].abs().max()) == 0.0
    out = app.generate(PIXTRAL_IDS, np.ones_like(PIXTRAL_IDS), pixel_values=_pixels(1, 64), max_new_tokens=4)
    assert out.sequences.shape == (1, PIXTRAL_IDS.shape[1] + 4)


# ---------------------------------------------------------------------------
# the inputs_embeds prefill key
# ---------------------------------------------------------------------------


def _embeds_keys(runner):
    return {k for k in runner._prog.seen if k[5] is not None}


def test_embeds_prefill_is_a_key_of_its_own(llava):
    """The embeddings are a static input of their own, and the program key
    of an embeds call differs from the same bucket's token-id call: neither
    call can replay the other's graph."""
    app = _port_app(llava, **KERNELS_OFF)
    cte = app.text.context_encoding_model
    app.generate(PIXTRAL_IDS, np.ones_like(PIXTRAL_IDS), pixel_values=_pixels(1, 64), max_new_tokens=2)
    app.generate(PIXTRAL_IDS, np.ones_like(PIXTRAL_IDS), max_new_tokens=2)
    keys = cte._prog.seen
    with_e = _embeds_keys(cte)
    assert len(with_e) == 1 and len(keys - with_e) == 1
    (ke,), (kt,) = with_e, keys - with_e
    assert ke[:4] == kt[:4] and ke[4] == ("inputs_embeds",) and kt[4] == ()
    assert ke[5] == (64, torch.float32)
    statics = [k for k in cte._prog.statics if k[0] == "step"]
    assert len(statics) == 2 and {k[3] for k in statics} == {(), ("inputs_embeds",)}


def test_prepare_pads_embeds_with_zeros(llava):
    """prepare() pads the embeddings to the bucket and the compiled batch
    with zeros (the reference's), over whatever a longer call left."""
    app = _port_app(llava, batch_size=2, context_encoding_buckets=[32, 64], **KERNELS_OFF)
    cte = app.text.context_encoding_model
    H = 64
    long = torch.ones((2, 30, H))
    inputs, _ = cte.prepare(np.zeros((2, 30), np.int64), np.ones((2, 30)), np.tile(np.arange(30), (2, 1)),
                            np.arange(2, dtype=np.int32), prepare_sampling_params(2), inputs_embeds=long)
    assert inputs.inputs_embeds.shape == (2, 32, H)
    short = torch.full((1, 5, H), 2.0)
    inputs, _ = cte.prepare(np.zeros((1, 5), np.int64), np.ones((1, 5)), np.arange(5)[None], np.zeros(1, np.int32),
                            prepare_sampling_params(1), inputs_embeds=short)
    e = inputs.inputs_embeds
    assert e.shape == (2, 32, H)
    assert torch.equal(e[0, :5], short[0]) and float(e[0, 5:].abs().max()) == 0.0 and float(e[1].abs().max()) == 0.0


def test_prepare_refuses_embeddings_past_the_compiled_shape(llava):
    """More rows than the compiled batch, or more positions than the
    bucket of the ids, raise instead of being cut."""
    app = _port_app(llava, **KERNELS_OFF)
    cte = app.text.context_encoding_model
    ids = np.zeros((2, 8), np.int64)
    with pytest.raises(ValueError, match="compiled batch"):
        cte.prepare(ids, np.ones((2, 8)), np.tile(np.arange(8), (2, 1)), np.arange(2, dtype=np.int32),
                    prepare_sampling_params(2), inputs_embeds=torch.zeros((2, 8, 64)))
    with pytest.raises(ValueError, match="exceeds the compiled"):
        cte.prepare(ids[:1], np.ones((1, 8)), np.arange(8)[None], np.zeros(1, np.int32), prepare_sampling_params(1),
                    inputs_embeds=torch.zeros((1, 80, 64)))


def test_sealed_runner_refuses_an_unwarmed_embeds_call(llava):
    """The text app's warmup seals the context runner (retrace_guard): an
    embeds call it never warmed raises RetraceError before it runs; the
    image app's warmup captures the embeds programs under
    seal_suspended(), and then the same call runs, sealed."""
    app = _port_app(llava, retrace_guard=True, **KERNELS_OFF)
    app.text.warmup()
    cte = app.text.context_encoding_model
    assert cte.sealed
    px = _pixels(1, 64)
    with pytest.raises(RetraceError):
        app.generate(PIXTRAL_IDS, np.ones_like(PIXTRAL_IDS), pixel_values=px, max_new_tokens=2)
    app2 = _port_app(llava, retrace_guard=True, **KERNELS_OFF).warmup()
    cte2 = app2.text.context_encoding_model
    assert cte2.sealed and {k[3] for k in _embeds_keys(cte2)} == set(cte2.buckets)
    out = app2.generate(PIXTRAL_IDS, np.ones_like(PIXTRAL_IDS), pixel_values=px, max_new_tokens=2)
    ref = _port_app(llava, **KERNELS_OFF).generate(PIXTRAL_IDS, np.ones_like(PIXTRAL_IDS), pixel_values=px,
                                                  max_new_tokens=2)
    np.testing.assert_array_equal(out.sequences, ref.sequences)


def test_embeds_call_matches_token_call_on_the_same_embeddings(llava):
    """Embeddings equal to the token embeddings give the token call's
    logits exactly: the embeds field only replaces embed(input_ids)."""
    app = _port_app(llava, **KERNELS_OFF)
    ids = np.array([[1, 5, 17, 9, 22]])
    from neuronx_distributed_inference_tpu_torch.models.base import embed

    e = embed(app.text.params, torch.from_numpy(ids))
    a = app.text.generate(ids, max_new_tokens=4, inputs_embeds=e)
    b = app.text.generate(ids, max_new_tokens=4)
    np.testing.assert_array_equal(a.sequences, b.sequences)
    np.testing.assert_array_equal(a.logits, b.logits)


# ---------------------------------------------------------------------------
# the encoder application
# ---------------------------------------------------------------------------


class _EncCfg:
    def __init__(self, vision_config, dtype="float32"):
        self.vision_config = vision_config
        self.torch_config = Config(batch_size=1, seq_len=16, dtype=dtype, device="cpu")


def test_encoder_app_llama4_vision_matches_hf_and_jax(llama4, llama4_jax):
    app = EncoderApplication.from_registry("llama4_vision", _EncCfg(llama4.config.vision_config.to_dict()))
    app.load(state_dict=_sd(llama4))
    px = _pixels(1, 16, seed=0)
    app.warmup(px)
    feats = app(px).numpy()
    with torch.no_grad():
        ref = llama4.vision_model(torch.tensor(px)).last_hidden_state.numpy()
    np.testing.assert_allclose(feats, ref, atol=TOWER_ATOL, rtol=TOWER_ATOL)
    want = np.asarray(jax_llama4_tower(llama4_jax.vision_params, jnp.asarray(px), llama4_jax.vision_spec))
    np.testing.assert_allclose(feats, want, atol=TOWER_ATOL, rtol=0)


def test_encoder_app_pixtral_matches_the_app_tower(llava, llava_jax):
    app = EncoderApplication.from_registry("pixtral", _EncCfg(llava.config.vision_config.to_dict())).load(
        state_dict=_sd(llava)
    )
    px = _pixels(2, 64, seed=7)
    want = np.asarray(jax_pixtral_tower(llava_jax.vision_params, jnp.asarray(px), llava_jax.vision_spec))
    np.testing.assert_allclose(app.encode(px).numpy(), want, atol=TOWER_ATOL, rtol=0)


def test_encoder_app_params_and_dtype(llava):
    """``params=`` taken as they are; a bf16 config converts in bf16."""
    cfg = _EncCfg(llava.config.vision_config.to_dict(), dtype="bfloat16")
    app = EncoderApplication.from_registry("pixtral", cfg).load(state_dict=_sd(llava))
    assert app.params["layers"]["attention"]["q_proj"]["weight"].dtype == torch.bfloat16
    assert app.params["rope"]["table"].dtype == torch.float32
    same = EncoderApplication.from_registry("pixtral", cfg).load(params=app.params)
    assert same.params is app.params
    with pytest.raises(RuntimeError, match="load"):
        EncoderApplication.from_registry("pixtral", cfg)(np.zeros((1, 3, 64, 64), np.float32))


def test_encoder_registry_unknown_and_whisper():
    """An unknown name raises; ``whisper_encoder`` builds the Whisper
    encoder, equal to the JAX package's on a tiny seeded HF Whisper."""
    from transformers import WhisperConfig, WhisperForConditionalGeneration

    from neuronx_distributed_inference_tpu.models.whisper import whisper_encoder as jax_whisper_encoder
    from neuronx_distributed_inference_tpu.models.whisper import convert_whisper_state_dict, whisper_spec

    with pytest.raises(KeyError, match="unknown encoder"):
        get_encoder_factory("nope")
    hf_cfg = WhisperConfig(vocab_size=64, d_model=64, encoder_layers=2, decoder_layers=1, encoder_attention_heads=4,
                           decoder_attention_heads=4, encoder_ffn_dim=96, decoder_ffn_dim=96, num_mel_bins=8,
                           max_source_positions=16, max_target_positions=16, pad_token_id=0, bos_token_id=1,
                           eos_token_id=2, decoder_start_token_id=1)
    torch.manual_seed(3)
    sd = {k: v.float().numpy() for k, v in WhisperForConditionalGeneration(hf_cfg).state_dict().items()}
    cfg = InferenceConfig(Config(batch_size=1, seq_len=16, dtype="float32", device="cpu"),
                          load_config=lambda c: [setattr(c, k, v) for k, v in hf_cfg.to_dict().items()])
    app = EncoderApplication.from_registry("whisper_encoder", cfg).load(state_dict=sd)
    feats = np.random.RandomState(0).randn(2, 8, 32).astype(np.float32)
    spec = whisper_spec(hf_cfg.to_dict())
    want = jax_whisper_encoder(convert_whisper_state_dict(sd, spec, jnp.float32)["encoder"], jnp.asarray(feats), spec)
    np.testing.assert_allclose(app(feats).numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_encoder_app_defaults_to_the_card(llava):
    """No device named: the card, which this machine lacks, so it raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cfg = _EncCfg(llava.config.vision_config.to_dict())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cfg.torch_config = dataclasses.replace(cfg.torch_config, device="cuda")
        EncoderApplication.from_registry("pixtral", cfg)
