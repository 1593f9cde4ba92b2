"""FLUX in the port, held against the JAX package on the CPU at fp32 (and
against the reference tests' oracles: ``transformers``' CLIP / T5 built
in-process from a seed, and ``tests/test_flux.py``'s torch-built VAE
decoder), on the reference tests' tiny specs:

- CLIP with both EOS conventions, T5 with a padded row, the VAE decoder;
- the DiT's ``flux_forward`` with and without guidance, and its diffusers
  conversion from a synthetic state dict (the JAX tree under diffusers'
  names); ``flow_match_sigmas``, ``pack_latents`` / ``unpack_latents``;
- the seeded random trees equal to JAX's bit for bit, the weight carry;
- the whole pipeline against JAX's with the same initial noise (JAX's
  ``jax.random.normal`` replaced through monkeypatch), the seed's
  determinism, and a multi-device mesh's refusal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers

from neuronx_distributed_inference_tpu.models import flux as jflux
from neuronx_distributed_inference_tpu.models import flux_text as jtext
from neuronx_distributed_inference_tpu.models import flux_vae as jvae
from neuronx_distributed_inference_tpu.runtime import flux as jrt
from neuronx_distributed_inference_tpu_torch.models import flux as tflux
from neuronx_distributed_inference_tpu_torch.models import flux_text as ttext
from neuronx_distributed_inference_tpu_torch.models import flux_vae as tvae
from neuronx_distributed_inference_tpu_torch.models.builder import params_from_jax, vae_params_from_jax
from neuronx_distributed_inference_tpu_torch.runtime import flux as trt

from test_flux import _torch_vae_decoder

ATOL = 1e-5
#: the VAE decoder, as the reference's own oracle bound
VAE_ATOL = 3e-5
TINY = dict(dim=64, num_heads=4, head_dim=16, num_dual=2, num_single=2, in_channels=16, joint_dim=32, pooled_dim=24,
            guidance_embeds=True, axes_dims_rope=(4, 6, 6))
CLIP = dict(hidden_size=24, num_heads=2, num_layers=2, intermediate_size=48, vocab_size=64, max_positions=16,
            eos_token_id=2)
T5 = dict(d_model=32, num_heads=2, d_kv=16, num_layers=2, d_ff=64, vocab_size=64)
VAE = dict(latent_channels=4, block_out_channels=(16, 16), layers_per_block=1, norm_groups=4)


@pytest.fixture(scope="module", autouse=True)
def _threads():
    torch.set_num_threads(1)


def _np_tree(t):
    return jax.tree.map(np.asarray, t)


def _cmp_tree(port, ref, exact=False):
    if isinstance(ref, dict):
        assert set(port) == set(ref)
        for k in ref:
            _cmp_tree(port[k], ref[k], exact)
    elif isinstance(ref, (list, tuple)):
        assert len(port) == len(ref)
        for p, r in zip(port, ref):
            _cmp_tree(p, r, exact)
    else:
        got, want = port.float().numpy(), np.asarray(ref, np.float32)
        assert got.shape == want.shape
        if exact:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


# ---------------------------------------------------------------------------
# text encoders and the VAE
# ---------------------------------------------------------------------------


#: CLIP ids laid out as the reference test's (tests/test_flux.py IDS) on a
#: 512-token vocab: BOS 510, the end token 511 (the vocab's last, as 49407
#: is openai/clip-vit-large-patch14's), padding 0
CLIP_TEST_IDS = np.array([[510, 320, 107, 511, 0, 0], [510, 107, 30, 320, 107, 511]])


@pytest.mark.parametrize("eos", [511, 2])
def test_clip_text_matches_jax_and_hf(eos):
    """Both pooling conventions: the first true EOS, and the legacy id 2's
    argmax(input_ids) (FLUX's CLIP): hidden and pooled within ATOL of
    JAX's, 2e-5 of HF's (the reference's bound)."""
    IDS = CLIP_TEST_IDS
    cfg = transformers.CLIPTextConfig(
        vocab_size=512, hidden_size=64, intermediate_size=128, num_hidden_layers=3, num_attention_heads=4,
        max_position_embeddings=77, hidden_act="quick_gelu", eos_token_id=eos, bos_token_id=510,
    )
    torch.manual_seed(0)
    hf = transformers.CLIPTextModel(cfg).eval()
    sd = {k: v.detach().numpy() for k, v in hf.state_dict().items()}
    kw = dict(hidden_size=64, num_heads=4, num_layers=3, intermediate_size=128, vocab_size=512, max_positions=77,
              eos_token_id=eos)
    params = ttext.convert_clip_text_state_dict(sd, ttext.ClipTextSpec(**kw))
    hidden, pooled = ttext.clip_text_encode(params, torch.as_tensor(IDS), spec=ttext.ClipTextSpec(**kw))
    jspec = jtext.ClipTextSpec(**kw)
    jh, jp = jtext.clip_text_encode(jtext.convert_clip_text_state_dict(sd, jspec), jnp.asarray(IDS), spec=jspec)
    np.testing.assert_allclose(hidden.numpy(), np.asarray(jh), atol=ATOL, rtol=0)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(jp), atol=ATOL, rtol=0)
    with torch.no_grad():
        ref = hf(input_ids=torch.tensor(IDS))
    np.testing.assert_allclose(pooled.numpy(), ref.pooler_output.numpy(), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(hidden.numpy(), ref.last_hidden_state.numpy(), atol=2e-5, rtol=2e-5)


def test_t5_encoder_with_a_padded_row_matches_jax_and_hf():
    cfg = transformers.T5Config(
        vocab_size=512, d_model=64, d_kv=16, d_ff=128, num_layers=3, num_heads=4, relative_attention_num_buckets=32,
        relative_attention_max_distance=128, feed_forward_proj="gated-gelu", dense_act_fn="gelu_new",
        is_gated_act=True, tie_word_embeddings=False,
    )
    torch.manual_seed(1)
    hf = transformers.T5EncoderModel(cfg).eval()
    sd = {k: v.detach().numpy() for k, v in hf.state_dict().items()}
    kw = dict(d_model=64, num_heads=4, d_kv=16, num_layers=3, d_ff=128, vocab_size=512)
    # 40 tokens: relative distances past the exact buckets, into the log ones
    rng = np.random.RandomState(2)
    ids = rng.randint(2, 512, size=(2, 40))
    mask = np.ones((2, 40), np.int64)
    mask[1, 25:] = 0
    ids[1, 25:] = 0
    out = ttext.t5_encode(ttext.convert_t5_state_dict(sd, ttext.T5EncoderSpec(**kw)), torch.as_tensor(ids),
                          torch.as_tensor(mask), spec=ttext.T5EncoderSpec(**kw)).numpy()
    jspec = jtext.T5EncoderSpec(**kw)
    want = jtext.t5_encode(jtext.convert_t5_state_dict(sd, jspec), jnp.asarray(ids), jnp.asarray(mask), spec=jspec)
    np.testing.assert_allclose(out, np.asarray(want), atol=ATOL, rtol=0)
    with torch.no_grad():
        ref = hf(input_ids=torch.tensor(ids), attention_mask=torch.tensor(mask)).last_hidden_state.numpy()
    for b in range(2):  # HF lets padded queries attend freely: valid rows only
        n = int(mask[b].sum())
        np.testing.assert_allclose(out[b, :n], ref[b, :n], atol=3e-5, rtol=3e-5)
    rel = np.arange(200)[None, :] - np.arange(200)[:, None]
    np.testing.assert_array_equal(ttext._t5_rel_bucket(torch.as_tensor(rel), 32, 128).numpy(),
                                  np.asarray(jtext._t5_rel_bucket(jnp.asarray(rel), 32, 128)))


def test_vae_decoder_matches_jax_and_the_torch_oracle():
    """The reference test's torch-built decoder under diffusers' names:
    the port's image within VAE_ATOL of JAX's and the oracle's, on the
    reference's (B, 8h, 8w, 3) NHWC layout."""

    dec = _torch_vae_decoder()
    kw = dict(latent_channels=8, block_out_channels=(32, 64), layers_per_block=2, norm_groups=8, scaling_factor=1.0,
              shift_factor=0.0)
    ren = {
        "conv_in": "decoder.conv_in", "mid_r0": "decoder.mid_block.resnets.0",
        "mid_r1": "decoder.mid_block.resnets.1", "mid_attn.group_norm": "decoder.mid_block.attentions.0.group_norm",
        "mid_attn.to_q": "decoder.mid_block.attentions.0.to_q", "mid_attn.to_k": "decoder.mid_block.attentions.0.to_k",
        "mid_attn.to_v": "decoder.mid_block.attentions.0.to_v",
        "mid_attn.to_out": "decoder.mid_block.attentions.0.to_out.0", "ups.0": "decoder.up_blocks.0.resnets",
        "ups.1": "decoder.up_blocks.1.resnets", "up_convs.0": "decoder.up_blocks.0.upsamplers.0.conv",
        "norm_out": "decoder.conv_norm_out", "conv_out": "decoder.conv_out",
    }
    sd = {}
    for k, v in dec.state_dict().items():
        for old, new in ren.items():
            if k.startswith(old + "."):
                k = new + k[len(old):]
                break
        sd[k.replace(".short.", ".conv_shortcut.")] = v.numpy()
    z = np.random.RandomState(0).randn(2, 6, 5, 8).astype(np.float32)
    out = tvae.vae_decode(tvae.convert_vae_decoder_state_dict(sd, tvae.VaeDecoderSpec(**kw)), torch.as_tensor(z),
                          spec=tvae.VaeDecoderSpec(**kw)).numpy()
    jspec = jvae.VaeDecoderSpec(**kw)
    want = jvae.vae_decode(jvae.convert_vae_decoder_state_dict(sd, jspec), jnp.asarray(z), spec=jspec)
    assert out.shape == (2, 12, 10, 3)
    np.testing.assert_allclose(out, np.asarray(want), atol=VAE_ATOL, rtol=0)
    with torch.no_grad():
        ref = dec(torch.tensor(z).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(out, ref, atol=VAE_ATOL, rtol=VAE_ATOL)


# ---------------------------------------------------------------------------
# the DiT
# ---------------------------------------------------------------------------


def _dit_inputs(spec, B=2, h2=4, w2=3, Lt=6, seed=0):
    rng = np.random.RandomState(seed)
    return (
        rng.randn(B, h2 * w2, spec["in_channels"]).astype(np.float32),
        rng.randn(B, Lt, spec["joint_dim"]).astype(np.float32),
        rng.randn(B, spec["pooled_dim"]).astype(np.float32),
        np.full(B, 0.7, np.float32),
        jflux.latent_image_ids(h2, w2),
        np.zeros((Lt, 3), np.float32),
    )


@pytest.mark.parametrize("guidance", ["given", "default", "none"])
def test_flux_forward_matches_jax(guidance):
    """One velocity on a non-square 4 x 3 grid, from the same seeded
    params: with guidance given, defaulted to 3.5, and a spec without the
    guidance embedding (schnell)."""
    spec = dict(TINY, guidance_embeds=guidance != "none")
    jspec, tspec = jflux.FluxSpec(**spec), tflux.FluxSpec(**spec)
    jp = jflux.flux_random_params(jspec, seed=3)
    tp = tflux.flux_random_params(tspec, seed=3)
    _cmp_tree(tp, jp, exact=True)
    args = _dit_inputs(spec)
    g = np.full(2, 3.5, np.float32) if guidance == "given" else None
    want = jflux.flux_forward(jp, *map(jnp.asarray, args), None if g is None else jnp.asarray(g), spec=jspec)
    got = tflux.flux_forward(tp, *map(torch.as_tensor, args), None if g is None else torch.as_tensor(g), spec=tspec)
    assert got.shape == (2, 12, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_flux_state_dict_conversion_matches_jax():
    """A synthetic diffusers state dict, made from the JAX tree by inverting
    the reference's mapping (diffusers is not installed): the port's
    conversion equals JAX's, and the JAX tree carried by params_from_jax
    computes the same velocity."""
    jspec, tspec = jflux.FluxSpec(**TINY), tflux.FluxSpec(**TINY)
    jp = _np_tree(jflux.flux_random_params(jspec, seed=5))
    sd = {}

    def put(name, lin):
        sd[name + ".weight"] = np.asarray(lin["weight"]).T
        sd[name + ".bias"] = np.asarray(lin["bias"])

    for src, dst in (("x_embedder", "x_embedder"), ("context_embedder", "context_embedder"), ("proj_out", "proj_out")):
        put(dst, jp[src])
    put("norm_out.linear", jp["norm_out"]["linear"])
    for src, dst in (("time_embed", "timestep_embedder"), ("text_embed", "text_embedder"),
                     ("guidance_embed", "guidance_embedder")):
        for n in ("linear_1", "linear_2"):
            put(f"time_text_embed.{dst}.{n}", jp[src][n])
    for i in range(jspec.num_dual):
        blk = jax.tree.map(lambda a: a[i], jp["dual_blocks"])
        p = f"transformer_blocks.{i}."
        put(p + "norm1.linear", blk["norm1"]["linear"])
        put(p + "norm1_context.linear", blk["norm1_context"]["linear"])
        for n in ("to_q", "to_k", "to_v", "add_q_proj", "add_k_proj", "add_v_proj", "to_add_out"):
            put(p + "attn." + n, blk["attn"][n])
        put(p + "attn.to_out.0", blk["attn"]["to_out"])
        for n in ("norm_q", "norm_k", "norm_added_q", "norm_added_k"):
            sd[p + f"attn.{n}.weight"] = blk["attn"][n]["weight"]
        for ff in ("ff", "ff_context"):
            put(p + f"{ff}.net.0.proj", blk[ff]["in_proj"])
            put(p + f"{ff}.net.2", blk[ff]["out_proj"])
    for i in range(jspec.num_single):
        blk = jax.tree.map(lambda a: a[i], jp["single_blocks"])
        p = f"single_transformer_blocks.{i}."
        put(p + "norm.linear", blk["norm"]["linear"])
        for n in ("to_q", "to_k", "to_v"):
            put(p + "attn." + n, blk["attn"][n])
        for n in ("norm_q", "norm_k"):
            sd[p + f"attn.{n}.weight"] = blk["attn"][n]["weight"]
        put(p + "proj_mlp", blk["proj_mlp"])
        sd[p + "proj_out.weight"] = np.concatenate([blk["proj_out_attn"]["weight"], blk["proj_out_mlp"]["weight"]]).T
        sd[p + "proj_out.bias"] = blk["proj_out_attn"]["bias"]
    port = tflux.convert_flux_state_dict(sd, tspec)
    _cmp_tree(port, jflux.convert_flux_state_dict(sd, jspec), exact=True)
    _cmp_tree(port, jp, exact=True)
    carried = params_from_jax(jp, torch.float32, "cpu")
    args = _dit_inputs(TINY, seed=1)
    want = jflux.flux_forward(jp, *map(jnp.asarray, args), spec=jspec)
    for tree in (port, carried):
        got = tflux.flux_forward(tree, *map(torch.as_tensor, args), spec=tspec)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("steps, seq, dyn", [(4, 4096, True), (28, 1024, True), (2, 16, False), (50, 4096, True)])
def test_flow_match_sigmas_and_shift_match_jax(steps, seq, dyn):
    np.testing.assert_array_equal(trt.flow_match_sigmas(steps, seq, dyn), jrt.flow_match_sigmas(steps, seq, dyn))
    assert trt.calculate_shift(seq) == jrt.calculate_shift(seq)


def test_pack_and_unpack_round_trip_and_match_jax():
    lat = np.random.RandomState(0).randn(2, 8, 6, 4).astype(np.float32)
    packed = trt.pack_latents(torch.as_tensor(lat))
    assert packed.shape == (2, 12, 16)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jrt.pack_latents(jnp.asarray(lat))))
    np.testing.assert_array_equal(trt.unpack_latents(packed, 4, 3).numpy(), lat)
    seq = np.random.RandomState(1).randn(2, 12, 16).astype(np.float32)
    np.testing.assert_array_equal(trt.unpack_latents(torch.as_tensor(seq), 4, 3).numpy(),
                                  np.asarray(jrt.unpack_latents(jnp.asarray(seq), 4, 3)))
    np.testing.assert_array_equal(tflux.latent_image_ids(4, 3), jflux.latent_image_ids(4, 3))


# ---------------------------------------------------------------------------
# seeded weights and the whole pipeline
# ---------------------------------------------------------------------------


def _pipe_cfgs(**kw):
    common = dict(height=64, width=48, dtype="float32", **kw)
    jcfg = jrt.FluxPipelineConfig(backbone=jflux.FluxSpec(**TINY), clip=jtext.ClipTextSpec(**CLIP),
                                  t5=jtext.T5EncoderSpec(**T5), vae=jvae.VaeDecoderSpec(**VAE), **common)
    tcfg = trt.FluxPipelineConfig(backbone=tflux.FluxSpec(**TINY), clip=ttext.ClipTextSpec(**CLIP),
                                  t5=ttext.T5EncoderSpec(**T5), vae=tvae.VaeDecoderSpec(**VAE), device="cpu",
                                  **common)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def pipes():
    jcfg, tcfg = _pipe_cfgs()
    return trt.FluxPipeline(tcfg).load(random_weights=True, seed=2), jrt.TpuFluxPipeline(jcfg).load(
        random_weights=True, seed=2)


def test_random_weights_equal_jax_bit_for_bit(pipes):
    port, jpipe = pipes
    _cmp_tree(port.backbone_params, jpipe.backbone_params, exact=True)
    _cmp_tree(port.clip_app.params, jpipe.clip_app.params, exact=True)
    _cmp_tree(port.t5_app.params, jpipe.t5_app.params, exact=True)
    _cmp_tree(port.vae_app.params, vae_params_from_jax(_np_tree(jpipe.vae_app.params), torch.float32, "cpu"),
              exact=True)
    assert port.vae_app.params["conv_in"]["weight"].shape == (16, 4, 3, 3)  # OIHW


CLIP_IDS = np.array([[1, 5, 9, 2], [1, 7, 2, 0]])
T5_IDS = np.array([[4, 7, 11, 1, 0, 0], [4, 9, 1, 0, 0, 0]])
T5_MASK = np.array([[1, 1, 1, 1, 0, 0], [1, 1, 1, 0, 0, 0]])


def test_pipeline_matches_jax_with_the_same_noise(pipes, monkeypatch):
    """Both pipelines start from the port's seeded noise (JAX's normal
    draw replaced): text, three Euler steps on a 16 x 12 packed grid and the
    VAE, the images within VAE_ATOL."""
    port, jpipe = pipes
    drawn = {}

    def fake_normal(key, shape, dtype=jnp.float32):
        drawn["shape"] = shape
        return jnp.asarray(trt.initial_noise(shape, 11, "cpu").numpy())

    monkeypatch.setattr(jax.random, "normal", fake_normal)
    got = port.generate(CLIP_IDS, T5_IDS, T5_MASK, num_inference_steps=3, seed=11)
    want = jpipe.generate(CLIP_IDS, T5_IDS, T5_MASK, num_inference_steps=3, seed=11)
    assert drawn["shape"] == (2, 32, 24, 4) and got.shape == (2, 64, 48, 3)
    np.testing.assert_allclose(got, want, atol=VAE_ATOL, rtol=0)
    assert np.isfinite(got).all() and (got >= 0).all() and (got <= 1).all()


def test_pipeline_params_carried_from_jax(pipes):
    """``load(params=)`` with every sub-model's JAX tree carried across
    (the VAE through vae_params_from_jax) gives the random-weights image."""
    port, jpipe = pipes
    _, tcfg = _pipe_cfgs()
    params = {k: params_from_jax(_np_tree(getattr(jpipe, a)), torch.float32, "cpu")
              for k, a in (("backbone", "backbone_params"),)}
    params["clip"] = params_from_jax(_np_tree(jpipe.clip_app.params), torch.float32, "cpu")
    params["t5"] = params_from_jax(_np_tree(jpipe.t5_app.params), torch.float32, "cpu")
    params["vae"] = vae_params_from_jax(_np_tree(jpipe.vae_app.params), torch.float32, "cpu")
    carried = trt.FluxPipeline(tcfg).load(params=params)
    np.testing.assert_array_equal(carried.generate(CLIP_IDS, T5_IDS, num_inference_steps=2, seed=4),
                                  port.generate(CLIP_IDS, T5_IDS, num_inference_steps=2, seed=4))


def test_same_seed_same_image_another_seed_another(pipes):
    port, _ = pipes
    a = port.generate(CLIP_IDS[:1], T5_IDS[:1], num_inference_steps=2, seed=5)
    b = port.generate(CLIP_IDS[:1], T5_IDS[:1], num_inference_steps=2, seed=5)
    c = port.generate(CLIP_IDS[:1], T5_IDS[:1], num_inference_steps=2, seed=6)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)


@pytest.mark.parametrize("mesh", [2, ["cpu:0", "cpu:1", "cpu:2", "cpu:3"]])
def test_multi_device_mesh_is_refused_naming_a10(mesh):
    _, tcfg = _pipe_cfgs()
    with pytest.raises(NotImplementedError, match="ROADMAP A10"):
        trt.FluxPipeline(tcfg, mesh=mesh)
    assert trt.FluxPipeline(tcfg, mesh=1).device.type == "cpu"
