"""The port's EAGLE speculation (``runtime/fused_spec.EagleSpecModelForCausalLM``,
``modules/eagle.py``, ``models/eagle_draft.py``) against the JAX package's
on the CPU, fp32: one tiny head_dim-64 Llama target (2 layers; 4 for
EAGLE3, whose taps are layers (1, 1, 0)) and an EAGLE draft, both HF state
dicts made from a seed with numpy and loaded into both packages
(``tests/torch_eagle_common.py``). Mirrors the reference's
``tests/test_eagle3.py`` and the EAGLE cases of
``tests/test_speculation_family.py``.

- Greedy ``generate()``: the sequences and every round's accepted count
  equal the JAX app's, and the sequences equal the target's plain greedy
  ``generate()``, for the v1 chain (a correlated draft, so rounds accept),
  v1 with ``input_norm``, EAGLE3 and EAGLE3 with a reduced vocab and
  ``d2t`` (correlated: its proposals reach the target). Both caches and the
  hidden buffer after the run are within 5e-5 of the JAX app's (fp32,
  values up to ~4).
- The target's verify pass with ``return_hidden`` / ``capture_layers``
  (``models/base.model_logits``) and the EAGLE3 draft layer are within
  fp32 tolerance of JAX's on the same inputs (stated per test).
- ``params_from_jax`` carries both drafts' params (fc, input_norm,
  hidden_norm, the 2H-wide qkv, d2t) equal to the port's own conversion.
- Sampled: top_k 1 gives the greedy chain's tokens; draws reproduce by
  seed and differ across seeds.
- The refusals, with the reference's exception types.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from neuronx_distributed_inference_tpu_torch.analysis.retrace_guard import RetraceGuard
from neuronx_distributed_inference_tpu_torch.config import Config, FusedSpecConfig
from neuronx_distributed_inference_tpu_torch.models import get_model_builder
from neuronx_distributed_inference_tpu_torch.models.builder import params_from_jax
from neuronx_distributed_inference_tpu_torch.ops import _cuda
from neuronx_distributed_inference_tpu_torch.runtime.application import ModelForCausalLM
from neuronx_distributed_inference_tpu_torch.runtime.fused_spec import EagleSpecModelForCausalLM
from tests.torch_eagle_common import (
    MASK,
    PROMPTS,
    eagle_apps,
    eagle_draft_sd,
    jax_cfg,
    jax_rounds,
    port_cfg,
    port_rounds,
    target_sd,
)

#: fp32 state after a run (caches, hidden buffer), absolute
STATE_ATOL = 5e-5

CHAIN_CASES = {
    "eagle": dict(layers=2, draft=dict(correlated=True)),
    "eagle_input_norm": dict(layers=2, draft=dict(input_norm=True), app=dict(input_norm=True)),
    "eagle3": dict(layers=4, draft=dict(eagle3=True, correlated=True), app=dict(eagle3=True)),
    "eagle3_d2t": dict(
        layers=4, draft=dict(eagle3=True, correlated=True, draft_vocab=64), app=dict(eagle3=True, draft_vocab=64)
    ),
}


@pytest.fixture(scope="module")
def targets():
    torch.set_num_threads(1)
    return {layers: target_sd(0, layers) for layers in (2, 4)}


@pytest.fixture(scope="module")
def plain(targets):
    """The target's plain greedy generate() of 12 tokens, by depth."""
    return {
        layers: ModelForCausalLM(None, port_cfg(dict(num_hidden_layers=layers))).load(state_dict=sd)
        .generate(PROMPTS, MASK, max_new_tokens=12).sequences
        for layers, sd in targets.items()
    }


def assert_state_close(japp, app):
    """Both caches and the hidden buffer within STATE_ATOL of the JAX app's."""
    for name in ("draft_cache", "target_cache"):
        for stream in ("k", "v"):
            a = np.asarray(getattr(getattr(japp, name), stream))
            np.testing.assert_allclose(getattr(getattr(app, name), stream).numpy(), a, rtol=0, atol=STATE_ATOL)
    np.testing.assert_allclose(app.hidden_buffer.numpy(), np.asarray(japp.hidden_buffer), rtol=0, atol=STATE_ATOL)


def assert_same_run(japp, app, plain_seq, n=12):
    """Sequences and per-round counts equal to JAX's, sequences equal to
    plain generate()'s; returns the port's counts."""
    jout, jcounts = jax_rounds(japp, PROMPTS, MASK, max_new_tokens=n)
    _cuda.reset_launch_counts()
    out, counts = port_rounds(app, PROMPTS, MASK, max_new_tokens=n)
    assert set(_cuda.launch_counts().values()) == {0}  # CPU: plain versions only
    np.testing.assert_array_equal(out.sequences, np.asarray(jout.sequences))
    assert out.num_generated == jout.num_generated == n
    assert len(counts) == len(jcounts)
    for c, jc in zip(counts, jcounts):
        np.testing.assert_array_equal(c, jc)
    np.testing.assert_array_equal(out.sequences, plain_seq)
    return counts


@pytest.mark.parametrize("case", list(CHAIN_CASES))
def test_eagle_chain_greedy_matches_jax_and_plain_generate(case, targets, plain):
    c = CHAIN_CASES[case]
    tsd = targets[c["layers"]]
    japp, app = eagle_apps(tsd, eagle_draft_sd(1, tsd, **c["draft"]), layers=c["layers"], **c.get("app", {}))
    counts = assert_same_run(japp, app, plain[c["layers"]])
    if c["draft"].get("correlated") and case != "eagle3_d2t":
        assert max(int(x.max()) for x in counts) > 1  # some drafts accepted
    assert_state_close(japp, app)
    if case == "eagle3":
        assert app.hidden_buffer.shape == (3, 3 * 256)  # (B_kv + 1, 3H)


def test_eagle3_capture_layers():
    from neuronx_distributed_inference_tpu.modules.eagle import eagle3_capture_layers as jax_taps
    from neuronx_distributed_inference_tpu_torch.modules.eagle import eagle3_capture_layers

    assert eagle3_capture_layers(32) == (1, 15, 28)
    assert eagle3_capture_layers(4) == (1, 1, 0)  # clipped for tiny models
    for L in (1, 2, 4, 8, 32, 48):
        assert eagle3_capture_layers(L) == jax_taps(L)


def _verify_inputs(jnp, B=2, K=5, bucket=32, p=(9, 6)):
    """One verify pass's inputs for both packages: tokens, write slots
    p + j, rope positions p + j // 2 (tree-like) and a lower-triangular
    mask over the tail."""
    rng = np.random.RandomState(4)
    ids = rng.randint(0, 128, size=(B, K)).astype(np.int32)
    pos = (np.asarray(p)[:, None] + np.arange(K)[None, :]).astype(np.int32)
    rope = (np.asarray(p)[:, None] + np.arange(K)[None, :] // 2).astype(np.int32)
    cols = np.arange(bucket)[None, None, :]
    mask = (cols <= pos[:, :, None])[:, None]
    sp = np.ones((B, 3), np.float32)
    seq = np.arange(B, dtype=np.int32)
    valid = (np.arange(bucket)[None, :] <= pos[:, -1:]).astype(np.int32)
    j = dict(input_ids=jnp.asarray(ids), attention_mask=jnp.asarray(valid), position_ids=jnp.asarray(pos),
             seq_ids=jnp.asarray(seq), sampling_params=jnp.asarray(sp), rope_position_ids=jnp.asarray(rope),
             mask_override=jnp.asarray(mask))
    t = dict(input_ids=torch.from_numpy(ids), attention_mask=torch.from_numpy(valid),
             position_ids=torch.from_numpy(pos), seq_ids=torch.from_numpy(seq), sampling_params=torch.from_numpy(sp),
             rope_position_ids=torch.from_numpy(rope), mask_override=torch.from_numpy(mask))
    return j, t


def _caches(jnp, L, B=2, S=64, Hkv=2, D=64, seed=5):
    from neuronx_distributed_inference_tpu.modules.kvcache import KVCache as JaxKV
    from neuronx_distributed_inference_tpu_torch.modules.kvcache import KVCache

    rng = np.random.RandomState(seed)
    k = rng.randn(L, B + 1, S, Hkv, D).astype(np.float32)
    v = rng.randn(L, B + 1, S, Hkv, D).astype(np.float32)
    return JaxKV(k=jnp.asarray(k), v=jnp.asarray(v)), KVCache(k=torch.from_numpy(k.copy()), v=torch.from_numpy(v.copy()))


@pytest.mark.parametrize("capture", [False, True], ids=["return_hidden", "capture_layers"])
def test_model_logits_hidden_and_capture_match_jax(capture, targets):
    """The target's verify pass under rope_position_ids and mask_override,
    returning its hidden states (or the EAGLE3 capture concat): logits
    within 1e-4 and hidden within 1e-5 of JAX's (fp32, |hidden| ~4), the
    caches written at the write slots."""
    import jax.numpy as jnp
    from neuronx_distributed_inference_tpu.models import base as jbase
    from neuronx_distributed_inference_tpu.models.registry import get_model_builder as jax_builder
    from neuronx_distributed_inference_tpu_torch.models import base

    cfg_j, cfg_t = jax_cfg(dict(num_hidden_layers=4)), port_cfg(dict(num_hidden_layers=4))
    jb, tb = jax_builder("llama")(cfg_j), get_model_builder("llama")(cfg_t)
    jparams = jb.convert_hf_state_dict(targets[4])
    params = base.prepare_params(tb.convert_hf_state_dict(targets[4]))
    ji, ti = _verify_inputs(jnp)
    jc, tc = _caches(jnp, 4)
    taps = (1, 1, 0) if capture else None
    jl, jcache, jh = jbase.model_logits(
        jparams, jc, jbase.StepInputs(**ji), spec=jb.model_spec(), phase=jbase.PHASE_TOKEN_GENERATION,
        mlp_fn=jb.mlp_fn(), return_hidden=True, capture_layers=taps,
    )
    tl, tcache, th = base.model_logits(
        params, tc, base.StepInputs(**ti), spec=tb.model_spec(), phase=base.PHASE_TOKEN_GENERATION,
        mlp_fn=tb.mlp_fn(), return_hidden=True, capture_layers=taps,
    )
    assert th.shape == (2, 5, (3 if capture else 1) * 256)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-4)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tcache.k.numpy(), np.asarray(jcache.k), rtol=0, atol=1e-5)


@pytest.mark.parametrize("feature", ["capture", "chained"])
def test_eagle3_draft_layer_matches_jax(feature):
    """eagle3_draft_hidden on a 3H capture (through fc) and on a chained H
    feature, decode under a tree mask: hidden within 1e-5 of JAX's, the
    draft cache likewise (fp32)."""
    import jax.numpy as jnp
    from neuronx_distributed_inference_tpu.models import base as jbase
    from neuronx_distributed_inference_tpu.models.registry import get_model_builder as jax_builder
    from neuronx_distributed_inference_tpu.modules import eagle as jeagle
    from neuronx_distributed_inference_tpu_torch.models import base
    from neuronx_distributed_inference_tpu_torch.modules import eagle

    hf = dict(num_hidden_layers=1, model_type="llama-eagle3")
    jb, tb = jax_builder("llama-eagle3")(jax_cfg(hf)), get_model_builder("llama-eagle3")(port_cfg(hf))
    sd = eagle_draft_sd(2, eagle3=True)
    jparams, params = jb.convert_hf_state_dict(sd), base.prepare_params(tb.convert_hf_state_dict(sd))
    ji, ti = _verify_inputs(jnp)
    jc, tc = _caches(jnp, 1)
    width = 3 * 256 if feature == "capture" else 256
    prev = np.random.RandomState(6).randn(2, 5, width).astype(np.float32)
    jh, jcache = jeagle.eagle3_draft_hidden(
        jparams, ji["input_ids"], jnp.asarray(prev), jc, jbase.StepInputs(**ji), spec=jb.model_spec(),
        phase=jbase.PHASE_TOKEN_GENERATION, mlp_fn=jb.mlp_fn(),
    )
    th, tcache = eagle.eagle3_draft_hidden(
        params, ti["input_ids"], torch.from_numpy(prev), tc, base.StepInputs(**ti), spec=tb.model_spec(),
        phase=base.PHASE_TOKEN_GENERATION, mlp_fn=tb.mlp_fn(),
    )
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tcache.k.numpy(), np.asarray(jcache.k), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tcache.v.numpy(), np.asarray(jcache.v), rtol=0, atol=1e-5)


@pytest.mark.parametrize(
    "kind, hf, draft, tc",
    [
        ("llama-eagle", {}, dict(input_norm=True), dict(enable_eagle_draft_input_norm=True)),
        ("llama-eagle3", {}, dict(eagle3=True), {}),
        ("llama-eagle3", dict(draft_vocab_size=64), dict(eagle3=True, draft_vocab=64), {}),
    ],
    ids=["eagle_input_norm", "eagle3", "eagle3_d2t"],
)
def test_draft_params_from_jax_equal_the_ports_conversion(kind, hf, draft, tc):
    """The JAX draft builder's params through params_from_jax equal the
    port's own conversion of the same HF state dict, leaf for leaf (fc,
    input_norm, hidden_norm, the 2H-wide qkv, d2t as int32)."""
    from neuronx_distributed_inference_tpu.models.registry import get_model_builder as jax_builder

    attrs = dict(num_hidden_layers=1, model_type=kind, **hf)
    sd = eagle_draft_sd(3, **draft)
    jparams = jax.device_get(jax_builder(kind)(jax_cfg(attrs, **tc)).convert_hf_state_dict(sd))
    got = params_from_jax(jparams, torch.float32, "cpu")
    want = get_model_builder(kind)(port_cfg(attrs, **tc)).convert_hf_state_dict(sd)

    def flat(tree, path=()):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from flat(v, path + (k,))
        else:
            yield path, tree

    got, want = dict(flat(got)), dict(flat(want))
    assert got.keys() == want.keys()
    for path, w in want.items():
        assert got[path].dtype == w.dtype and got[path].shape == w.shape, path
        assert torch.equal(got[path], w), path
    assert want[("fc", "weight")].shape == ((3 if draft.get("eagle3") else 2) * 256, 256)
    if draft.get("eagle3"):
        assert want[("layers", "self_attn", "q_proj", "weight")].shape[1] == 512
        assert ("layers", "hidden_norm", "weight") in want
    else:
        assert ("input_norm", "weight") in want
    if "draft_vocab_size" in hf:
        assert want[("d2t", "table")].dtype == torch.int32 and want[("lm_head", "weight")].shape == (256, 64)


def test_eagle_draft_builder_shapes():
    """The reference's builder cases: fc (2H, H) and (3H, H); EAGLE3's qkv
    over 2H, hidden_norm (1, H), o back to H; a 2-layer EAGLE3 draft raises
    ValueError; a reduced vocab gives d2t and a (H, 64) lm head, and a
    checkpoint without d2t raises KeyError."""
    H = 256
    b = get_model_builder("llama-eagle")(port_cfg(dict(model_type="llama-eagle")))
    assert b.random_params()["fc"]["weight"].shape == (2 * H, H)
    cfg = port_cfg(dict(model_type="llama-eagle3", num_hidden_layers=1))
    p3 = get_model_builder("llama-eagle3")(cfg).random_params()
    assert p3["fc"]["weight"].shape == (3 * H, H)
    assert p3["layers"]["self_attn"]["q_proj"]["weight"].shape[1] == 2 * H
    assert p3["layers"]["hidden_norm"]["weight"].shape == (1, H)
    assert p3["layers"]["self_attn"]["o_proj"]["weight"].shape[2] == H
    with pytest.raises(ValueError):
        get_model_builder("llama-eagle3")(port_cfg(dict(model_type="llama-eagle3", num_hidden_layers=2)))
    cfg.draft_vocab_size = 64
    b3 = get_model_builder("llama-eagle3")(cfg)
    p = b3.random_params()
    assert p["d2t"]["table"].shape == (64,) and p["lm_head"]["weight"].shape[1] == 64
    assert b3.model_spec().vocab_size == 64
    sd = eagle_draft_sd(0, eagle3=True)
    with pytest.raises(KeyError):
        b3.convert_hf_state_dict(sd)


def test_sampled_chain_topk1_equals_greedy_and_reproduces(targets, plain):
    """do_sample with top_k 1 collapses every distribution to its argmax:
    the greedy chain's tokens. With temperature 4 and top_k 50 the tokens
    are in the vocab, equal for equal seeds and differ across seeds."""
    tsd = targets[2]
    dsd = eagle_draft_sd(1, tsd, correlated=True)
    _, app = eagle_apps(tsd, dsd, sample=1, jax=False)
    out = app.generate(PROMPTS, MASK, max_new_tokens=12, top_k=1).sequences
    np.testing.assert_array_equal(out, plain[2])

    def run(seed):
        _, a = eagle_apps(tsd, dsd, sample=50, seed=seed, jax=False)
        return a.generate(PROMPTS, MASK, max_new_tokens=10, temperature=4.0, top_k=50).sequences

    a, b, a2 = run(0), run(123), run(0)
    assert (a >= 0).all() and (a < 128).all()
    np.testing.assert_array_equal(a, a2)
    assert a.tolist() != b.tolist()


def test_app_seals_and_replays(targets):
    """A generate() of the warmed shapes builds nothing after seal()."""
    tsd = targets[2]
    _, app = eagle_apps(tsd, eagle_draft_sd(1, tsd, correlated=True), jax=False)
    first = app.generate(PROMPTS, MASK, max_new_tokens=12).sequences
    app.seal()
    with RetraceGuard() as guard:
        again = app.generate(PROMPTS, MASK, max_new_tokens=12).sequences
    assert guard.traces == [] and (again == first).all()


@pytest.mark.parametrize(
    "kw, exc, match",
    [
        (dict(enable_eagle_speculation=True, speculation_length=4), ValueError, "requires fused speculation"),
        (dict(is_eagle3=True), ValueError, "is_eagle3 requires"),
        (dict(token_tree_config={0: [1]}), ValueError, "requires enable_eagle_speculation"),
        (dict(medusa_speculation_length=3), ValueError, "num_medusa_heads > 0"),
        (dict(is_eagle_target=True), NotImplementedError, "per-submodel role flags"),
        (dict(is_eagle_draft=True), NotImplementedError, "per-submodel role flags"),
    ],
)
def test_config_cross_checks_raise_as_the_reference(kw, exc, match):
    """The reference's cross-checks (config.py:797-808) and its refusal of
    the role flags (UNIMPLEMENTED_FLAGS), with its exception types; the
    JAX package raises the same type for each."""
    from neuronx_distributed_inference_tpu.config import TpuConfig

    with pytest.raises(exc, match=match):
        Config(device="cpu", **kw)
    with pytest.raises(exc):
        TpuConfig(**kw)


def test_eagle_app_refusals(targets, monkeypatch):
    """Without enable_eagle_speculation the app raises ValueError; a tree
    over a windowed target raises NotImplementedError (the ancestry mask
    would widen its windows)."""
    cfg = port_cfg(speculation_length=4, enable_fused_speculation=True)
    cfg.fused_spec_config = FusedSpecConfig(draft_config=port_cfg(dict(model_type="llama-eagle", num_hidden_layers=1)))
    with pytest.raises(ValueError, match="enable_eagle_speculation"):
        EagleSpecModelForCausalLM(None, cfg)

    from neuronx_distributed_inference_tpu_torch.models.base import ModelSpec
    from neuronx_distributed_inference_tpu_torch.models.llama import LlamaModelBuilder

    @dataclasses.dataclass(frozen=True)
    class WindowedSpec(ModelSpec):
        sliding_window: int = 4

    plain_spec = LlamaModelBuilder.model_spec
    def windowed(self):
        spec = plain_spec(self)
        # every field but the window, whose None would override the default
        return WindowedSpec(**{f.name: getattr(spec, f.name) for f in dataclasses.fields(spec) if f.name != "sliding_window"})

    monkeypatch.setattr(LlamaModelBuilder, "model_spec", windowed)
    cfg.torch_config.enable_eagle_speculation = True
    cfg.torch_config.token_tree_config = {0: [1, 2]}
    with pytest.raises(NotImplementedError, match="plain-attention target"):
        EagleSpecModelForCausalLM(None, cfg)
