"""Multi-adapter LoRA serving in the port, held against the JAX package on
the CPU (fp32 unless named; a tiny head_dim-64 Llama loaded into both from
one HF state dict) and against PEFT's own forward.

- The reference's nine LoRA tests (``tests/test_lora.py``) mirrored on the
  port, each also comparing the port with JAX: greedy tokens identical,
  logits within 1e-5; the dynamic cache's ``slot_of``, LRU order and
  ``swaps`` equal JAX's after every call.
- A tiny ``transformers`` Llama wrapped by ``peft`` with two adapters
  (r 4 and r 8 with rsLoRA, ``lora_B`` drawn from a seed), written with
  ``save_pretrained`` and loaded by path in both packages: a batch of
  rows with different adapters and the base model matches PEFT's forward
  with each adapter set, and with adapters disabled.
- bf16; a windowed prefill; Qwen2, Qwen3 (qk-norm after the delta),
  Mistral and Mixtral (attention adapters) and int8 base weights; int4
  base weights as the reference decides (it fails to attach: the port
  refuses by name).
- Graphs and swaps: ``load_lora_adapters`` drops every graph captured
  before it (a stale replay fails the test) and refuses a sealed app; a
  dynamic swap writes the slots in place (every leaf keeps its
  ``data_ptr()``) with the reference's bytes.
- The refusals with their words; the reference's silent skip of MLP
  targets pinned; a ``ServingSession`` on a LoRA app serves the base model
  as JAX's does; ``params_from_jax`` carries a LoRA-attached tree.
"""

import json
import math

import jax
import numpy as np
import pytest
import torch

from neuronx_distributed_inference_tpu.config import LoraServingConfig as JaxLoraConfig
from neuronx_distributed_inference_tpu.config import MoETpuConfig, TpuConfig
from neuronx_distributed_inference_tpu.models.llama import LlamaInferenceConfig as JaxLlamaConfig
from neuronx_distributed_inference_tpu.modules import lora as jax_lora
from neuronx_distributed_inference_tpu.runtime.application import TpuModelForCausalLM
from neuronx_distributed_inference_tpu.runtime.serving import ServingSession as JaxSession
from neuronx_distributed_inference_tpu_torch.config import Config, InferenceConfig, LoraServingConfig, MoEConfig
from neuronx_distributed_inference_tpu_torch.models.builder import params_from_jax
from neuronx_distributed_inference_tpu_torch.models.llama import LlamaInferenceConfig
from neuronx_distributed_inference_tpu_torch.modules import lora
from neuronx_distributed_inference_tpu_torch.runtime.application import ModelForCausalLM
from neuronx_distributed_inference_tpu_torch.runtime.serving import ServingSession
from tests.conftest import make_random_hf_state_dict

HF = dict(
    model_type="llama", hidden_size=256, intermediate_size=512, num_attention_heads=4,
    num_key_value_heads=2, num_hidden_layers=2, vocab_size=128, rms_norm_eps=1e-5,
    rope_theta=10000.0, max_position_embeddings=512, hidden_act="silu", tie_word_embeddings=False,
)
GEN = dict(batch_size=2, seq_len=64, dtype="float32", output_logits=True)
PROMPT = np.array([[5, 17, 92, 41, 33, 88, 2, 11], [64, 3, 27, 9, 14, 33, 1, 2]])
MASK = np.ones_like(PROMPT)
ATOL = 1e-5
#: bf16 logits of the two packages, each rounding its own bf16 products:
#: about 2x the largest gap measured on test_bf16_matches_jax's inputs
#: (0.0293 with adapters, 0.0254 with none; |logit| up to 2.77, whose bf16
#: ulp is 0.0156)
BF16_ATOL = 6e-2
ALL_ATTN = ("q_proj", "k_proj", "v_proj", "o_proj")


@pytest.fixture(scope="module", autouse=True)
def _threads():
    torch.set_num_threads(1)


def _load(c, attrs=HF):
    for k, v in attrs.items():
        setattr(c, k, v)


def _jax_cfg(**kw):
    return JaxLlamaConfig(TpuConfig(**{**GEN, **kw}), load_config=_load)


def _lora_kw(jax_side=False, **kw):
    return dict(lora_config=(JaxLoraConfig if jax_side else LoraServingConfig)(**kw))


def _apps(sd, lora_cfg=None, **kw):
    """(JAX app, port app) of the tiny Llama, loaded from ``sd``."""
    jkw = dict(kw, **_lora_kw(True, **lora_cfg)) if lora_cfg else kw
    pkw = dict(kw, **_lora_kw(**lora_cfg)) if lora_cfg else kw
    jax_app = TpuModelForCausalLM(None, _jax_cfg(**jkw)).load(state_dict=sd)
    port = ModelForCausalLM(None, LlamaInferenceConfig(Config(**{**GEN, **pkw}, device="cpu"), load_config=_load))
    return jax_app, port.load(state_dict=sd)


@pytest.fixture(scope="module")
def sd():
    return make_random_hf_state_dict(_jax_cfg())


def _adapter(r, seed, modules=("q_proj", "v_proj"), scale=1.0, layers=2, hidden=256, out=None, alpha=True):
    """A random PEFT-format adapter (the reference test's _make_adapter on
    any modules): ``lora_alpha`` rides in the dict unless ``alpha`` is
    False."""
    rng = np.random.RandomState(seed)
    out = out or dict(q_proj=256, k_proj=128, v_proj=128, o_proj=256)
    sd = {"lora_alpha": r * scale} if alpha else {}
    for i in range(layers):
        for mod in modules:
            fan_in = 256 if mod == "o_proj" else hidden
            p = f"base_model.model.model.layers.{i}.self_attn.{mod}."
            sd[p + "lora_A.weight"] = (rng.randn(r, fan_in) * 0.1).astype(np.float32)
            sd[p + "lora_B.weight"] = (rng.randn(out[mod], r) * 0.1).astype(np.float32)
    return sd


def _same(port_out, jax_out, atol=ATOL):
    np.testing.assert_array_equal(port_out.sequences, np.asarray(jax_out.sequences))
    np.testing.assert_allclose(port_out.logits, np.asarray(jax_out.logits), atol=atol, rtol=0)


def _both(apps, n_new, names, ids=PROMPT, mask=MASK):
    jax_app, port = apps
    return (
        port.generate(ids, mask, max_new_tokens=n_new, lora_adapter_names=names),
        jax_app.generate(ids, mask, max_new_tokens=n_new, lora_adapter_names=names),
    )


# ---------------------------------------------------------------------------
# the reference's nine tests, mirrored
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def lora_apps(sd):
    """The reference fixture's app in both packages: max_loras 2, rank 8,
    adapter_a (r 4) and adapter_b (r 8) on q / v."""
    apps = _apps(sd, dict(max_loras=2, max_lora_rank=8))
    adapters = {"adapter_a": _adapter(4, 1), "adapter_b": _adapter(8, 2)}
    for app in apps:
        app.load_lora_adapters(adapters)
    return apps


def test_base_adapter_matches_no_lora(sd, lora_apps):
    """Adapter id 0 reproduces the base model: the port's LoRA app with
    [None, None] equals the port without LoRA and JAX's LoRA app."""
    base = ModelForCausalLM(None, LlamaInferenceConfig(Config(**GEN, device="cpu"), load_config=_load))
    ref = base.load(state_dict=sd).generate(PROMPT, MASK, max_new_tokens=5)
    out, jax_out = _both(lora_apps, 5, [None, None])
    np.testing.assert_allclose(out.logits, ref.logits, atol=ATOL, rtol=ATOL)
    _same(out, jax_out)


def test_adapters_change_outputs_per_row(lora_apps):
    """Different adapters per row give different, row-isolated outputs, as
    JAX's do."""
    base, jax_base = _both(lora_apps, 4, [None, None])
    mixed, jax_mixed = _both(lora_apps, 4, ["adapter_a", None])
    assert not np.allclose(mixed.logits[0], base.logits[0], atol=1e-4)
    np.testing.assert_allclose(mixed.logits[1], base.logits[1], atol=ATOL, rtol=ATOL)
    a_only, jax_a_only = _both(lora_apps, 4, ["adapter_a", "adapter_b"])
    np.testing.assert_allclose(a_only.logits[0], mixed.logits[0], atol=ATOL, rtol=ATOL)
    assert not np.allclose(a_only.logits[1], base.logits[1], atol=1e-4)
    for got, want in ((base, jax_base), (mixed, jax_mixed), (a_only, jax_a_only)):
        _same(got, want)


def test_eos_generate_with_adapters_matches_jax(lora_apps):
    """generate() with an EOS: chunks of 8 decode steps fetched one at a
    time carry the adapter ids too; rows that end pad with the EOS, as in
    JAX."""
    free, _ = _both(lora_apps, 12, ["adapter_b", "adapter_a"])
    eos = int(free.sequences[0, PROMPT.shape[1] + 3])
    jax_app, port = lora_apps
    kw = dict(max_new_tokens=12, eos_token_id=eos, lora_adapter_names=["adapter_b", "adapter_a"])
    _same(port.generate(PROMPT, MASK, **kw), jax_app.generate(PROMPT, MASK, **kw))


def test_unknown_adapter_rejected(lora_apps):
    for app in lora_apps:
        with pytest.raises(KeyError):
            app.generate(PROMPT, MASK, max_new_tokens=2, lora_adapter_names=["nope", None])


def test_alpha_resolution_sources(tmp_path):
    """lora_alpha comes from adapter_config.json or an explicit config, as
    in JAX, for every form; a PEFT directory by safetensors and by
    ``adapter_model.bin``."""
    from safetensors.numpy import save_file

    sd = {"w": np.zeros((2, 2), np.float32)}
    forms = [
        (sd, {"lora_alpha": 16}),
        {"state_dict": sd, "config": {"lora_alpha": 8, "use_rslora": True}},
        sd,
    ]
    want = [(16, False), (8, True), (None, False)]
    for form, (alpha, rs) in zip(forms, want):
        got = lora._normalize_adapter("a", form)
        assert got[1:] == (alpha, rs) == jax_lora._normalize_adapter("a", form)[1:]
    st = tmp_path / "peft_adapter"
    st.mkdir()
    (st / "adapter_config.json").write_text('{"lora_alpha": 32, "r": 8}')
    save_file(sd, str(st / "adapter_model.safetensors"))
    binp = tmp_path / "bin_adapter"
    binp.mkdir()
    (binp / "adapter_config.json").write_text('{"lora_alpha": 4, "use_rslora": true}')
    torch.save({"w": torch.ones(2, 2)}, str(binp / "adapter_model.bin"))
    for d, (alpha, rs) in ((st, (32, False)), (binp, (4, True))):
        got_sd, got_alpha, got_rs = lora._normalize_adapter("a", str(d))
        jax_sd, jax_alpha, jax_rs = jax_lora._normalize_adapter("a", str(d))
        assert (got_alpha, got_rs) == (jax_alpha, jax_rs) == (alpha, rs)
        np.testing.assert_array_equal(got_sd["w"], jax_sd["w"])
    with pytest.raises(FileNotFoundError):
        lora.load_peft_adapter(str(tmp_path))


def test_rslora_scaling():
    """use_rslora scales by alpha / sqrt(r) instead of alpha / r: the port's
    per-layer entries hold JAX's layer-stacked leaves layer by layer."""
    L, H = 2, 256
    sd = _adapter(4, 3, modules=("q_proj",), alpha=False)
    value = (sd, {"lora_alpha": 8, "use_rslora": True})
    port_params = {"layers": [{"self_attn": {"q_proj": {"weight": torch.zeros(H, H)}, "k_proj": {}}, "mlp": {}}
                              for _ in range(L)]}
    lora.attach_lora_params(port_params, {"a": value}, lora.LoraWeightManager(LoraServingConfig(max_lora_rank=8)), L)
    jax_params = {"layers": {"self_attn": {"q_proj": {"weight": jax.numpy.zeros((L, H, H))}, "k_proj": {}},
                             "mlp": {}}}
    jax_lora.attach_lora_params(jax_params, {"a": value}, jax_lora.LoraWeightManager(JaxLoraConfig(max_lora_rank=8)), L)
    want = jax_params["layers"]["self_attn"]["q_proj"]
    for li, lp in enumerate(port_params["layers"]):
        got = lp["self_attn"]["q_proj"]
        np.testing.assert_allclose(got["lora_scaling"][1].numpy(), 8 / math.sqrt(4), rtol=1e-6)
        for leaf in ("lora_A", "lora_B", "lora_scaling"):
            np.testing.assert_array_equal(got[leaf].numpy(), np.asarray(want[leaf][li]), err_msg=leaf)


def test_max_loras_enforced():
    for mod, cfg in ((lora, LoraServingConfig), (jax_lora, JaxLoraConfig)):
        mgr = mod.LoraWeightManager(cfg(max_loras=1))
        mgr.register("a")
        with pytest.raises(RuntimeError, match="max_loras=1 exceeded"):
            mgr.register("b")


def _dynamic_apps(sd, max_loras=2, max_cpu=4):
    apps = _apps(sd, dict(max_loras=max_loras, max_lora_rank=8, max_loras_on_cpu=max_cpu))
    for app in apps:
        app.load_lora_adapters(dynamic=True)
    return apps


def _same_cache(port_mgr, jax_mgr):
    assert port_mgr.slot_of == jax_mgr.slot_of
    assert port_mgr.lru == jax_mgr.lru
    assert port_mgr.swaps == jax_mgr.swaps
    assert list(port_mgr.cpu_cache) == list(jax_mgr.cpu_cache)


def test_dynamic_lora_swap_matches_static(sd):
    """Adapters served through the dynamic cache (2 slots, 3 adapters) give
    exactly a static app's logits, in both packages; the cache's state
    equals JAX's after every call."""
    dyn = _dynamic_apps(sd, max_loras=2)
    adapters = {f"a{i}": _adapter(4, 10 + i) for i in range(3)}
    for app in dyn:
        for name, a in adapters.items():
            app.register_lora_adapter(name, a)
    static = {}
    for name in ("a0", "a1", "a2"):
        static[name] = _apps(sd, dict(max_loras=1, max_lora_rank=8))[1].load_lora_adapters({name: adapters[name]})
    for name in ("a0", "a1", "a2", "a0", "a2"):
        out, jax_out = _both(dyn, 4, [name, name])
        _same(out, jax_out)
        ref = static[name].generate(PROMPT, MASK, max_new_tokens=4, lora_adapter_names=[name, name])
        np.testing.assert_allclose(out.logits, ref.logits, atol=ATOL, rtol=ATOL)
        _same_cache(dyn[1].lora_manager, dyn[0].lora_manager)
    assert dyn[1].lora_manager.swaps == 4


def test_dynamic_lora_eviction_policy(sd):
    dyn = _dynamic_apps(sd, max_loras=2)
    for app in dyn:
        for i in range(3):
            app.register_lora_adapter(f"a{i}", _adapter(4, 20 + i))
    _same(*_both(dyn, 2, ["a0", "a1"]))
    _same_cache(dyn[1].lora_manager, dyn[0].lora_manager)
    assert set(dyn[1].lora_manager.slot_of) == {"a0", "a1"}
    _same(*_both(dyn, 2, ["a2", "a1"]))  # a2 misses: evicts the LRU a0
    _same_cache(dyn[1].lora_manager, dyn[0].lora_manager)
    assert set(dyn[1].lora_manager.slot_of) == {"a1", "a2"}
    one_slot = _dynamic_apps(sd, max_loras=1)
    for app in one_slot:
        for i in range(2):
            app.register_lora_adapter(f"b{i}", _adapter(4, 30 + i))
        with pytest.raises(RuntimeError, match="batch needs 2 distinct adapters > max_loras=1"):
            app.generate(PROMPT, MASK, max_new_tokens=2, lora_adapter_names=["b0", "b1"])


def test_dynamic_lora_unknown_adapter(sd):
    for app in _dynamic_apps(sd):
        with pytest.raises(KeyError, match="unknown LoRA adapter 'nope'"):
            app.generate(PROMPT, MASK, max_new_tokens=2, lora_adapter_names=["nope", None])


def test_host_cache_bound_matches_jax(sd):
    """register_cpu keeps max_loras_on_cpu adapters beyond the resident
    ones and the newcomer, evicting the oldest, as JAX's does."""
    dyn = _dynamic_apps(sd, max_loras=1, max_cpu=1)
    for app in dyn:
        app.register_lora_adapter("a0", _adapter(4, 40))
        app.generate(PROMPT, MASK, max_new_tokens=2, lora_adapter_names=["a0", None])
        for i in (1, 2, 3):
            app.register_lora_adapter(f"a{i}", _adapter(4, 40 + i))
    _same_cache(dyn[1].lora_manager, dyn[0].lora_manager)
    assert list(dyn[1].lora_manager.cpu_cache) == ["a0", "a2", "a3"]


def test_card_schedule_swaps_match_jax():
    """The card's dynamic drain (chip_smoke.lora_schedule) holds its swaps
    and slot tables to chip_smoke.lora_schedule_swaps, the port manager's
    logic run without device writes: after every call they equal JAX's
    manager's on the same schedule, and the schedule evicts."""
    import chip_smoke

    schedule = chip_smoke.lora_schedule()
    want = chip_smoke.lora_schedule_swaps(schedule, chip_smoke.LORA_DYN_SLOTS)
    jm = jax_lora.DynamicLoraManager(JaxLoraConfig(max_loras=chip_smoke.LORA_DYN_SLOTS))
    jm.cpu_cache.update({n: {} for n in chip_smoke.lora_names()})
    jm._write_slot = lambda params, slot, arrays: params
    for names, (swaps, table) in zip(schedule, want):
        assert len({n for n in names if n is not None}) <= chip_smoke.LORA_DYN_SLOTS
        jm.ensure_on_device(None, names)
        assert (jm.swaps, jm.slot_of) == (swaps, table)
    assert len(schedule) == chip_smoke.LORA_DYN_CALLS and want[-1][0] > 2 * chip_smoke.LORA_DYN_SLOTS


# ---------------------------------------------------------------------------
# PEFT's own forward, from a save_pretrained directory
# ---------------------------------------------------------------------------


def _peft_model(tmp_path):
    """A tiny transformers Llama with two PEFT adapters, written by
    save_pretrained: "default" (r 4) at the root, "rs" (r 8, rsLoRA) in
    its subdirectory. lora_B (zero at PEFT's init) is drawn from a seed."""
    peft = pytest.importorskip("peft")
    import transformers

    torch.manual_seed(0)
    hf_cfg = transformers.LlamaConfig(
        vocab_size=128, hidden_size=256, intermediate_size=512, num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=2, max_position_embeddings=512, rms_norm_eps=1e-5, rope_theta=10000.0,
        tie_word_embeddings=False, attn_implementation="eager",
    )
    base = transformers.LlamaForCausalLM(hf_cfg).eval().float()
    sd = {k: v.detach().clone().numpy() for k, v in base.state_dict().items()}
    model = peft.get_peft_model(base, peft.LoraConfig(r=4, lora_alpha=8, target_modules=list(ALL_ATTN)))
    model.add_adapter("rs", peft.LoraConfig(r=8, lora_alpha=16, use_rslora=True, target_modules=list(ALL_ATTN)))
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "lora_" in name:
                p.copy_(torch.randn(p.shape, generator=gen) * 0.2)
    model.save_pretrained(str(tmp_path))
    return model.eval(), sd, {"default": str(tmp_path), "rs": str(tmp_path / "rs")}


def _peft_logits(model, seq, adapter):
    with torch.no_grad():
        if adapter is None:
            with model.disable_adapter():
                return model(torch.tensor(seq[None])).logits[0].numpy()
        model.set_adapter(adapter)
        return model(torch.tensor(seq[None])).logits[0].numpy()


def test_peft_directories_match_peft_forward(tmp_path):
    """Rows with adapter "default", adapter "rs" and the base model, each
    loaded from its PEFT directory by path in both packages: every generated
    token and logit matches PEFT's forward over the generated sequence (fp32,
    1e-4), and the port matches JAX (1e-5)."""
    model, sd, dirs = _peft_model(tmp_path)
    cfg = dict(max_loras=2, max_lora_rank=8)
    apps = _apps(sd, cfg, batch_size=3)
    for app in apps:
        app.load_lora_adapters(dirs)
    prompt = np.array([[5, 17, 92, 41, 33, 88, 2, 11]] * 3)
    names = ["default", "rs", None]
    out, jax_out = _both(apps, 6, names, prompt, np.ones_like(prompt))
    _same(out, jax_out)
    n = prompt.shape[1]
    for row, name in enumerate(names):
        ref = _peft_logits(model, out.sequences[row], name)
        np.testing.assert_allclose(out.logits[row], ref[n - 1 : -1], atol=1e-4, rtol=0, err_msg=str(name))
        np.testing.assert_array_equal(out.sequences[row, n:], ref[n - 1 : -1].argmax(-1))
    assert not np.allclose(out.logits[0], out.logits[2], atol=1e-3)
    assert not np.allclose(out.logits[1], out.logits[2], atol=1e-3)


def test_peft_directory_on_the_dynamic_cache(tmp_path):
    """The same directories registered with the dynamic cache (one slot):
    each adapter swapped in matches PEFT's forward."""
    model, sd, dirs = _peft_model(tmp_path)
    port = _apps(sd, dict(max_loras=1, max_lora_rank=8, max_loras_on_cpu=2), batch_size=1)[1]
    port.load_lora_adapters(dirs, dynamic=True)
    prompt = np.array([[64, 3, 27, 9, 14, 33, 1, 2]])
    for name in ("rs", "default", "rs"):
        out = port.generate(prompt, max_new_tokens=5, lora_adapter_names=[name])
        ref = _peft_logits(model, out.sequences[0], name)
        np.testing.assert_allclose(out.logits[0], ref[7:-1], atol=1e-4, rtol=0, err_msg=name)
    assert port.lora_manager.swaps == 3


# ---------------------------------------------------------------------------
# bf16, windows, families, weights
# ---------------------------------------------------------------------------


def _all_attn_apps(sd, **kw):
    apps = _apps(sd, dict(max_loras=2, max_lora_rank=16), **kw)
    adapters = {"a": _adapter(8, 50, ALL_ATTN), "b": (_adapter(16, 51, ALL_ATTN, alpha=False), {"lora_alpha": 8,
                                                                                                 "use_rslora": True})}
    for app in apps:
        app.load_lora_adapters(adapters)
    return apps


def test_bf16_matches_jax(sd):
    """bf16 weights and adapters: tokens equal to JAX's bf16 app's, logits
    within BF16_ATOL."""
    out, jax_out = _both(_all_attn_apps(sd, dtype="bfloat16"), 6, ["a", "b"])
    np.testing.assert_array_equal(out.sequences, np.asarray(jax_out.sequences))
    np.testing.assert_allclose(out.logits, np.asarray(jax_out.logits, np.float32), atol=BF16_ATOL, rtol=0)


def test_windowed_prefill_with_adapters(sd):
    """A 40-token prompt over 16-token context programs: window 0 and the
    later windows carry the adapter ids, as JAX's windowed prefill does."""
    kw = dict(seq_len=64, max_context_length=16, context_encoding_buckets=[16], token_generation_buckets=[32, 64])
    apps = _all_attn_apps(sd, **kw)
    ids = np.random.RandomState(3).randint(1, 128, size=(2, 40))
    mask = np.ones_like(ids)
    mask[1, 30:] = 0
    out, jax_out = _both(apps, 8, ["a", "b"], ids, mask)
    _same(out, jax_out)
    plain, _ = _both(apps, 8, [None, None], ids, mask)
    assert not np.allclose(out.logits, plain.logits, atol=1e-3)


def _family(name):
    """(attrs, state dict) of a tiny transformers model of ``name``, head_dim 64."""
    import transformers

    common = dict(vocab_size=128, hidden_size=256, num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                  rms_norm_eps=1e-5, max_position_embeddings=256, tie_word_embeddings=False,
                  attn_implementation="eager", intermediate_size=256)
    cls, model_cls, extra = {
        "qwen2": (transformers.Qwen2Config, transformers.Qwen2ForCausalLM, {}),
        "qwen3": (transformers.Qwen3Config, transformers.Qwen3ForCausalLM, dict(head_dim=64)),
        "mistral": (transformers.MistralConfig, transformers.MistralForCausalLM, dict(sliding_window=None)),
        "mixtral": (transformers.MixtralConfig, transformers.MixtralForCausalLM,
                    dict(intermediate_size=96, num_local_experts=4, num_experts_per_tok=2)),
    }[name]
    torch.manual_seed(5)
    hf_cfg = cls(**{**common, **extra})
    hf = model_cls(hf_cfg).eval().float()
    attrs = dict(model_type=name, hidden_act="silu", rope_theta=getattr(hf_cfg, "rope_theta", 10000.0))
    for k in ("hidden_size", "intermediate_size", "num_hidden_layers", "num_attention_heads", "num_key_value_heads",
              "vocab_size", "rms_norm_eps", "tie_word_embeddings", "num_local_experts", "num_experts_per_tok",
              "head_dim", "sliding_window"):
        if hasattr(hf_cfg, k):
            attrs[k] = getattr(hf_cfg, k)
    return attrs, {k: v.detach().numpy() for k, v in hf.state_dict().items()}


@pytest.mark.parametrize("name", ["qwen2", "qwen3", "mistral", "mixtral"])
def test_families_match_jax(name):
    """Attention adapters on q/k/v/o of Qwen2 (after the delta, the biases),
    Qwen3 (the qk-norm after the delta), Mistral and Mixtral (the MoE
    unchanged): tokens and logits equal to JAX's."""
    attrs, sd = _family(name)
    moe = name == "mixtral"
    jtc, ptc = (MoETpuConfig, MoEConfig) if moe else (TpuConfig, Config)
    jax_app = TpuModelForCausalLM(None, JaxLlamaConfig(
        jtc(**GEN, **_lora_kw(True, max_loras=2, max_lora_rank=16)), load_config=lambda c: _load(c, attrs)))
    port = ModelForCausalLM(None, InferenceConfig(
        ptc(**GEN, **_lora_kw(max_loras=2, max_lora_rank=16), device="cpu"), load_config=lambda c: _load(c, attrs)))
    apps = (jax_app.load(state_dict=sd), port.load(state_dict=sd))
    adapters = {"a": _adapter(8, 60, ALL_ATTN), "b": _adapter(16, 61, ALL_ATTN)}
    for app in apps:
        app.load_lora_adapters(adapters)
    out, jax_out = _both(apps, 6, ["b", "a"])
    _same(out, jax_out, atol=1e-4 if moe else ATOL)
    base, _ = _both(apps, 6, [None, None])
    assert not np.allclose(out.logits, base.logits, atol=1e-3)


def test_int8_base_weights_match_jax(sd):
    """int8 per-channel base weights: the adapters attach beside the codes
    and the delta adds to the quantized product, as in JAX."""
    out, jax_out = _both(_all_attn_apps(sd, quantized=True), 6, ["a", None])
    _same(out, jax_out)


def test_int4_base_weights_as_the_reference_decides(sd):
    """The reference stacks A with the packed int4 rows and fails to attach
    (a ValueError); the port refuses by name."""
    jax_app, port = _apps(sd, dict(max_loras=1, max_lora_rank=8), weight_dtype="int4")
    with pytest.raises(ValueError, match="could not broadcast"):
        jax_app.load_lora_adapters({"a": _adapter(4, 1)})
    with pytest.raises(NotImplementedError, match=r"ROADMAP C \(int4 base weights with LoRA\)"):
        port.load_lora_adapters({"a": _adapter(4, 1)})


# ---------------------------------------------------------------------------
# graphs and swaps
# ---------------------------------------------------------------------------


class _StaleGraph:
    """Stands in for a graph captured before the adapters were attached."""

    replays = 0
    binding = None

    def check_binding(self, binding, what):
        pass

    def replay(self):
        _StaleGraph.replays += 1


def test_load_lora_adapters_drops_graphs_and_refuses_a_sealed_app(sd):
    """A graph captured before load_lora_adapters replays the program
    without the adapter leaves: attaching drops every graph (the stand-ins
    planted at every key warmup() recorded are never replayed, and the LoRA
    rows still differ from the base rows), and a sealed app refuses."""
    port = _apps(sd, dict(max_loras=1, max_lora_rank=8))[1].warmup()
    planted = 0
    for runner in port._all_runners():
        for key in runner._prog.seen:
            runner._prog.captured[key] = _StaleGraph()
            planted += 1
    assert planted
    old = port.graphs
    port.load_lora_adapters({"a": _adapter(4, 1)})
    assert port.graphs is not old
    _StaleGraph.replays = 0
    out = port.generate(PROMPT, MASK, max_new_tokens=4, lora_adapter_names=["a", None])
    base = port.generate(PROMPT, MASK, max_new_tokens=4)
    assert _StaleGraph.replays == 0
    assert not np.allclose(out.logits[0], base.logits[0], atol=1e-4)
    np.testing.assert_allclose(out.logits[1], base.logits[1], atol=ATOL, rtol=0)
    for runner in port._all_runners():
        runner.seal()
    with pytest.raises(RuntimeError, match="sealed app"):
        port.load_lora_adapters({"a": _adapter(4, 1)})


def _leaves(params):
    return {
        (li, mod, leaf): e[leaf]
        for li, lp in enumerate(params["layers"])
        for mod, e in lp["self_attn"].items()
        for leaf in ("lora_A", "lora_B", "lora_scaling")
        if leaf in e
    }


def test_dynamic_swaps_write_in_place_with_the_references_bytes(sd):
    """Every adapter leaf keeps its data_ptr() across swaps and evictions,
    and after each call the slots hold JAX's bytes (bf16 rounding of the
    fp32 host stacks included)."""
    dyn = _apps(sd, dict(max_loras=2, max_lora_rank=16, max_loras_on_cpu=4), dtype="bfloat16")
    for app in dyn:
        app.load_lora_adapters(dynamic=True)
        for i in range(4):
            app.register_lora_adapter(f"a{i}", _adapter(4 * (i + 1), 70 + i, ALL_ATTN))
    ptrs = {k: t.data_ptr() for k, t in _leaves(dyn[1].params).items()}
    assert len(ptrs) == 2 * 4 * 3
    for names in (["a0", "a1"], ["a2", "a1"], ["a3", "a0"], ["a1", None]):
        _, jax_out = _both(dyn, 2, names)
        assert {k: t.data_ptr() for k, t in _leaves(dyn[1].params).items()} == ptrs
        jl = dyn[0].params["layers"]["self_attn"]
        for (li, mod, leaf), t in _leaves(dyn[1].params).items():
            want = np.asarray(jl[mod][leaf][li].astype(jax.numpy.float32))
            np.testing.assert_array_equal(t.float().numpy(), want, err_msg=f"{li} {mod} {leaf}")
    _same_cache(dyn[1].lora_manager, dyn[0].lora_manager)
    assert dyn[1].lora_manager.swaps == 6


# ---------------------------------------------------------------------------
# refusals, the reference's MLP skip, other paths, weights carried across
# ---------------------------------------------------------------------------


def test_fused_qkv_with_lora_refused_in_both_words():
    want = "fused_qkv with LoRA serving is not supported: adapters target q/k/v projections individually"
    with pytest.raises(NotImplementedError, match=want):
        Config(device="cpu", fused_qkv=True, lora_config=LoraServingConfig())
    with pytest.raises(NotImplementedError, match=want):
        TpuConfig(fused_qkv=True, lora_config=JaxLoraConfig())


@pytest.mark.parametrize("mods", [("gate_proj",), ("q_proj", "up_proj", "down_proj")])
def test_mlp_targets_refused_by_name(mods):
    with pytest.raises(NotImplementedError, match=r"ROADMAP C \(LoRA on MLP modules\)"):
        Config(device="cpu", lora_config={"target_modules": list(mods)})


def test_reference_skips_mlp_adapters_silently(sd):
    """Pins what the port refuses: the reference attaches MLP-only adapters
    (gate/up/down leaves appear) and serves the base model (no MLP calls
    apply_lora)."""
    jax_app = TpuModelForCausalLM(None, _jax_cfg(**_lora_kw(
        True, max_loras=1, max_lora_rank=8, target_modules=("gate_proj", "up_proj", "down_proj")))).load(state_dict=sd)
    base = TpuModelForCausalLM(None, _jax_cfg()).load(state_dict=sd).generate(PROMPT, MASK, max_new_tokens=4)
    rng = np.random.RandomState(9)
    mlp = {}
    for i in range(2):
        for mod, (d_in, d_out) in dict(gate_proj=(256, 512), up_proj=(256, 512), down_proj=(512, 256)).items():
            p = f"base_model.model.model.layers.{i}.mlp.{mod}."
            mlp[p + "lora_A.weight"] = rng.randn(4, d_in).astype(np.float32)
            mlp[p + "lora_B.weight"] = rng.randn(d_out, 4).astype(np.float32)
    jax_app.load_lora_adapters({"m": (mlp, {"lora_alpha": 4})})
    assert "lora_A" in jax_app.params["layers"]["mlp"]["gate_proj"]
    out = jax_app.generate(PROMPT, MASK, max_new_tokens=4, lora_adapter_names=["m", "m"])
    np.testing.assert_array_equal(np.asarray(out.sequences), np.asarray(base.sequences))
    np.testing.assert_allclose(np.asarray(out.logits), np.asarray(base.logits), atol=ATOL, rtol=0)


@pytest.mark.parametrize("family", ["llama4", "deepseek_v3"])
def test_list_layer_families_refuse_lora_in_both(family):
    """Llama4 and DeepSeek-V3 keep their layers as a list of group stacks,
    which the reference's attach cannot index: both packages refuse."""
    if family == "llama4":
        from tests import test_torch_llama4 as t

        hf, _ = t._hf(t.ORACLE, 1, seed=9)
        want, jax_cfg = "Llama4 with LoRA serving is not implemented", t.JaxLlama4Config
    else:
        from tests import test_torch_deepseek as t

        hf, _ = t._hf(t.ORACLE)
        want, jax_cfg = "DeepSeek-V3 MLA with LoRA serving is not implemented", t.JaxDeepseekConfig
    with pytest.raises(NotImplementedError, match=want):
        ModelForCausalLM(None, t._port_cfg(hf, **_lora_kw(max_loras=1)))
    with pytest.raises(NotImplementedError, match=want):
        TpuModelForCausalLM(None, jax_cfg(MoETpuConfig(**t.GEN, **_lora_kw(True, max_loras=1)),
                                          load_config=t._loader(hf)))


@pytest.mark.parametrize("mode", ["contiguous", "paged_ragged"])
def test_serving_session_on_a_lora_app_serves_the_base_model(sd, mode):
    """The serving session takes no adapter ids (as in the reference): on a
    LoRA app its streams equal JAX's session on a LoRA app and the port's
    session without LoRA, on the contiguous cache and through the ragged
    mixed step over the paged pool."""
    kw = dict(is_continuous_batching=True, batch_size=3, ctx_batch_size=1, output_logits=False)
    if mode == "paged_ragged":
        kw.update(is_block_kv_layout=True, pa_block_size=16, pa_num_blocks=24, serving_ragged=True)
    reqs = {"a": [5, 17, 92, 41], "b": list(range(30, 44)), "c": [64, 3, 27, 9, 14, 33]}
    apps = _apps(sd, dict(max_loras=1, max_lora_rank=8), **kw)
    for app in apps:
        app.load_lora_adapters({"x": _adapter(8, 80, ALL_ATTN)})
    plain = _apps(sd, **kw)[1]
    got = []
    for sess in (ServingSession(apps[1]), JaxSession(apps[0]), ServingSession(plain)):
        for rid, p in reqs.items():
            assert sess.add_request(rid, p, max_new_tokens=6)
        got.append(sess.run_to_completion())
    assert got[0] == got[1] == got[2]


def test_params_from_jax_carries_lora_leaves(sd):
    """A LoRA-attached JAX tree crosses through params_from_jax (A and B in
    the dtype, the scalings fp32); the port app over it, with JAX's adapter
    table, generates JAX's tokens and logits."""
    jax_app, _ = _all_attn_apps(sd)
    tree = params_from_jax(jax.device_get(jax_app.params), torch.float32, "cpu")
    q = tree["layers"]["self_attn"]["q_proj"]
    assert q["lora_A"].shape == (2, 3, 256, 16) and q["lora_B"].shape == (2, 3, 16, 256)
    assert q["lora_scaling"].dtype == torch.float32 and q["lora_scaling"].shape == (2, 3)
    port = ModelForCausalLM(None, LlamaInferenceConfig(
        Config(**GEN, **_lora_kw(max_loras=2, max_lora_rank=16), device="cpu"), load_config=_load)).load(params=tree)
    port.lora_manager = lora.LoraWeightManager(port.config.torch_config.lora_config)
    port.lora_manager.adapter_ids = dict(jax_app.lora_manager.adapter_ids)
    _same(*_both((jax_app, port), 5, ["b", "a"]))


def test_lora_config_round_trip():
    """The port's dict is the reference's without ``lora_ckpt_paths`` (read
    only by the reference's demo CLI), which the port refuses as unknown."""
    c = LoraServingConfig(max_loras=3, target_modules=("q_proj", "v_proj"))
    d = c.to_dict()
    ref = JaxLoraConfig(max_loras=3, target_modules=("q_proj", "v_proj")).to_dict()
    assert ref.pop("lora_ckpt_paths") is None
    assert d == ref
    assert LoraServingConfig.from_dict(json.loads(json.dumps(d))) == c
    assert Config(device="cpu", lora_config=d).lora_config == c
    with pytest.raises(ValueError, match="Unknown LoraServingConfig key"):
        LoraServingConfig.from_dict({"max_lora": 2})
    with pytest.raises(ValueError, match=r"Unknown LoraServingConfig key\(s\): \['lora_ckpt_paths'\]"):
        LoraServingConfig.from_dict({"lora_ckpt_paths": {"a": "/x"}})


@pytest.mark.parametrize(
    "dtype, lora_dtype, ok",
    [("float32", "bfloat16", True), ("float32", "float32", True), ("bfloat16", "bf16", True),
     ("bfloat16", "float32", False), ("float32", "float16", False)],
)
def test_lora_dtype_is_default_or_the_model_dtype(dtype, lora_dtype, ok):
    """Adapters are stored in ``Config.dtype`` (reference application.py:351,
    :356; its lora_dtype is read nowhere): the port accepts the default
    and the model's dtype, and refuses any other rather than ignore it."""
    kw = dict(device="cpu", dtype=dtype, lora_config={"lora_dtype": lora_dtype})
    if ok:
        assert Config(**kw).lora_config.lora_dtype == lora_dtype
    else:
        with pytest.raises(NotImplementedError, match=r"ROADMAP C \(LoraServingConfig.lora_dtype\)"):
            Config(**kw)
