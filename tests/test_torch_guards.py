"""Guards of the PyTorch port: it imports neither jax nor the JAX package,
its entry points default to the card and refuse to fall back to the CPU,
settings outside the ported slice raise NotImplementedError naming their
ROADMAP item, and the kernel wrappers take their plain versions only for
CPU tensors."""

import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from neuronx_distributed_inference_tpu.runtime.application import _pick_chunk as jax_pick_chunk
from neuronx_distributed_inference_tpu_torch import config as tconfig
from neuronx_distributed_inference_tpu_torch.config import Config, LoraServingConfig
from neuronx_distributed_inference_tpu_torch.ops import kernel_mode
from neuronx_distributed_inference_tpu_torch.runtime.application import _pick_chunk

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "neuronx_distributed_inference_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "neuronx_distributed_inference_tpu")


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield node.args[0].value


def test_port_and_chip_smoke_import_no_jax():
    scripts = sorted((REPO / "scripts").glob("torch_*.py"))
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"] + scripts
    assert len(files) > 15
    scanned = {str(f.relative_to(PORT)) for f in files if PORT in f.parents}
    assert {
        "workload/__init__.py", "workload/generator.py", "workload/driver.py", "workload/slo.py",
        "telemetry/slo_monitor.py", "telemetry/ops_server.py", "ops/quant.py", "ops/quant_matmul.py",
        "modules/moe.py", "models/mixtral.py", "runtime/fused_spec.py", "models/eagle_draft.py",
        "modules/eagle.py", "modules/token_tree.py", "modules/medusa.py", "runtime/medusa.py",
        "models/gpt_oss.py", "ops/mxfp4.py", "models/dbrx.py", "models/deepseek.py", "modules/norm.py",
    } <= scanned
    assert {f.name for f in scripts} >= {"torch_build_times.py", "torch_router_times.py"}
    bad = [
        (str(f.relative_to(REPO)), mod)
        for f in files
        for mod in _imported_modules(f)
        if mod.split(".")[0] in FORBIDDEN
    ]
    assert bad == []


def test_port_imports_with_jax_blocked():
    modules = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts).replace(".__init__", "")
        for p in PORT.rglob("*.py")
    )
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['neuronx_distributed_inference_tpu'] = None\n"
        f"import importlib\nfor m in {modules!r}:\n    importlib.import_module(m)\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=120
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_default_device_is_cuda_and_cuda_without_a_card_raises(monkeypatch):
    assert {f.name: f.default for f in dataclasses.fields(Config)}["device"] == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Config()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Config(device="cuda:0")
    assert Config(device="cpu").device == "cpu"
    with pytest.raises(ValueError):
        Config(device="mps")


@pytest.mark.parametrize(
    "kw, item",
    [
        (dict(tp_degree=2), "A10"),
        (dict(quantized_checkpoints_path="ckpt"), "A11"),
        (dict(quantized=True, quantized_checkpoints_path="ckpt"), "A11"),
    ],
)
def test_settings_outside_the_slice_raise(kw, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        Config(device="cpu", **kw)


@pytest.mark.parametrize(
    "kw", [dict(padding_side="left"), dict(on_device_sampling_config={"do_sample": True, "top_k": 5})]
)
def test_a3b_settings_are_accepted(kw):
    """Left padding and multinomial sampling are ported (they were refused
    naming A3b until it landed)."""
    c = Config(device="cpu", **kw)
    for name, value in kw.items():
        got = getattr(c, name)
        assert (got.do_sample and got.top_k == 5) if name == "on_device_sampling_config" else got == value


@pytest.mark.parametrize(
    "kw", [dict(sliding_window=128), dict(attention_chunk_size=128), dict(lora_config={"max_loras": 1})]
)
def test_a9_settings_are_accepted(kw):
    """Sliding-window and chunked attention and LoRA serving are ported
    (each was refused naming A9 until it landed; a LoRA dict is read as
    LoraServingConfig.from_dict reads it)."""
    c = Config(device="cpu", **kw)
    for name, value in kw.items():
        got = getattr(c, name)
        assert got == (LoraServingConfig.from_dict(value) if name == "lora_config" else value)


@pytest.mark.parametrize(
    "kw",
    [
        dict(enable_fused_speculation=True, enable_eagle_speculation=True, speculation_length=4),
        dict(medusa_speculation_length=2, num_medusa_heads=2),
    ],
    ids=["eagle", "medusa"],
)
def test_a7_settings_are_accepted(kw):
    """EAGLE and Medusa are ported (they were refused naming A7 until it
    landed)."""
    c = Config(device="cpu", **kw)
    for name, value in kw.items():
        assert getattr(c, name) == value


def test_config_validation_matches_reference():
    with pytest.raises(ValueError):
        Config(device="cpu", kv_cache_dtype="int3")
    with pytest.raises(ValueError):
        Config(device="cpu", padding_side="middle")
    with pytest.raises(ValueError):
        Config(device="cpu", dtype="float64")
    c = Config(device="cpu", batch_size=3, seq_len=512)
    assert (c.max_batch_size, c.ctx_batch_size, c.tkg_batch_size) == (3, 3, 3)
    assert (c.max_context_length, c.max_length) == (512, 512)
    assert tconfig.to_dtype("bf16") is torch.bfloat16


def test_windowed_prefill_raises():
    """Windowed prefill raises where the reference's rule does: a prompt
    past the largest token-generation bucket, which its windows need (and
    past seq_len); a prompt within them prefills in windows."""
    from neuronx_distributed_inference_tpu_torch.models.llama import LlamaInferenceConfig
    from neuronx_distributed_inference_tpu_torch.runtime.application import ModelForCausalLM

    hf = dict(model_type="llama", hidden_size=128, intermediate_size=128, num_attention_heads=2,
              num_key_value_heads=1, num_hidden_layers=1, vocab_size=64, rms_norm_eps=1e-5)
    cfg = LlamaInferenceConfig(
        Config(device="cpu", seq_len=256, max_context_length=128, dtype="float32",
               token_generation_buckets=[192]),
        load_config=lambda c: [setattr(c, k, v) for k, v in hf.items()],
    )
    app = ModelForCausalLM(None, cfg).load(random_weights=True)
    with pytest.raises(ValueError, match="largest token-generation bucket"):
        app.generate(np.ones((1, 193), np.int64), max_new_tokens=2)
    with pytest.raises(ValueError, match="exceeds seq_len"):
        app.generate(np.ones((1, 257), np.int64), max_new_tokens=2)
    assert app.generate(np.ones((1, 129), np.int64), max_new_tokens=2).sequences.shape == (1, 131)


def test_pick_chunk_matches_reference():
    for remaining in (1, 7, 8, 9, 100, 255, 256, 1000):
        for has_eos in (False, True):
            for headroom in (1, 5, 8, 64, 300, 4096):
                assert _pick_chunk(remaining, has_eos, headroom) == jax_pick_chunk(
                    remaining, has_eos, headroom
                )


def test_kernel_gates_follow_the_tri_states_only():
    from neuronx_distributed_inference_tpu_torch.modules.attention import AttnSpec

    for flag in (None, True):
        spec = AttnSpec(num_heads=4, num_kv_heads=2, head_dim=64, use_flash_kernel=flag, use_tkg_kernel=flag)
        assert kernel_mode.use_flash(spec) and kernel_mode.use_tkg(spec)
    off = AttnSpec(num_heads=4, num_kv_heads=2, head_dim=64, use_flash_kernel=False, use_tkg_kernel=False)
    assert not kernel_mode.use_flash(off) and not kernel_mode.use_tkg(off)
    assert kernel_mode.launches_kernel(torch.zeros(1), torch.zeros(2)) is False
    with pytest.raises(ValueError, match="all be on CUDA or all on the CPU"):
        kernel_mode.launches_kernel(torch.zeros(1), torch.zeros(1, device="meta"))


def _serving_app(**tc):
    from neuronx_distributed_inference_tpu_torch.models.llama import LlamaInferenceConfig
    from neuronx_distributed_inference_tpu_torch.runtime.application import ModelForCausalLM

    hf = dict(model_type="llama", hidden_size=128, intermediate_size=128, num_attention_heads=2,
              num_key_value_heads=1, num_hidden_layers=1, vocab_size=64, rms_norm_eps=1e-5)
    cfg = LlamaInferenceConfig(
        Config(device="cpu", dtype="float32", is_continuous_batching=True, batch_size=2,
               ctx_batch_size=1, seq_len=256, **tc),
        load_config=lambda c: [setattr(c, k, v) for k, v in hf.items()],
    )
    return ModelForCausalLM(None, cfg).load(random_weights=True)


def test_serving_settings_outside_the_slice_raise():
    """The serving surface of the port: the telemetry hooks of the workload
    engine and the SLO monitor (A8's rest) record on an enabled session and
    return at once on a disabled one. The disaggregated hand-off is ported: a malformed payload fails
    its one request typed FAILED(handoff). Speculation (A7's first part) is ported:
    serving_spec_ragged is validated as the reference validates it (it
    needs chunked prefill) and the speculative session builds; windowed
    admission (ported with A3b) admits a prompt longer than the context
    bucket on the contiguous cache."""
    from neuronx_distributed_inference_tpu_torch.runtime.serving import (
        ServingSession,
        SpeculativeServingSession,
    )

    with pytest.raises(ValueError, match="is_chunked_prefill"):
        Config(
            device="cpu", is_continuous_batching=True, is_block_kv_layout=True, serving_ragged=True,
            serving_spec_ragged=True, speculation_length=4,
        )
    app = _serving_app(context_encoding_buckets=[128], max_context_length=128)
    assert SpeculativeServingSession(app, app).k == 4
    sess = ServingSession(app)
    assert sess.add_prefilled_request("h", [1, 2, 3], {}, first_token=4)
    assert (sess.requests["h"].status, sess.requests["h"].fail_reason) == ("failed", "handoff")
    from neuronx_distributed_inference_tpu_torch.telemetry import SloMonitor, TelemetrySession

    off = TelemetrySession(enabled=False)
    off.set_tenants({"a-0000": "a"})
    off.workload_refused("no_slot")
    assert off.attach_slo_monitor(SloMonitor()).slo_monitor is None
    with TelemetrySession() as tel:
        tel.set_tenants({"r-0001": "prose0"})
        assert tel._tenant_track("r-0001") == "tenant:prose0"
        mon = SloMonitor()
        assert tel.attach_slo_monitor(mon).slo_monitor is mon
        tel.chaos_kill(1, "decode", 4)
        tel.workload_step(4, {"r-0001": 2}, 1.0)
        tel.slo_missed("ttft", "prose0")
        tel.workload_backlog(3)
        tel.workload_refused("no_slot")
        snap = tel.registry.snapshot()
    assert snap["nxdi_workload_backlog_depth"]["samples"][0]["value"] == 3
    assert snap["nxdi_workload_refusals_total"]["samples"][0]["labels"] == {"reason": "no_slot"}
    assert snap["nxdi_slo_missed_total"]["samples"][0]["labels"] == {"kind": "ttft", "tenant": "prose0"}
    assert [e["type"] for e in tel.events if e["type"] in ("chaos_kill", "workload_step")] == [
        "chaos_kill", "workload_step",
    ]
    assert sess.add_request("long", list(range(1, 60)) * 3, max_new_tokens=2)


def test_serving_config_validation_matches_reference():
    """The reference's serving checks and its default pool size."""
    from neuronx_distributed_inference_tpu.config import TpuConfig

    bad = [
        dict(pa_pool_bytes=1 << 20),
        dict(is_block_kv_layout=True, pa_pool_bytes=1 << 20, pa_num_blocks=4),
        dict(request_deadline_s=0.0),
        dict(dispatch_max_retries=-1),
        dict(watchdog_no_progress_steps=-1),
        dict(is_chunked_prefill=True),
        dict(is_chunked_prefill=True, is_block_kv_layout=True),
        dict(is_prefix_caching=True),
        dict(is_continuous_batching=True, serving_ragged=True),
    ]
    for kw in bad:
        with pytest.raises(ValueError):
            TpuConfig(**kw)
        with pytest.raises(ValueError):
            Config(device="cpu", **kw)
    kw = dict(batch_size=3, seq_len=100, is_block_kv_layout=True, pa_block_size=32,
              is_continuous_batching=True, is_chunked_prefill=True)
    ref, port = TpuConfig(**kw), Config(device="cpu", **kw)
    assert port.pa_num_blocks == ref.pa_num_blocks == 10
    assert port.chunked_prefill_config.kernel_q_tile_size == ref.chunked_prefill_config.kernel_q_tile_size
    assert port.chunked_prefill_config.max_num_seqs == ref.chunked_prefill_config.max_num_seqs
    for name in ("admission_validation", "request_deadline_s", "dispatch_max_retries",
                 "watchdog_no_progress_steps", "kv_cache_batch_size", "pa_block_size"):
        assert getattr(port, name) == getattr(ref, name), name


def test_pool_bytes_size_the_paged_pool():
    from neuronx_distributed_inference_tpu_torch.modules.block_kvcache import kv_block_bytes

    per_block = kv_block_bytes(1, 16, 1, 64, torch.float32)
    app = _serving_app(is_block_kv_layout=True, pa_pool_bytes=10 * per_block + 5)
    assert app.config.torch_config.pa_num_blocks == 10
    assert app.kv_cache.num_blocks == 10 and tuple(app.kv_cache.k.shape) == (1, 11, 1, 16, 64)
    with pytest.raises(NotImplementedError, match="ServingSession"):
        app.generate(np.ones((1, 4), np.int64), max_new_tokens=2)


def _moe_app(tc_cls=None, **tc):
    """A tiny Qwen3-MoE app on the CPU (32 experts of width 64, top-2)."""
    from neuronx_distributed_inference_tpu_torch.config import InferenceConfig, MoEConfig
    from neuronx_distributed_inference_tpu_torch.runtime.application import ModelForCausalLM

    hf = dict(model_type="qwen3_moe", hidden_size=128, moe_intermediate_size=64, num_attention_heads=2,
              num_key_value_heads=1, head_dim=64, num_hidden_layers=1, vocab_size=64, num_experts=32,
              num_experts_per_tok=2, rms_norm_eps=1e-6)
    cfg = InferenceConfig(
        (tc_cls or MoEConfig)(device="cpu", dtype="float32", seq_len=128, **tc),
        load_config=lambda c: [setattr(c, k, v) for k, v in hf.items()],
    )
    return ModelForCausalLM(None, cfg)


@pytest.mark.parametrize(
    "kw, item",
    [
        (dict(ep_degree=2), "A10"),
        (dict(hybrid_sharding_config=dict(moe_cte_tp_degree=1, moe_cte_ep_degree=1)), "A10"),
    ],
)
def test_moe_settings_outside_the_slice_raise(kw, item):
    from neuronx_distributed_inference_tpu_torch.config import MoEConfig

    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        MoEConfig(device="cpu", **kw)


def test_moe_chunked_attention_is_accepted():
    """Chunked attention on an MoE config is ported (it was refused naming
    A9 until it landed)."""
    from neuronx_distributed_inference_tpu_torch.config import MoEConfig

    assert MoEConfig(device="cpu", attention_chunk_size=8).attention_chunk_size == 8


def test_moe_config_matches_reference():
    """MoEConfig keeps MoETpuConfig's field names, defaults and checks."""
    from neuronx_distributed_inference_tpu.config import MoETpuConfig
    from neuronx_distributed_inference_tpu_torch.config import MoEConfig

    ref, port = MoETpuConfig(), MoEConfig(device="cpu")
    for name in ("capacity_factor", "glu_mlp", "glu_type", "hidden_act_scaling_factor", "hidden_act_bias",
                 "early_expert_affinity_modulation", "fused_shared_experts",
                 "router_dtype", "moe_fused_kernel_enabled", "hybrid_sharding_config", "ep_degree"):
        assert getattr(port, name) == getattr(ref, name), name
    for kw in (dict(glu_mlp=False), dict(glu_type="swiglu")):
        with pytest.raises(NotImplementedError):
            MoETpuConfig(**kw)
        with pytest.raises(NotImplementedError):
            MoEConfig(device="cpu", **kw)
    with pytest.raises(ValueError):
        MoEConfig(device="cpu", router_dtype="float64")


@pytest.mark.parametrize("kw", [dict(weight_dtype="int8"), dict(quantized=True), dict(weight_dtype="int4")])
def test_quantized_moe_raises_naming_a9(kw):
    """Quantized MoE weights load and generate under MoEConfig and the
    plain Config (their experts quantized with the other linears, the
    router not), fused shared experts too; what stays refused names its
    ROADMAP item: quantized weights on an MLA model (A9)."""
    from neuronx_distributed_inference_tpu_torch.config import Config

    for cls in (None, Config):
        app = _moe_app(cls, **kw).load(random_weights=True)
        experts = app.params["layers"][0]["mlp"]["experts"]
        want = torch.uint8 if kw.get("weight_dtype") == "int4" else torch.int8
        assert all(experts[k]["weight"].dtype == want and "scale" in experts[k] for k in experts)
        assert "scale" not in app.params["layers"][0]["mlp"]["router"]
        out = app.generate(np.array([[1, 2, 3]]), max_new_tokens=3)
        assert out.sequences.shape == (1, 6)
    assert _moe_app(fused_shared_experts=True, **kw).load(random_weights=True).params is not None
    from neuronx_distributed_inference_tpu_torch.config import MoEConfig
    from neuronx_distributed_inference_tpu_torch.models.deepseek import DeepseekV3InferenceConfig
    from neuronx_distributed_inference_tpu_torch.runtime.application import ModelForCausalLM

    mla = dict(model_type="deepseek_v3", hidden_size=64, intermediate_size=96, moe_intermediate_size=32,
               num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=4, n_routed_experts=4,
               num_experts_per_tok=2, kv_lora_rank=16, q_lora_rank=None, qk_rope_head_dim=8, v_head_dim=16,
               qk_nope_head_dim=16, first_k_dense_replace=1, vocab_size=64)
    cfg = DeepseekV3InferenceConfig(MoEConfig(device="cpu", dtype="float32", seq_len=128, **kw),
                                    load_config=lambda c: [setattr(c, k, v) for k, v in mla.items()])
    with pytest.raises(NotImplementedError, match=r"ROADMAP A9 \(MLA with quantized weights\)"):
        ModelForCausalLM(None, cfg)


def test_serving_an_moe_model_raises_naming_a9():
    """generate() and the serving sessions (split and ragged) run an MoE
    model, and speculative serving builds with an MoE target, draft or
    both (no "ROADMAP A9 (MoE speculation)" refusal is left)."""
    from neuronx_distributed_inference_tpu_torch.runtime.serving import (
        ServingSession,
        SpeculativeServingSession,
    )

    serve = dict(is_continuous_batching=True, batch_size=2, ctx_batch_size=1, is_block_kv_layout=True)
    app = _moe_app(**serve).load(random_weights=True)
    assert ServingSession(app).num_slots == 2
    assert _moe_app(**serve, serving_ragged=True).load(random_weights=True).mixed_step_model is not None
    plain = dict(is_continuous_batching=True, batch_size=2, ctx_batch_size=1)
    moe = _moe_app(**plain).load(random_weights=True)
    dense = _serving_app(token_generation_buckets=[128])
    for target, draft in ((moe, moe), (moe, dense), (dense, moe)):
        sess = SpeculativeServingSession(target, draft, speculation_length=3)
        assert sess.k == 3 and sess.num_slots == 2 and not sess.spec_ragged
    out = _moe_app().load(random_weights=True).generate(np.array([[1, 2, 3]]), max_new_tokens=3)
    assert out.sequences.shape == (1, 6)


#: the vision-language slice's modules
VLM_MODULES = (
    "models/pixtral.py", "models/llama4_vision.py", "models/mllama.py", "runtime/image_to_text.py",
    "runtime/encoder.py", "runtime/mllama.py",
)


@pytest.mark.parametrize("rel", VLM_MODULES)
def test_vision_language_modules_import_no_jax(rel):
    """Each module of the vision-language slice exists and imports neither
    jax nor the JAX package (nor a module of it that does not import jax)."""
    path = PORT / rel
    assert path.is_file()
    assert [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN] == []


def _tiny_llama_app(**kw):
    from neuronx_distributed_inference_tpu_torch.models.llama import LlamaInferenceConfig
    from neuronx_distributed_inference_tpu_torch.runtime.application import ModelForCausalLM

    hf = dict(model_type="llama", hidden_size=128, intermediate_size=128, num_attention_heads=2,
              num_key_value_heads=1, num_hidden_layers=1, vocab_size=64, rms_norm_eps=1e-5)
    cfg = LlamaInferenceConfig(Config(device="cpu", dtype="float32", **kw),
                               load_config=lambda c: [setattr(c, k, v) for k, v in hf.items()])
    return ModelForCausalLM(None, cfg).load(random_weights=True)


def _mllama_config(**kw):
    from neuronx_distributed_inference_tpu_torch.models.mllama import MllamaInferenceConfig

    text = dict(hidden_size=128, num_attention_heads=2, num_key_value_heads=1, num_hidden_layers=3,
                cross_attention_layers=[1], vocab_size=64, intermediate_size=128)
    vision = dict(hidden_size=32, attention_heads=2, intermediate_size=64, num_hidden_layers=2, num_global_layers=1,
                  image_size=16, patch_size=8, max_num_tiles=2, intermediate_layers_indices=[0])
    return MllamaInferenceConfig(Config(dtype="float32", **kw), text_config=text, vision_config=vision)


def _mllama_app(**kw):
    from neuronx_distributed_inference_tpu_torch.runtime.mllama import MllamaForConditionalGeneration

    return MllamaForConditionalGeneration(None, _mllama_config(device="cpu", **kw))


def _refuse_embeds_window():
    app = _tiny_llama_app(seq_len=128, max_context_length=4)
    app.generate(np.ones((1, 8), np.int64), max_new_tokens=2, inputs_embeds=torch.zeros((1, 8, 128)))


def _refuse_mllama_kv_int8():
    _mllama_app(kv_cache_dtype="int8").load(params={})


def _refuse_whisper_checkpoint_path():
    from neuronx_distributed_inference_tpu_torch.runtime.encoder_decoder import WhisperModel

    WhisperModel(None, _whisper_config(device="cpu")).load(model_path="openai/whisper-large-v3")


@pytest.mark.parametrize("refuse, item", [
    (_refuse_embeds_window, r"ROADMAP C \(inputs_embeds with windowed prefill\)"),
    (_refuse_mllama_kv_int8, r"ROADMAP C \(Mllama's quantized KV cache\)"),
    (_refuse_whisper_checkpoint_path, r"ROADMAP A11"),
])
def test_vision_language_refusals_name_their_roadmap_items(refuse, item):
    with pytest.raises(NotImplementedError, match=item):
        refuse()


def test_vision_language_entry_points_default_to_the_card(monkeypatch):
    """The Mllama app takes the config's device: the CPU only when asked,
    else the card by default, which raises where torch sees none."""
    from neuronx_distributed_inference_tpu_torch.runtime.mllama import MllamaForConditionalGeneration

    assert _mllama_app().device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MllamaForConditionalGeneration(None, _mllama_config())


#: the speech-to-text and text-to-image slice's modules
A9_REST_MODULES = (
    "models/whisper.py", "runtime/encoder_decoder.py", "models/flux.py", "models/flux_text.py", "models/flux_vae.py",
    "runtime/flux.py", "modules/kvcache.py", "models/deepseek.py", "models/builder.py",
)


@pytest.mark.parametrize("rel", A9_REST_MODULES)
def test_speech_and_image_modules_import_no_jax(rel):
    """Each module of the Whisper / FLUX / quantized-MLA slice exists and
    imports neither jax nor the JAX package."""
    path = PORT / rel
    assert path.is_file()
    assert [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN] == []


def _whisper_config(**kw):
    from neuronx_distributed_inference_tpu_torch.config import InferenceConfig

    hf = dict(d_model=64, encoder_layers=1, decoder_layers=1, decoder_attention_heads=2, num_mel_bins=8,
              vocab_size=32, max_source_positions=8, max_target_positions=16)
    return InferenceConfig(Config(batch_size=1, seq_len=16, dtype="float32", **kw),
                           load_config=lambda c: [setattr(c, k, v) for k, v in hf.items()])


def _flux_config(**kw):
    from neuronx_distributed_inference_tpu_torch.models.flux import FluxSpec
    from neuronx_distributed_inference_tpu_torch.models.flux_text import ClipTextSpec, T5EncoderSpec
    from neuronx_distributed_inference_tpu_torch.runtime.flux import FluxPipelineConfig

    return FluxPipelineConfig(
        backbone=FluxSpec(dim=32, num_heads=2, head_dim=16, num_dual=1, num_single=1, joint_dim=16, pooled_dim=8,
                          axes_dims_rope=(4, 6, 6)),
        clip=ClipTextSpec(hidden_size=8, num_heads=2, num_layers=1, intermediate_size=16, vocab_size=16,
                          max_positions=8),
        t5=T5EncoderSpec(d_model=16, num_heads=2, d_kv=8, num_layers=1, d_ff=16, vocab_size=16), **kw,
    )


def test_whisper_and_flux_default_to_the_card(monkeypatch):
    """Built without a device, WhisperModel and FluxPipeline take the card,
    which raises where torch sees none; the CPU only when asked."""
    from neuronx_distributed_inference_tpu_torch.runtime.encoder_decoder import WhisperModel
    from neuronx_distributed_inference_tpu_torch.runtime.flux import FluxPipeline, FluxPipelineConfig

    assert WhisperModel(None, _whisper_config(device="cpu")).device.type == "cpu"
    assert FluxPipeline(_flux_config(device="cpu")).device.type == "cpu"
    assert {f.name: f.default for f in dataclasses.fields(FluxPipelineConfig)}["device"] == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        WhisperModel(None, _whisper_config())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FluxPipeline(_flux_config())


@pytest.mark.parametrize("case", ["flux_checkpoint", "flux_mesh"])
def test_speech_and_image_refusals_name_their_roadmap_items(case):
    """A FLUX checkpoint path names A11 (Whisper's is in the refusals
    above); FLUX over a mesh of two devices names A10."""
    from neuronx_distributed_inference_tpu_torch.runtime.flux import FluxPipeline

    if case == "flux_checkpoint":
        with pytest.raises(NotImplementedError, match="ROADMAP A11"):
            FluxPipeline(_flux_config(device="cpu")).load()
    else:
        with pytest.raises(NotImplementedError, match="ROADMAP A10"):
            FluxPipeline(_flux_config(device="cpu"), mesh=["cuda:0", "cuda:1"])
