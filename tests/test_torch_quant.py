"""The port's weight quantization held against the JAX package's on the same
numpy inputs: int8 / fp8 codes and scales per channel, per tensor and
blockwise, the packed int4 format and its dequantization (byte-identical),
``linear`` for every entry kind, the set of leaves ``quantize_params``
converts, B6's plain version against the JAX kernel in interpret mode and
its native path, the route by row count, and ``params_from_jax``.

On CPU tensors B6's wrapper takes its plain version, so nothing launches."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuronx_distributed_inference_tpu.config import TpuConfig
from neuronx_distributed_inference_tpu.models.llama import LlamaInferenceConfig as JaxLlamaConfig
from neuronx_distributed_inference_tpu.ops import kernel_mode as jkm
from neuronx_distributed_inference_tpu.ops import quant as jq
from neuronx_distributed_inference_tpu.ops import quant_matmul as jqm
from neuronx_distributed_inference_tpu.runtime.application import TpuModelForCausalLM
from neuronx_distributed_inference_tpu_torch.config import Config
from neuronx_distributed_inference_tpu_torch.models.builder import params_from_jax
from neuronx_distributed_inference_tpu_torch.models.llama import LlamaInferenceConfig
from neuronx_distributed_inference_tpu_torch.ops import _cuda, kernel_mode
from neuronx_distributed_inference_tpu_torch.ops import quant as tq
from neuronx_distributed_inference_tpu_torch.ops import quant_matmul as tqm
from neuronx_distributed_inference_tpu_torch.runtime.application import ModelForCausalLM
from tests.conftest import make_random_hf_state_dict

def _weights(shape, seed=0, qmax=127.0):
    """Weights with a spread of magnitudes below ``qmax``, and column 0 made
    of exact rounding ties: ``qmax`` at every 32nd row (so the absmax of
    every group, block, channel and tensor is ``qmax`` and the scale exactly
    1) and k + 0.5 elsewhere, which round half to even in both packages."""
    rng = np.random.RandomState(seed)
    w = rng.randn(*shape) * np.exp(rng.randn(*shape[:-2], 1, shape[-1]))
    w = np.clip(w, -0.9 * qmax, 0.9 * qmax).astype(np.float32)
    K = shape[-2]
    ties = (np.arange(K) % 7 - 3 + 0.5).astype(np.float32)
    ties[::32] = qmax
    w[..., :, 0] = ties
    return w


def _bytes(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.uint8).numpy()


def _jbytes(a) -> np.ndarray:
    return np.asarray(a).view(np.uint8)


def _same_entry(port: dict, ref: dict):
    assert port["weight"].shape == tuple(np.asarray(ref["weight"]).shape)
    assert port["scale"].dtype == torch.float32
    np.testing.assert_array_equal(_bytes(port["weight"]), _jbytes(ref["weight"]))
    np.testing.assert_array_equal(port["scale"].numpy(), np.asarray(ref["scale"]))


@pytest.mark.parametrize("source", ["numpy", "jnp"])
@pytest.mark.parametrize("per_channel", [True, False])
@pytest.mark.parametrize("qd", ["int8", "fp8", "float8_e5m2"])
def test_quantize_tensor_byte_identical(qd, per_channel, source):
    """Stacked (L, K, N) leaves; the reference's host (numpy) and device
    (jnp) paths both."""
    w = _weights((3, 96, 40), qmax=127.0 if qd == "int8" else 448.0)
    ref = jq.quantize_tensor(w if source == "numpy" else jnp.asarray(w), qd, per_channel)
    port = tq.quantize_tensor(torch.from_numpy(w), qd, per_channel)
    assert port["weight"].dtype == tq.QUANT_DTYPES[qd]
    assert port["scale"].shape == ((3, 40) if per_channel else (3, 1))
    _same_entry(port, ref)


@pytest.mark.parametrize("qd, block", [("int8", 64), ("int8", 128), ("fp8", 64), ("float8_e5m2", 128)])
def test_quantize_tensor_blockwise_byte_identical(qd, block):
    w = _weights((2, 256, 24), seed=1, qmax=127.0 if qd == "int8" else 448.0)
    ref = jq.quantize_tensor_blockwise(jnp.asarray(w), qd, block)
    port = tq.quantize_tensor_blockwise(torch.from_numpy(w), qd, block)
    assert port["scale"].shape == (2, 256 // block, 24)
    _same_entry(port, ref)
    with pytest.raises(ValueError, match="divisible"):
        tq.quantize_tensor_blockwise(torch.zeros(100, 8), qd, block)


@pytest.mark.parametrize("group", [32, 64, 128])
@pytest.mark.parametrize("shape", [(256, 40), (333, 24), (2, 3, 200, 16)])
def test_quantize_int4_and_dequantize_byte_identical(shape, group):
    """Odd K pads with 0x88 codes; leading dims pass through; the
    dequantized weight is the same fp32 product in both packages."""
    w = _weights(shape, seed=2, qmax=7.0)
    port = tqm.quantize_tensor_int4(torch.from_numpy(w), group)
    assert port["weight"].dtype == torch.uint8
    for source in (w, jnp.asarray(w)):  # the reference's host and device paths
        ref = jqm.quantize_tensor_int4(source, group)
        _same_entry(port, ref)
    K = shape[-2]
    deq = tqm.dequantize_int4(port["weight"], port["scale"], k=K)
    np.testing.assert_array_equal(deq.numpy(), np.asarray(jqm.dequantize_int4(ref["weight"], ref["scale"], k=K)))
    assert tqm.is_int4_entry(port) and not tqm.is_int4_entry(tq.quantize_tensor(torch.from_numpy(w)))


def _entries(K, N):
    """One entry of every kind the model code meets, from the same weight,
    in both packages."""
    w = _weights((K, N), seed=3, qmax=7.0)
    kinds = {
        "plain": ({"weight": jnp.asarray(w)}, {"weight": torch.from_numpy(w)}),
        "int8_channel": (jq.quantize_tensor(w, "int8"), tq.quantize_tensor(torch.from_numpy(w), "int8")),
        "int8_tensor": (jq.quantize_tensor(w, "int8", False), tq.quantize_tensor(torch.from_numpy(w), "int8", False)),
        "fp8_channel": (jq.quantize_tensor(w, "fp8"), tq.quantize_tensor(torch.from_numpy(w), "fp8")),
        "int8_blockwise": (
            jq.quantize_tensor_blockwise(w, "int8", 128),
            tq.quantize_tensor_blockwise(torch.from_numpy(w), "int8", 128),
        ),
        "int4": (jqm.quantize_tensor_int4(w), tqm.quantize_tensor_int4(torch.from_numpy(w))),
    }
    return kinds


@pytest.mark.parametrize("rows", [1, 65])
@pytest.mark.parametrize(
    "kind", ["plain", "int8_channel", "int8_tensor", "fp8_channel", "int8_blockwise", "int4"]
)
def test_linear_matches_jax_at_fp32(kind, rows):
    """fp32, within 1e-5 of max |ref| (XLA's and PyTorch's sums run in
    different orders); 65 rows takes the int4 dense route."""
    ref_entry, port_entry = _entries(256, 384)[kind]
    x = np.random.RandomState(4).randn(rows, 256).astype(np.float32)
    ref_entry = {k: jnp.asarray(v) for k, v in ref_entry.items()}
    ref = np.asarray(jq.linear(ref_entry, jnp.asarray(x)))
    _cuda.reset_launch_counts()
    out = tq.linear(port_entry, torch.from_numpy(x))
    assert _cuda.launch_counts() == {name: 0 for name in _cuda.KERNELS} and _cuda.route_counts()["int4_dense"] == 0
    assert out.shape == (rows, 384) and out.is_contiguous()
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def _trees(**tc):
    """The same tiny HF checkpoint through both packages' converters."""
    hf = dict(model_type="llama", hidden_size=256, intermediate_size=512, num_attention_heads=4,
              num_key_value_heads=2, num_hidden_layers=2, vocab_size=128, rms_norm_eps=1e-5,
              rope_theta=10000.0, max_position_embeddings=256, hidden_act="silu", tie_word_embeddings=True)

    def load(c):
        for k, v in hf.items():
            setattr(c, k, v)

    base = dict(batch_size=1, seq_len=64, dtype="float32", fused_qkv=True)
    jcfg = JaxLlamaConfig(TpuConfig(**base, **tc), load_config=load)
    sd = make_random_hf_state_dict(jcfg, seed=6)
    japp = TpuModelForCausalLM(None, jcfg)
    japp.load(state_dict=sd)
    papp = ModelForCausalLM(None, LlamaInferenceConfig(Config(**base, **tc, device="cpu"), load_config=load))
    return japp, papp.load(state_dict=sd)


def _paths(tree, prefix=()):
    """{path: entry} of every quantized entry (a dict with a scale)."""
    out = {}
    if isinstance(tree, dict):
        if "scale" in tree:
            return {prefix: tree}
        for k, v in tree.items():
            out.update(_paths(v, prefix + (k,)))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            out.update(_paths(v, prefix + (str(i),)))
    return out


@pytest.mark.parametrize(
    "tc",
    [
        dict(weight_dtype="int8"),
        dict(weight_dtype="int4"),
        dict(quantized=True, quantization_dtype="fp8", modules_to_not_convert=[*tq.DEFAULT_SKIP, "lm_head", "o_proj"]),
        dict(quantized=True, quantization_type="blockwise", blockwise_matmul_block_size=128),
        dict(weight_dtype="int4", modules_to_not_convert=[*tq.DEFAULT_SKIP, "mlp"]),
    ],
    ids=["int8", "int4", "fp8_skip", "blockwise", "int4_skip"],
)
def test_quantize_params_converts_the_reference_leaves(tc):
    """The same set of leaf paths converts (the tied model's materialized lm
    head included, the embedding not, under DEFAULT_SKIP), with the same
    codes and scales, layer by layer."""
    japp, papp = _trees(**tc)
    import jax

    ref = _paths(jax.device_get(japp.params))
    port = params_from_jax(jax.device_get(japp.params), torch.float32, "cpu")
    mine = {}
    for path, entry in _paths(papp.params).items():
        if path[0] == "layers":
            mine.setdefault(("layers",) + path[2:], []).append(entry)
        else:
            mine[path] = [entry]
    assert sorted(mine) == sorted(ref) and ref
    skip = tc.get("modules_to_not_convert") or list(tq.DEFAULT_SKIP)
    assert ("lm_head",) in ref if "lm_head" not in skip else ("lm_head",) not in ref
    for path, entries in mine.items():
        node = port
        for k in path:
            node = node[k]
        for i, e in enumerate(entries):
            stacked = path[0] == "layers"
            w, s = (node["weight"][i], node["scale"][i]) if stacked else (node["weight"], node["scale"])
            assert torch.equal(_as_bytes(e["weight"]), _as_bytes(w)) and torch.equal(e["scale"], s), path
    assert papp.params["embed_tokens"]["weight"].dtype == torch.float32


def _as_bytes(t):
    return t.contiguous().view(torch.uint8)


def test_params_from_jax_carries_codes_and_scales_unchanged():
    import jax

    for tc in (dict(weight_dtype="int4"), dict(quantized=True, quantization_dtype="float8_e5m2")):
        japp, _ = _trees(**tc)
        tree = jax.device_get(japp.params)
        port = params_from_jax(tree, torch.bfloat16, "cpu")
        for path, ref in _paths(tree).items():
            node = port
            for k in path:
                node = node[k]
            assert node["scale"].dtype == torch.float32
            np.testing.assert_array_equal(node["scale"].numpy(), np.asarray(ref["scale"]))
            np.testing.assert_array_equal(_bytes(node["weight"]), _jbytes(ref["weight"]))
        assert port["layers"]["input_layernorm"]["weight"].dtype == torch.bfloat16
        assert port["rope"]["inv_freq"].dtype == torch.float32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N", [256, 384])
@pytest.mark.parametrize("K", [256, 512, 1000])
@pytest.mark.parametrize("rows", [1, 8, 64])
def test_quant_matmul_plain_matches_jax_kernel_and_native(rows, K, N, dtype):
    """B6's plain version against the JAX kernel (Pallas in interpret mode)
    and its native path, on random codes with a distinct random scale per
    (group, column). fp32: within 1e-5 of max |ref| (XLA's and PyTorch's
    sums run in different orders). bf16: within one bf16 rounding (2^-8 of
    |ref|, plus 1e-5 of max |ref|) of the JAX paths run in fp32 on the same
    bf16 values, and within one bf16 ulp (2^-7) of the JAX paths' own bf16
    outputs, since both sides round a slightly different fp32 sum."""
    rng = np.random.RandomState(rows * 7 + K + N)
    kp = -(-K // 256) * 256
    packed = jnp.asarray(rng.randint(0, 256, size=(kp // 2, N)).astype(np.uint8))
    scale = jnp.asarray((rng.uniform(0.5, 1.5, size=(kp // 128, N)) * 0.02).astype(np.float32))
    xj = jnp.asarray(rng.randn(rows, K).astype(np.float32)).astype(getattr(jnp, dtype))
    x = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(getattr(torch, dtype))

    def jax_paths(xs):
        kern = jqm.quant_matmul(xs, packed, scale, interpret=True)
        native = jqm.int4_matmul_native(xs, packed, scale)
        return [np.asarray(r.astype(jnp.float32)) for r in (kern, native)]

    _cuda.reset_launch_counts()
    p, s_ = torch.from_numpy(np.asarray(packed)), torch.from_numpy(np.asarray(scale))
    out = tqm.quant_matmul(x, p, s_).float().numpy()
    assert _cuda.launch_counts()["quant_matmul"] == 0
    np.testing.assert_array_equal(out, tqm.quant_matmul_plain(x, p, s_).float().numpy())
    for ref in jax_paths(xj.astype(jnp.float32)):
        rtol = 0.0 if dtype == "float32" else 2.0 ** -8
        np.testing.assert_allclose(out, ref, rtol=rtol, atol=1e-5 * np.abs(ref).max())
    if dtype == "bfloat16":
        for ref in jax_paths(xj):
            np.testing.assert_allclose(out, ref, rtol=2.0 ** -7, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("rows", [1, 64, 65, 200])
def test_route_by_rows_matches_the_reference_rule(rows):
    """At most 64 rows go to B6 (the reference's rule with mode True on
    kernel-eligible shapes); mode False sends every call to the plain
    version; on the CPU every route computes the plain version and counts
    nothing."""
    with jkm.quant_matmul_mode(True):
        assert kernel_mode.use_quant_matmul(rows) == jkm.use_quant_matmul(rows, 512, 256)
    with kernel_mode.quant_matmul_mode(False):
        assert not kernel_mode.use_quant_matmul(rows) and kernel_mode.quant_matmul_off()
    _, entry = _entries(512, 256)["int4"]
    x = torch.from_numpy(np.random.RandomState(rows).randn(rows, 512).astype(np.float32))
    _cuda.reset_launch_counts()
    out = tq.linear(entry, x)
    assert _cuda.launch_counts()["quant_matmul"] == 0 and _cuda.route_counts() == {n: 0 for n in _cuda.ROUTES}
    torch.testing.assert_close(out, tqm.quant_matmul_plain(x, entry["weight"], entry["scale"]), rtol=0, atol=0)
    torch.testing.assert_close(
        tqm.int4_matmul_dense(x, entry["weight"], entry["scale"]), out, rtol=0, atol=0
    )


def test_mode_setters_match_the_reference():
    for bad in ("on", 2, None):
        with pytest.raises(ValueError):
            kernel_mode.set_quant_matmul_mode(bad)
        with pytest.raises(ValueError):
            with kernel_mode.quant_matmul_mode(bad):
                pass
    kernel_mode.set_quant_matmul_mode(False)
    try:
        assert kernel_mode.quant_matmul_off()
        with kernel_mode.quant_matmul_mode("auto"):
            assert kernel_mode.use_quant_matmul(1)
        assert not kernel_mode.use_quant_matmul(1)
    finally:
        kernel_mode.set_quant_matmul_mode("auto")
    assert kernel_mode.use_quant_matmul(64) and not kernel_mode.use_quant_matmul(65)


def test_quant_matmul_refuses_what_b6_does_not_take():
    packed = torch.zeros(128, 256, dtype=torch.uint8)
    scale = torch.ones(2, 256)
    x = torch.zeros(1, 256)
    tqm.quant_matmul(x, packed, scale)
    with pytest.raises(ValueError, match="scale"):
        tqm.quant_matmul(x, packed, torch.ones(4, 256))
    with pytest.raises(ValueError, match="multiple of 256"):
        tqm.quant_matmul(x, torch.zeros(64, 256, dtype=torch.uint8), torch.ones(1, 256))
    with pytest.raises(ValueError, match="K"):
        tqm.quant_matmul(torch.zeros(1, 300), packed, scale)
    with pytest.raises(ValueError, match="dtype"):
        tqm.quant_matmul(x.half(), packed, scale)
    with pytest.raises(ValueError, match="uint8"):
        tqm.quant_matmul(x, packed.to(torch.int8), scale)


def test_config_quantization_fields_match_the_reference():
    """The same fields, defaults and checks as the reference's TpuConfig:
    weight_dtype="int8" sets quantized, int4 with quantized=True and an
    unknown quantization_type or weight_dtype raise ValueError."""
    import dataclasses

    names = ("quantized", "quantization_type", "quantization_dtype", "modules_to_not_convert",
             "blockwise_matmul_block_size", "weight_dtype", "quantized_checkpoints_path")
    ref_defaults = {f.name: f.default for f in dataclasses.fields(TpuConfig)}
    port_defaults = {f.name: f.default for f in dataclasses.fields(Config)}
    assert {n: port_defaults[n] for n in names} == {n: ref_defaults[n] for n in names}
    for kw in (dict(weight_dtype="int8"), dict(weight_dtype="bf16"), dict(weight_dtype="int4")):
        ref, port = TpuConfig(**kw), Config(device="cpu", **kw)
        assert (port.quantized, port.weight_dtype, port.weight_int4) == (ref.quantized, ref.weight_dtype, ref.weight_int4)
    for kw in (dict(weight_dtype="int4", quantized=True), dict(quantization_type="per_row"), dict(weight_dtype="int2")):
        with pytest.raises(ValueError):
            TpuConfig(**kw)
        with pytest.raises(ValueError):
            Config(device="cpu", **kw)
