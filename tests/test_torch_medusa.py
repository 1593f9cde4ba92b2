"""The port's Medusa speculation (``runtime/medusa.MedusaModelForCausalLM``,
``modules/medusa.py``) against the JAX package's on the CPU, fp32, with
the tiny head_dim-64 target of ``tests/torch_eagle_common.py`` and Medusa
heads in the checkpoint layout (``medusa_head.{i}.0.linear.*``,
``.{i}.1.weight``) made from a seed with numpy. Mirrors the Medusa cases of
the reference's ``tests/test_speculation_family.py``.

- Greedy ``generate()``: sequences and per-round counts equal the JAX
  app's and the sequences plain greedy ``generate()``'s, with random heads
  and with heads that propose the target's own last prediction (so rounds
  accept); the cache and the hidden buffer within 5e-5 of JAX's (fp32).
- The heads' logits (``medusa_head_logits``) within 1e-5 of JAX's.
- ``params_from_jax`` carries the heads (res weight and bias, lm head)
  equal to the port's conversion.
- Random heads build, generate and seal; the refusals raise the
  reference's exception types.
"""

import jax
import numpy as np
import pytest
import torch

from neuronx_distributed_inference_tpu.runtime.medusa import TpuMedusaModelForCausalLM
from neuronx_distributed_inference_tpu_torch.analysis.retrace_guard import RetraceGuard
from neuronx_distributed_inference_tpu_torch.models.builder import params_from_jax
from neuronx_distributed_inference_tpu_torch.runtime.application import ModelForCausalLM
from neuronx_distributed_inference_tpu_torch.runtime.medusa import MedusaModelForCausalLM
from tests.test_torch_eagle import STATE_ATOL
from tests.torch_eagle_common import HF, MASK, PROMPTS, jax_cfg, jax_rounds, port_cfg, port_rounds, target_sd

K, HEADS = 4, 3


def head_sd(seed, n=HEADS, tsd=None):
    """Medusa heads as a checkpoint holds them; with ``tsd``, zero residual
    blocks and the target's lm head: each head proposes the target's
    prediction from the last hidden (the token just emitted)."""
    rng = np.random.RandomState(seed)
    H, V = HF["hidden_size"], HF["vocab_size"]
    sd = {}
    for i in range(n):
        sd[f"medusa_head.{i}.0.linear.weight"] = (rng.randn(H, H) * 0.05).astype(np.float32)
        sd[f"medusa_head.{i}.0.linear.bias"] = (rng.randn(H) * 0.05).astype(np.float32)
        sd[f"medusa_head.{i}.1.weight"] = (rng.randn(V, H) * 0.05).astype(np.float32)
        if tsd is not None:
            sd[f"medusa_head.{i}.0.linear.weight"][:] = 0
            sd[f"medusa_head.{i}.0.linear.bias"][:] = 0
            sd[f"medusa_head.{i}.1.weight"] = tsd["lm_head.weight"]
    return sd


def medusa_cfg(pkg, **kw):
    tc = dict(medusa_speculation_length=K, num_medusa_heads=HEADS, **kw)
    return jax_cfg(**tc) if pkg == "jax" else port_cfg(**tc)


@pytest.fixture(scope="module")
def tsd():
    torch.set_num_threads(1)
    return target_sd(0)


@pytest.fixture(scope="module")
def plain(tsd):
    return ModelForCausalLM(None, port_cfg()).load(state_dict=tsd).generate(PROMPTS, MASK, max_new_tokens=12).sequences


@pytest.mark.parametrize("correlated", [False, True], ids=["random_heads", "target_lm_heads"])
def test_medusa_greedy_matches_jax_and_plain_generate(correlated, tsd, plain):
    heads = head_sd(4, tsd=tsd if correlated else None)
    japp = TpuMedusaModelForCausalLM(None, medusa_cfg("jax")).load(state_dict=tsd, medusa_head_state_dict=heads)
    app = MedusaModelForCausalLM(None, medusa_cfg("port")).load(state_dict=tsd, medusa_head_state_dict=heads)
    jout, jcounts = jax_rounds(japp, PROMPTS, MASK, max_new_tokens=12)
    out, counts = port_rounds(app, PROMPTS, MASK, max_new_tokens=12)
    np.testing.assert_array_equal(out.sequences, np.asarray(jout.sequences))
    np.testing.assert_array_equal(out.sequences, plain)
    assert [c.tolist() for c in counts] == [c.tolist() for c in jcounts]
    if correlated:
        assert max(int(c.max()) for c in counts) > 1
    for stream in ("k", "v"):
        np.testing.assert_allclose(getattr(app.kv_cache, stream).numpy(), np.asarray(getattr(japp.kv_cache, stream)),
                                   rtol=0, atol=STATE_ATOL)
    np.testing.assert_allclose(app.hidden_buffer.numpy(), np.asarray(japp.hidden_buffer), rtol=0, atol=STATE_ATOL)


def test_medusa_head_logits_and_params_from_jax(tsd):
    """The JAX app's heads through params_from_jax equal the port's
    conversion of the same checkpoint (stacked by head); each head's logits
    on the same hidden within 1e-5 of JAX's (fp32)."""
    import jax.numpy as jnp
    from neuronx_distributed_inference_tpu.modules.medusa import medusa_head_logits as jax_head
    from neuronx_distributed_inference_tpu_torch.modules.medusa import medusa_head_logits

    heads = head_sd(5)
    japp = TpuMedusaModelForCausalLM(None, medusa_cfg("jax")).load(state_dict=tsd, medusa_head_state_dict=heads)
    app = MedusaModelForCausalLM(None, medusa_cfg("port")).load(state_dict=tsd, medusa_head_state_dict=heads)
    jheads = jax.device_get(japp.params["medusa_heads"])
    got = params_from_jax(jheads, torch.float32, "cpu")
    want = app._convert_medusa_heads(heads)
    for path in (("res", "weight"), ("res", "bias"), ("lm_head", "weight")):
        assert torch.equal(got[path[0]][path[1]], want[path[0]][path[1]]), path
    assert want["lm_head"]["weight"].shape == (HEADS, 256, 128)
    h = np.random.RandomState(6).randn(2, 256).astype(np.float32)
    for i in range(HEADS):
        jl = jax_head(jax.tree.map(lambda a: a[i], japp.params["medusa_heads"]), jnp.asarray(h))
        tl = medusa_head_logits(app.params["medusa_heads"][i], torch.from_numpy(h))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-5)


def test_medusa_random_heads_generate_and_seal(plain):
    """Random weights and heads (seeded) build and generate; the tokens are
    the plain greedy generate()'s of the same random target; a generate()
    of the warmed shapes builds nothing after seal()."""
    app = MedusaModelForCausalLM(None, medusa_cfg("port")).load(random_weights=True)
    ref = ModelForCausalLM(None, port_cfg()).load(random_weights=True)
    first = app.generate(PROMPTS, MASK, max_new_tokens=12).sequences
    np.testing.assert_array_equal(first, ref.generate(PROMPTS, MASK, max_new_tokens=12).sequences)
    assert app.params["medusa_heads"][0]["lm_head"]["weight"].shape == (256, 128)
    app.seal()
    with RetraceGuard() as guard:
        again = app.generate(PROMPTS, MASK, max_new_tokens=12).sequences
    assert guard.traces == [] and (again == first).all()


def test_medusa_checkpoint_head_conversion(tsd):
    """Heads stored without a prefix and under ``medusa_heads.`` load too;
    a missing head raises KeyError."""
    heads = head_sd(7, n=2)
    cfg = dict(medusa_speculation_length=3, num_medusa_heads=2)
    for prefix in ("", "medusa_heads."):
        sd = {prefix + k[len("medusa_head."):]: v for k, v in heads.items()}
        app = MedusaModelForCausalLM(None, port_cfg(**cfg)).load(state_dict=tsd, medusa_head_state_dict=sd)
        ref = ModelForCausalLM(None, port_cfg()).load(state_dict=tsd).generate(PROMPTS, MASK, max_new_tokens=6)
        np.testing.assert_array_equal(app.generate(PROMPTS, MASK, max_new_tokens=6).sequences, ref.sequences)
    with pytest.raises(KeyError, match="medusa head"):
        MedusaModelForCausalLM(None, port_cfg(**cfg)).load(state_dict=tsd, medusa_head_state_dict={})


@pytest.mark.parametrize(
    "kw, exc, match",
    [
        (dict(medusa_speculation_length=5, num_medusa_heads=2), ValueError, "num_medusa_heads"),
        (dict(medusa_speculation_length=1, num_medusa_heads=2), ValueError, ">= 2"),
        (dict(medusa_speculation_length=3, num_medusa_heads=2, on_device_sampling_config={"do_sample": True}),
         NotImplementedError, "greedy-only"),
        (dict(medusa_speculation_length=3, num_medusa_heads=2, is_block_kv_layout=True), NotImplementedError,
         "paged cache"),
    ],
    ids=["too_few_heads", "short", "sampling", "paged"],
)
def test_medusa_unsupported_combos_raise(kw, exc, match):
    with pytest.raises(exc, match=match):
        MedusaModelForCausalLM(None, port_cfg(**kw))


def test_medusa_refuses_custom_layers(monkeypatch):
    from neuronx_distributed_inference_tpu_torch.models.llama import LlamaModelBuilder

    monkeypatch.setattr(LlamaModelBuilder, "layer_fn", lambda self: (lambda *a: None))
    with pytest.raises(NotImplementedError, match="custom decoder layers"):
        MedusaModelForCausalLM(None, port_cfg(medusa_speculation_length=3, num_medusa_heads=2))
