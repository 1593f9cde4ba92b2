"""Kernel B2's plain version (the port's ``flash_attention_plain``) against
the JAX package's Pallas flash kernels run in interpret mode on the CPU:
the unpacked ``_flash_kernel`` and the head-pair packed
``_flash_kernel_packed`` (both softmax modes), ``(m, l)`` included, plus the
sink fold through both wrappers.

Tolerances: fp32 atol 2e-5 on rows with at least one valid key (rows with
none are garbage in both). The CUDA kernel's bf16 instance rounds the
probabilities to bf16 for the P.V product: a test-local plain flash that
does the same is held within the card check's bf16 tolerance (1.5e-2) of
``flash_attention_plain`` at the timed shapes. The packed bf16-softmax mode rounds the exp
input, the probabilities and the PV operand to bf16 in both; the sums run
in other orders, so out within atol 2e-3 and l within rtol 1e-2."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuronx_distributed_inference_tpu.modules.attention import AttnSpec as JaxAttnSpec
from neuronx_distributed_inference_tpu.modules.attention import repeat_kv as jax_repeat_kv
from neuronx_distributed_inference_tpu.ops import flash_attention as jfa
from neuronx_distributed_inference_tpu_torch.modules.attention import AttnSpec
from neuronx_distributed_inference_tpu_torch.ops import _cuda
from neuronx_distributed_inference_tpu_torch.ops import flash_attention as tfa

B, S, HKV = 2, 256, 2


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _inputs(seed, n_rep, D):
    rng = np.random.RandomState(seed)
    q = (rng.randn(B, S, HKV * n_rep, D) * 0.3).astype(np.float32)
    k = (rng.randn(B, S, HKV, D) * 0.3).astype(np.float32)
    v = (rng.randn(B, S, HKV, D) * 0.3).astype(np.float32)
    key_valid = np.zeros((B, S), np.int32)
    key_valid[0, :200] = 1
    key_valid[1, :77] = 1
    return q, k, v, key_valid


def _jax(q, k, v, key_valid, n_rep, **kw):
    """JAX kernel in interpret mode on (B, H, S, D) with repeated K/V; back
    to the port's (B, S, H, D) out and (B, H, S) stats."""
    qt = jnp.swapaxes(jnp.asarray(q), 1, 2)
    kt = jnp.swapaxes(jax_repeat_kv(jnp.asarray(k), n_rep), 1, 2)
    vt = jnp.swapaxes(jax_repeat_kv(jnp.asarray(v), n_rep), 1, 2)
    out, m, l = jfa.flash_attention_bhsd(qt, kt, vt, jnp.asarray(key_valid), interpret=True, **kw)
    return np.swapaxes(np.asarray(out), 1, 2), np.asarray(m)[..., 0], np.asarray(l)[..., 0]


def _valid_rows(key_valid, window=None, chunk=None):
    mask = tfa.prefill_mask(torch.from_numpy(key_valid), True, window, chunk)
    return mask[:, 0].any(dim=-1).numpy()  # (B, S)


def _compare(port, ref, rows, atol, l_rtol):
    out, m, l = (x.numpy() if isinstance(x, torch.Tensor) else x for x in port)
    r_out, r_m, r_l = ref
    np.testing.assert_allclose(out[rows], r_out[rows], atol=atol, rtol=0)
    mt, lt = np.swapaxes(m, 1, 2), np.swapaxes(l, 1, 2)  # (B, S, H)
    np.testing.assert_allclose(mt[rows], np.swapaxes(r_m, 1, 2)[rows], atol=2e-5, rtol=0)
    np.testing.assert_allclose(lt[rows], np.swapaxes(r_l, 1, 2)[rows], rtol=l_rtol, atol=0)


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize(
    "flavor", [{}, {"window": 64}, {"chunk": 64}], ids=["causal", "window", "chunk"]
)
@pytest.mark.parametrize("n_rep", [1, 2])
def test_plain_matches_unpacked_kernel(D, flavor, n_rep):
    q, k, v, key_valid = _inputs(0, n_rep, D)
    scale = D**-0.5
    ref = _jax(q, k, v, key_valid, n_rep, scale=scale, causal=True, **flavor)
    port = tfa.flash_attention_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(key_valid),
        scale=scale, causal=True, **flavor,
    )
    _compare(port, ref, _valid_rows(key_valid, **flavor), 2e-5, 1e-5)


@pytest.mark.parametrize("softmax_bf16", [False, True])
@pytest.mark.parametrize("flavor", [{}, {"window": 64}], ids=["causal", "window"])
def test_plain_matches_packed_kernel(softmax_bf16, flavor):
    """D=64: the head-pair packed TPU kernel, which the port's D=64 kernel
    instance replaces (an odd head count exercises its padding)."""
    D = 64
    rng = np.random.RandomState(1)
    q, k, v = ((rng.randn(B, S, 3, D) * 0.3).astype(np.float32) for _ in range(3))
    key_valid = _inputs(1, 1, D)[3]
    scale = D**-0.5
    ref = _jax(q, k, v, key_valid, 1, scale=scale, causal=True, packed=True,
               softmax_bf16=softmax_bf16, **flavor)
    port = tfa.flash_attention_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(key_valid),
        scale=scale, causal=True, softmax_bf16=softmax_bf16, **flavor,
    )
    atol, l_rtol = (2e-3, 1e-2) if softmax_bf16 else (2e-5, 1e-5)
    _compare(port, ref, _valid_rows(key_valid, **flavor), atol, l_rtol)


def test_sink_through_wrappers():
    n_rep, D = 2, 64
    q, k, v, key_valid = _inputs(2, n_rep, D)
    sink = np.random.RandomState(5).randn(HKV * n_rep).astype(np.float32)
    jspec = JaxAttnSpec(num_heads=HKV * n_rep, num_kv_heads=HKV, head_dim=D, has_sink=True)
    ref = jfa.flash_attention(
        jnp.asarray(q), jax_repeat_kv(jnp.asarray(k), n_rep), jax_repeat_kv(jnp.asarray(v), n_rep),
        jnp.asarray(key_valid), jspec, sink=jnp.asarray(sink),
    )
    spec = AttnSpec(num_heads=HKV * n_rep, num_kv_heads=HKV, head_dim=D, has_sink=True)
    _cuda.reset_launch_counts()
    out = tfa.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(key_valid),
        spec, sink=torch.from_numpy(sink),
    )
    assert _cuda.launch_counts()["flash_attention"] == 0  # CPU tensors: plain version
    rows = _valid_rows(key_valid)
    np.testing.assert_allclose(out.numpy()[rows], np.asarray(ref)[rows], atol=2e-5, rtol=0)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    q, k, v, key_valid = (torch.from_numpy(a) for a in _inputs(3, 1, 64))
    with pytest.raises(ValueError, match="head_dim"):
        tfa.flash_attention_fwd(q[..., :48], k[..., :48], v[..., :48], key_valid, scale=1.0)
    with pytest.raises(ValueError, match="q heads"):
        tfa.flash_attention_fwd(q[:, :, :1].repeat(1, 1, 3, 1), k, v, key_valid, scale=1.0)
    with pytest.raises(ValueError, match="dtypes"):
        tfa.flash_attention_fwd(q.half(), k.half(), v.half(), key_valid, scale=1.0)


def _plain_bf16_p(q, k, v, key_valid, scale):
    """flash_attention_plain (causal) with the probabilities rounded to
    bf16 before P.V, as the kernel's tensor-core product takes them; l sums
    them in fp32 before the rounding."""
    n_rep = q.shape[2] // k.shape[2]
    kf = k.float().repeat_interleave(n_rep, dim=2)
    vf = v.float().repeat_interleave(n_rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * scale
    mask = tfa.prefill_mask(key_valid, True)
    s = torch.where(mask, s, torch.full_like(s, tfa.NEG_INF))
    p = torch.where(mask, torch.exp(s - s.amax(dim=-1, keepdim=True)), torch.zeros_like(s))
    l = p.sum(dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(torch.bfloat16).float(), vf)
    return (out / torch.clamp(l, min=1e-30).transpose(1, 2)[..., None]).to(q.dtype)


@pytest.mark.parametrize("D", [64, 128])
def test_bf16_probabilities_within_card_tolerance(D):
    """S = 512, causal, bf16 inputs of std 0.5 (chip_smoke's parity inputs),
    GQA 4:1, a right-padded row: one bf16 rounding of P moves the output by
    far less than the card check's 1.5e-2."""
    rng = np.random.RandomState(7 + D)
    Bs, Ss, Hkv, n_rep = 2, 512, 2, 4
    q, k, v = (
        torch.from_numpy(rng.randn(Bs, Ss, h, D).astype(np.float32) * 0.5).to(torch.bfloat16)
        for h in (Hkv * n_rep, Hkv, Hkv)
    )
    kv = np.ones((Bs, Ss), np.int32)
    kv[1, 300:] = 0
    key_valid = torch.from_numpy(kv)
    ref = tfa.flash_attention_plain(q, k, v, key_valid, scale=D**-0.5, causal=True)[0]
    out = _plain_bf16_p(q, k, v, key_valid, D**-0.5)
    rows = _valid_rows(kv)
    err = (out.float() - ref.float()).abs().amax(dim=(2, 3))[torch.from_numpy(rows)].max().item()
    assert err <= 1.5e-2, err


def test_launch_check_takes_only_what_the_async_copies_need():
    """The kernel's 16-byte copies: aligned bases, batch and token strides
    that are multiples of 8 elements (the fused QKV views of the port's
    models pass)."""
    qkv = torch.zeros(2, 16, (4 + 2 * 2) * 64, dtype=torch.bfloat16)
    q = qkv[..., : 4 * 64].unflatten(-1, (4, 64))
    k = qkv[..., 4 * 64 : 6 * 64].unflatten(-1, (2, 64))
    v = qkv[..., 6 * 64 :].unflatten(-1, (2, 64))
    tfa._check_launch(q, k, v)
    odd = torch.zeros(2 * 16 * 132 + 8, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiples of 8"):
        tfa._check_launch(odd.as_strided((2, 16, 2, 64), (16 * 132, 132, 64, 1)), k, v)
    with pytest.raises(ValueError, match="aligned"):
        tfa._check_launch(q, odd.as_strided((2, 16, 2, 64), (16 * 128, 128, 64, 1), 1), v)
