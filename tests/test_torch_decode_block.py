"""The fused decode blocks of the port (``ops/decode_block.py``: B8, the
attention block, and B9, the MLP block) on the CPU, where their wrappers
take the plain versions: against the JAX package's Pallas kernels in
interpret mode on the same numpy inputs (the sizes of
tests/test_decode_block.py: H 512, 8 q / 2 kv heads, D 64, 3 layers, bucket
512, I 768), and against the port's own unfused layer.

Tolerances in fp32: 2e-5 for B8 (the reference's own pin of the kernel
against the unfused layer) and atol 1e-4 / rtol 1e-3 for B9 (the Pallas
kernel sums the down product over I tiles, in another order). In bf16 both
sides round at the same places, so they differ where an fp32 sum taken in
another order lands on the other side of a bf16 rounding step: at most a
few bf16 steps of the output (2^-8 relative), held at atol and rtol 2^-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuronx_distributed_inference_tpu.modules.kvcache import update_cache_at_layer as jax_update_cache
from neuronx_distributed_inference_tpu.modules.rope import default_inv_freq as jax_inv_freq
from neuronx_distributed_inference_tpu.modules.rope import rope_cos_sin as jax_rope_cos_sin
from neuronx_distributed_inference_tpu.ops import decode_block as jdb
from neuronx_distributed_inference_tpu_torch.modules.attention import (
    AttnSpec,
    attention_decode,
    o_project,
    qkv_project,
)
from neuronx_distributed_inference_tpu_torch.modules.kvcache import read_cache_at_layer, update_cache_at_layer
from neuronx_distributed_inference_tpu_torch.modules.norm import rms_norm
from neuronx_distributed_inference_tpu_torch.models.base import ModelSpec, gated_mlp
from neuronx_distributed_inference_tpu_torch.ops import _cuda
from neuronx_distributed_inference_tpu_torch.ops import decode_block as tdb

B, Hq, Hkv, D, H = 2, 8, 2, 64, 512
L, S_MAX, BUCKET, I = 3, 1024, 512, 768
EPS = 1e-5
ATTN_ATOL = 2e-5
BF16_TOL = 2.0 ** -6


def _rand(rng, *shape):
    return (rng.randn(*shape) * 0.15).astype(np.float32)


def _attn_inputs(K, seed=7, starts=(37, 5)):
    """Numpy inputs of one B8 call: history in every cache line, rows at
    positions ``starts``, the decode mask over the bucket (the prior
    positions and this step's slots)."""
    rng = np.random.RandomState(seed + K)
    positions = np.stack([np.arange(p, p + K) for p in starts]).astype(np.int32)
    mask = np.zeros((B, 1, K, BUCKET), bool)
    cols = np.arange(BUCKET)
    for b, p in enumerate(starts):
        for t in range(K):
            mask[b, 0, t] = cols <= p + t
    cos, sin = jax_rope_cos_sin(jnp.asarray(positions), jax_inv_freq(D), 1.0)
    return dict(
        x=_rand(rng, B, K, H), gamma=(1.0 + 0.1 * rng.randn(H)).astype(np.float32),
        wqkv=_rand(rng, H, (Hq + 2 * Hkv) * D), wout=_rand(rng, Hq * D, H),
        cos=np.asarray(cos), sin=np.asarray(sin),
        k_cache=_rand(rng, L, B + 1, S_MAX, Hkv, D), v_cache=_rand(rng, L, B + 1, S_MAX, Hkv, D),
        layer_idx=1, slot_ids=np.arange(B, dtype=np.int32), mask=mask, positions=positions,
    )


_ORDER = ("x", "gamma", "wqkv", "wout", "cos", "sin", "k_cache", "v_cache", "layer_idx", "slot_ids", "mask",
          "positions")
_FLOATS = ("x", "gamma", "wqkv", "wout", "k_cache", "v_cache")


def _jax_attn(inp, dtype=jnp.float32):
    args = [
        jnp.asarray(inp[k], dtype) if k in _FLOATS else (jnp.int32(inp[k]) if k == "layer_idx" else jnp.asarray(inp[k]))
        for k in _ORDER
    ]
    return jdb.fused_attn_block(*args, scale=D ** -0.5, eps=EPS, n_kv=Hkv, interpret=True)


def _port_attn(inp, dtype=torch.float32):
    args = [
        torch.from_numpy(np.array(inp[k])).to(dtype) if k in _FLOATS
        else (inp[k] if k == "layer_idx" else torch.from_numpy(np.array(inp[k])))
        for k in _ORDER
    ]
    return args, tdb.fused_attn_block(*args, scale=D ** -0.5, eps=EPS, n_kv=Hkv)


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


@pytest.mark.parametrize("K", [1, 4])
def test_fused_attn_block_plain_matches_jax_kernel(K):
    """Hidden, k_new, v_new and the cache after the scatter, fp32."""
    inp = _attn_inputs(K)
    j_out, j_k, j_v = _jax_attn(inp)
    args, (out, k_new, v_new) = _port_attn(inp)
    for got, want in ((out, j_out), (k_new, j_k), (v_new, j_v)):
        np.testing.assert_allclose(_np(got), _np(want), atol=ATTN_ATOL, rtol=ATTN_ATOL)
    j_kc, j_vc = jax_update_cache(
        jnp.asarray(inp["k_cache"]), jnp.asarray(inp["v_cache"]), j_k, j_v, jnp.int32(1),
        jnp.asarray(inp["slot_ids"]), jnp.asarray(inp["positions"]),
    )
    kc, vc = update_cache_at_layer(args[6], args[7], k_new, v_new, 1, args[9], args[11])
    np.testing.assert_allclose(_np(kc), _np(j_kc), atol=ATTN_ATOL, rtol=ATTN_ATOL)
    np.testing.assert_allclose(_np(vc), _np(j_vc), atol=ATTN_ATOL, rtol=ATTN_ATOL)
    assert _cuda.launch_counts()[tdb.ATTN_KERNEL] == 0


def test_fused_attn_block_garbage_row_matches_jax_kernel():
    """A row on the garbage line with an all-false prior mask attends only
    its own new token: finite, and equal to the JAX kernel's."""
    inp = _attn_inputs(1, seed=3, starts=(10, 0))
    inp["k_cache"][:] = 0
    inp["v_cache"][:] = 0
    inp["layer_idx"] = 0
    inp["slot_ids"] = np.array([0, B], np.int32)
    inp["mask"][1] = False
    j_out, j_k, j_v = _jax_attn(inp)
    _, (out, k_new, v_new) = _port_attn(inp)
    assert torch.isfinite(out).all()
    for got, want in ((out, j_out), (k_new, j_k), (v_new, j_v)):
        np.testing.assert_allclose(_np(got), _np(want), atol=ATTN_ATOL, rtol=ATTN_ATOL)


@pytest.mark.parametrize("K", [1, 4])
def test_fused_attn_block_plain_matches_jax_kernel_bf16(K):
    inp = _attn_inputs(K, seed=9)
    j_out, j_k, j_v = _jax_attn(inp, jnp.bfloat16)
    _, (out, k_new, v_new) = _port_attn(inp, torch.bfloat16)
    assert out.dtype == k_new.dtype == torch.bfloat16
    for got, want in ((out, j_out), (k_new, j_k), (v_new, j_v)):
        np.testing.assert_allclose(_np(got), _np(want), atol=BF16_TOL, rtol=BF16_TOL)


@pytest.mark.parametrize("K", [1, 4])
def test_fused_attn_block_plain_matches_unfused_layer(K):
    """The port's unfused attention half (rmsnorm, QKV, RoPE, the scatter,
    the masked softmax over the bucket, o-proj, residual) on the same
    inputs, fp32."""
    inp = _attn_inputs(K, seed=5)
    args, (out, k_new, v_new) = _port_attn(inp)
    x, gamma, wqkv, wout, cos, sin, kc, vc, li, slots, mask, pos = args
    spec = AttnSpec(num_heads=Hq, num_kv_heads=Hkv, head_dim=D)
    params = {"qkv_proj": {"weight": wqkv}, "o_proj": {"weight": wout}}
    q, k, v = qkv_project(params, rms_norm(x, gamma, EPS), cos, sin, spec)
    kc2, vc2 = update_cache_at_layer(kc.clone(), vc.clone(), k, v, li, slots, pos)
    k_r, v_r = read_cache_at_layer(kc2, vc2, li, B, BUCKET)
    ref = x + o_project(params, attention_decode(q, k_r, v_r, mask, spec))
    np.testing.assert_allclose(_np(out), _np(ref), atol=ATTN_ATOL, rtol=ATTN_ATOL)
    np.testing.assert_allclose(_np(k_new), _np(k), atol=ATTN_ATOL, rtol=ATTN_ATOL)
    np.testing.assert_allclose(_np(v_new), _np(v), atol=ATTN_ATOL, rtol=ATTN_ATOL)


def _mlp_inputs(K, seed=11):
    rng = np.random.RandomState(seed + K)
    return (_rand(rng, B, K, H), (1.0 + 0.1 * rng.randn(H)).astype(np.float32), _rand(rng, H, I),
            _rand(rng, H, I), _rand(rng, I, H))


@pytest.mark.parametrize("K", [1, 4])
@pytest.mark.parametrize("act", ["silu", "gelu_pytorch_tanh"])
def test_fused_mlp_block_plain_matches_jax_kernel(act, K):
    inp = _mlp_inputs(K)
    want = jdb.fused_mlp_block(*map(jnp.asarray, inp), eps=EPS, act=act, interpret=True)
    got = tdb.fused_mlp_block(*map(torch.from_numpy, inp), eps=EPS, act=act)
    # the Pallas kernel sums the down product over I tiles: another order
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-4, rtol=1e-3)
    assert _cuda.launch_counts()[tdb.MLP_KERNEL] == 0


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_fused_mlp_block_plain_matches_jax_kernel_bf16(act):
    inp = _mlp_inputs(1, seed=13)
    want = jdb.fused_mlp_block(*(jnp.asarray(a, jnp.bfloat16) for a in inp), eps=EPS, act=act, interpret=True)
    got = tdb.fused_mlp_block(*(torch.from_numpy(a).to(torch.bfloat16) for a in inp), eps=EPS, act=act)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), atol=BF16_TOL, rtol=BF16_TOL)


@pytest.mark.parametrize("act", ["silu", "gelu_pytorch_tanh"])
def test_fused_mlp_block_plain_matches_unfused_layer(act):
    """The port's unfused MLP half (rmsnorm, gated_mlp, residual), fp32."""
    x, gamma, wg, wu, wd = map(torch.from_numpy, _mlp_inputs(4, seed=17))
    spec = ModelSpec(num_layers=1, vocab_size=8, attn=AttnSpec(num_heads=Hq, num_kv_heads=Hkv, head_dim=D),
                     rms_eps=EPS, act=act)
    mlp = {"gate_proj": {"weight": wg}, "up_proj": {"weight": wu}, "down_proj": {"weight": wd}}
    ref = x + gated_mlp(mlp, rms_norm(x, gamma, EPS), spec)
    got = tdb.fused_mlp_block(x, gamma, wg, wu, wd, eps=EPS, act=act)
    np.testing.assert_allclose(_np(got), _np(ref), atol=1e-4, rtol=1e-3)


@pytest.mark.parametrize(
    "change, match",
    [
        (dict(head_dim=32), "head_dim 32"),  # the kernel takes 64 and 128
        (dict(K=17), "17 new tokens"),
        (dict(K=16, gqa=8), "n_rep \\* K"),  # 8:1 at K = 16 is 128 query rows
        (dict(bucket=S_MAX + 32), "mask"),
    ],
)
def test_fused_attn_block_refuses_what_the_kernel_does_not_take(change, match):
    """On any device, as B1 and B2 do: the CPU run refuses what the card
    would."""
    d, K, gqa, bucket = change.get("head_dim", D), change.get("K", 1), change.get("gqa", 4), change.get("bucket", 64)
    hkv = 1
    hq = gqa * hkv
    z = torch.zeros
    with pytest.raises(ValueError, match=match):
        tdb.fused_attn_block(
            z(1, K, 16), z(16), z(16, (hq + 2 * hkv) * d), z(hq * d, 16), z(1, K, d // 2), z(1, K, d // 2),
            z(1, 2, S_MAX, hkv, d), z(1, 2, S_MAX, hkv, d), 0, torch.zeros(1, dtype=torch.int32),
            torch.ones(1, 1, K, bucket, dtype=torch.bool), torch.zeros(1, K, dtype=torch.int32),
            scale=1.0, eps=EPS, n_kv=hkv,
        )


def test_fused_mlp_block_refuses_an_activation_it_does_not_compute():
    z = torch.zeros
    with pytest.raises(ValueError, match="relu"):
        tdb.fused_mlp_block(z(1, 1, 8), z(8), z(8, 4), z(8, 4), z(4, 8), eps=EPS, act="relu")


@pytest.mark.parametrize(
    "n_cols, kdim, want",
    [
        (3072, 2048, (11, 192)),  # the 1B QKV product: 24 tiles of 128 columns
        (2048, 2048, (16, 128)),  # the 1B o-proj: 16 tiles, at most 16 splits
        (8192, 2048, (4, 512)),  # the 1B gate/up: 64 tiles x 4 splits, 256 blocks
        (2048, 8192, (16, 512)),  # the 1B down projection
        (14336, 4096, (2, 2048)),  # the 8B gate/up: 112 tiles
        (4096, 14336, (8, 1792)),  # the 8B down projection: 32 tiles
        (333, 512, (4, 128)),  # an odd width: 3 tiles, K / GEMV_MIN_K splits
        (64, 300, (2, 192)),  # a range rounded up to 64 leaves 2 splits of 3
        (64, 100, (1, 128)),  # too short a K to split
    ],
)
def test_gemv_split(n_cols, kdim, want):
    """The split of the fused layer's products (csrc/decode_gemv.cuh) at
    the timed shapes: about two blocks an SM over the column tiles, each
    split's range a multiple of 64 and at least 128, at most 16 splits,
    every split non-empty and every row of K in one; rows are not on the
    grid, so the split is the same at every row count."""
    splits, per = tdb.gemv_split(n_cols, kdim, sms=132)
    assert (splits, per) == want
    assert per % tdb.GEMV_K_ALIGN == 0 and 1 <= splits <= tdb.GEMV_MAX_SPLITS
    assert (splits - 1) * per < kdim <= splits * per
    tiles = -(-n_cols // tdb.GEMV_COLS)
    assert splits == 1 or tiles * splits <= tdb.GEMV_BLOCKS_PER_SM * 132


def test_mlp_plan_sizes_scratch_and_counters():
    """B9's scratch at the 1B MLP, batch 4: gate and up partials (2 x 4
    splits x 4 rows x 8192), act in bf16 (4 x 8192 x 2 bytes as fp32
    values), the down partials (16 splits x 4 rows x 2048); one counter per
    128 columns of I and of H."""
    gu, dn, sizes, n_counters = tdb.mlp_plan(2048, 8192, 4, 2, sms=132)
    assert (gu, dn) == ((4, 512), (16, 512))
    assert sizes == (2 * 4 * 4 * 8192, 4 * 8192 // 2, 16 * 4 * 2048)
    assert n_counters == 8192 // 128 + 2048 // 128
    assert all(n % 4 == 0 for n in tdb.mlp_plan(1000, 333, 3, 2, sms=132)[2])  # 16-byte slices


@pytest.mark.parametrize(
    "S_kv, blocks, want",
    [(512, 8, (8, 1)), (512, 32, (8, 1)), (1024, 32, (16, 1)), (100, 8, (2, 1)), (512, 256, (2, 4)),
     (2048, 8, (32, 1)), (4096, 8, (32, 2)), (512, 1024, (1, 8))],
)
def test_kv_split(S_kv, blocks, want):
    """Tiles of 64 positions, one a split while the grid stays within 4
    blocks an SM (the 1B layer at batch 1 and 4: 8 splits), at most 32
    splits; every split non-empty."""
    splits, per = tdb.kv_split(S_kv, blocks, sms=132)
    assert (splits, per) == want
    n_tiles = -(-S_kv // tdb.ATTN_TILE)
    assert (splits - 1) * per < n_tiles <= splits * per


H100_SMS = 132


@pytest.mark.parametrize(
    "S_kv, blocks", [(512, 8), (512, 32), (1024, 32), (100, 8), (512, 256), (2048, 8), (4096, 4)]
)
def test_kv_plan_covers_the_mask_in_tiles(S_kv, blocks):
    """The attention launch's split in positions: kv_split's tiles of 64,
    a multiple of 16, every position in one split, no split empty."""
    splits, per = tdb._kv_plan(S_kv, blocks, sms=H100_SMS)
    assert (splits, per // tdb.ATTN_TILE) == tdb.kv_split(S_kv, blocks, sms=H100_SMS)
    assert per % 16 == 0 and splits <= tdb.MAX_KV_SPLITS
    assert (splits - 1) * per < S_kv <= splits * per


def _attn_split_model(inp):
    """B8's attention launch in PyTorch, fp32: the q rows and the new k / v
    from the normed input's QKV product with RoPE; split z of _kv_plan's
    splits scores the prior positions [z per, (z + 1) per) under the prior
    mask, and split 0 also the row's new tokens (causal); each split's
    (m, l, acc), combined in split order (M = max m_z, weights e^(m_z - M)),
    out = num / max(den, 1e-30); then x + attn @ Wout. Returns (out,
    splits)."""
    t = {k: torch.from_numpy(np.array(v)) if k != "layer_idx" else v for k, v in inp.items()}
    x, wqkv, wout = t["x"], t["wqkv"], t["wout"]
    Bq, K, _ = x.shape
    S = t["mask"].shape[-1]
    n_rep = Hq // Hkv
    normed = tdb._rms(x, t["gamma"], EPS)
    qkv = normed @ wqkv
    q = tdb._rope(qkv[..., : Hq * D].reshape(Bq, K, Hq, D), t["cos"], t["sin"])
    k = tdb._rope(qkv[..., Hq * D : (Hq + Hkv) * D].reshape(Bq, K, Hkv, D), t["cos"], t["sin"])
    v = qkv[..., (Hq + Hkv) * D :].reshape(Bq, K, Hkv, D)
    lines = t["slot_ids"].long()
    kp = t["k_cache"][t["layer_idx"]][lines, :S].repeat_interleave(n_rep, dim=2)  # (B, S, Hq, D)
    vp = t["v_cache"][t["layer_idx"]][lines, :S].repeat_interleave(n_rep, dim=2)
    kn, vn = k.repeat_interleave(n_rep, dim=2), v.repeat_interleave(n_rep, dim=2)
    prior = tdb.prior_mask(t["mask"], t["positions"])[:, 0][:, None]  # (B, 1, K, S)
    causal = torch.ones(K, K, dtype=torch.bool).tril()[None, None]
    s_pri = torch.einsum("bthd,bshd->bhts", q, kp) * (D ** -0.5)
    s_act = torch.einsum("bthd,bshd->bhts", q, kn) * (D ** -0.5)
    splits, per = tdb._kv_plan(S, Bq * Hkv, H100_SMS)
    parts = []
    for z in range(splits):
        sl = slice(z * per, min((z + 1) * per, S))
        sc, ok, vals = s_pri[..., sl], prior[..., sl].expand_as(s_pri[..., sl]), vp[:, sl]
        if z == 0:
            sc = torch.cat([s_act, sc], dim=-1)
            ok = torch.cat([causal.expand_as(s_act), ok], dim=-1)
            vals = torch.cat([vn, vals], dim=1)
        sz = torch.where(ok, sc, tdb.NEG_INF)
        mz = sz.amax(dim=-1)
        pz = torch.where(ok, torch.exp(sz - mz[..., None]), 0.0)
        parts.append((mz, pz.sum(dim=-1), torch.einsum("bhts,bshd->bhtd", pz, vals)))
    M = torch.stack([mz for mz, _, _ in parts]).amax(dim=0)
    den = torch.zeros_like(M)
    num = torch.zeros_like(parts[0][2])
    for mz, lz, az in parts:  # split order
        w = torch.exp(mz - M)
        den = den + lz * w
        num = num + az * w[..., None]
    attn = (num / torch.clamp(den, min=1e-30)[..., None]).permute(0, 2, 1, 3).reshape(Bq, K, Hq * D)
    return x + attn @ wout, splits


@pytest.mark.parametrize("K", [1, 4])
def test_attn_split_algorithm_matches_jax_kernel(K):
    """B8's split-and-combine algorithm (_attn_split_model: the prior cache
    over _kv_plan's splits, the active part in split 0) against the JAX
    kernel in interpret mode, rows deep enough to span several splits:
    fp32 within 2e-5 plus 1e-5 of |out| (outputs reach ~15 here, and the
    split sums run in another order than the kernel's sequential grid)."""
    inp = _attn_inputs(K, seed=29, starts=(300, 70))
    ref = _np(_jax_attn(inp)[0])
    out, splits = _attn_split_model(inp)
    assert splits > 1
    np.testing.assert_allclose(out.numpy(), ref, atol=ATTN_ATOL, rtol=1e-5)


def _mlp_split_model(x, gamma, wg, wu, wd, act):
    """B9's algorithm in PyTorch, fp32 (csrc/fused_mlp_block.cu): the
    normed input; gate's and up's partial sums over gemv_split's splits of
    H, each added in split order from zero; the activation of the two sums;
    the down product's partial sums over the splits of I, added in split
    order from zero; then x plus that sum. Returns (out, gate/up splits,
    down splits)."""
    H, I = wg.shape
    (s_gu, k_gu), (s_d, k_d) = tdb.gemv_split(I, H, H100_SMS), tdb.gemv_split(H, I, H100_SMS)
    n = tdb._rms(x, gamma, EPS)
    g = u = torch.zeros(x.shape[:-1] + (I,))
    for z in range(s_gu):
        sl = slice(z * k_gu, min((z + 1) * k_gu, H))
        g = g + n[..., sl] @ wg[sl]
        u = u + n[..., sl] @ wu[sl]
    a = tdb._act(act)(g) * u
    d = torch.zeros_like(x)
    for z in range(s_d):
        sl = slice(z * k_d, min((z + 1) * k_d, I))
        d = d + a[..., sl] @ wd[sl]
    return x + d, s_gu, s_d


@pytest.mark.parametrize("K", [1, 4])
@pytest.mark.parametrize("act", ["silu", "gelu_pytorch_tanh"])
def test_mlp_split_algorithm_matches_jax_kernel(act, K):
    """B9's split algorithm (_mlp_split_model: gate and up summed over the
    splits of H, the activation, down summed over the splits of I, the
    residual) against the JAX kernel in interpret mode, fp32: within 2e-5
    plus 1e-5 of each output's magnitude |x| + |act(g) u| @ |Wd|, the sum of
    the absolute terms behind it (the splits' sums run in another order
    than the kernel's sequential grid over I tiles, and their rounding
    scales with the terms, not with an output they cancel to; outputs reach
    ~60 here)."""
    inp = _mlp_inputs(K, seed=31)
    want = _np(jdb.fused_mlp_block(*map(jnp.asarray, inp), eps=EPS, act=act, interpret=True))
    x, gamma, wg, wu, wd = map(torch.from_numpy, inp)
    out, s_gu, s_d = _mlp_split_model(x, gamma, wg, wu, wd, act)
    assert s_gu > 1 and s_d > 1
    mag = x.abs() + tdb.glu_rows_plain(x, gamma, wg, wu, eps=EPS, act=act).abs() @ wd.abs()
    err = np.abs(out.numpy() - want)
    assert (err <= ATTN_ATOL + 1e-5 * mag.numpy()).all(), err.max()
