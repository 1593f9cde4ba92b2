"""The quantized KV cache of the port (``QuantizedKV``: int8/fp8 codes and
per-(layer, kv head) running-absmax scales) held against the JAX package on
the CPU, from numpy inputs made from a seed.

- Codes and scales from the same fp32 input are byte-identical (int8, fp8
  e4m3 and e5m2), rounding ties and non-finite values included.
- The scale update leaves out padded positions, the garbage line,
  garbage-block writes and non-finite elements (the reference's
  tests/test_kv_quant.py cases), and later writes never rescale earlier
  codes.
- The plain versions of B1 (q_len 1 and 4, with a sink), B4, B5 (prefix
  prior-KV) and B3 on code caches agree with the JAX kernels in interpret
  mode within 3e-5 at fp32, and so does the code mode's algorithm as the
  CUDA kernels run it (the K factor folded into q, raw codes, the V factor
  on the output).
- Configs, pool sizing, cache bytes, the fault fill and the roofline's code
  bytes.

The CUDA code modes themselves run only on a card (tests/test_torch_gpu.py,
chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuronx_distributed_inference_tpu.modules import block_kvcache as jbk
from neuronx_distributed_inference_tpu.modules import kvcache as jkv
from neuronx_distributed_inference_tpu.ops.decode_attention import (
    paged_tkg_decode_attention as jax_paged_decode,
)
from neuronx_distributed_inference_tpu.ops.decode_attention import tkg_decode_attention as jax_decode
from neuronx_distributed_inference_tpu.ops.paged_flash_attention import paged_flash_attention as jax_paged_flash
from neuronx_distributed_inference_tpu.ops.ragged_paged_attention import ragged_paged_attention as jax_ragged
from neuronx_distributed_inference_tpu_torch.config import Config
from neuronx_distributed_inference_tpu_torch.modules import block_kvcache as tbk
from neuronx_distributed_inference_tpu_torch.modules import kvcache as tkv
from neuronx_distributed_inference_tpu_torch.ops import _cuda, roofline
from neuronx_distributed_inference_tpu_torch.ops import decode_attention as tda
from neuronx_distributed_inference_tpu_torch.ops import paged_flash_attention as tpf
from neuronx_distributed_inference_tpu_torch.ops import ragged_paged_attention as trp
from neuronx_distributed_inference_tpu_torch.runtime.faults import fill_kv_rows

ATOL = RTOL = 3e-5
L, B, S_MAX, HQ, HKV, D = 3, 2, 256, 8, 2, 64
CODES = {
    "int8": (jnp.int8, torch.int8),
    "e4m3": (jnp.float8_e4m3fn, torch.float8_e4m3fn),
    "e5m2": (jnp.float8_e5m2, torch.float8_e5m2),
}


def _t(a):
    return torch.from_numpy(np.array(a))


def _bytes(x):
    """A code tensor's raw bytes (JAX or torch)."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.uint8).numpy() if x.element_size() == 1 else x.numpy()
    return np.asarray(x).view(np.uint8)


def _rand(rng, *shape):
    return (rng.randn(*shape) * 0.3).astype(np.float32)


def _both_caches(code, S=S_MAX):
    jdt, tdt = CODES[code]
    return jkv.init_cache(L, B, S, HKV, D, dtype=jdt), tkv.init_cache(L, B, S, HKV, D, dtype=tdt, device="cpu")


def _write_both(jc, tc, k_new, v_new, layer, slots, pos):
    jk, jv = jkv.update_cache_at_layer(
        jc.k, jc.v, jnp.asarray(k_new), jnp.asarray(v_new), jnp.int32(layer), jnp.asarray(slots), jnp.asarray(pos)
    )
    tkv.update_cache_at_layer(tc.k, tc.v, _t(k_new), _t(v_new), layer, _t(slots), _t(pos))
    return jkv.KVCache(k=jk, v=jv)


def _assert_same_codes(t, j):
    """Byte-identical codes; a NaN may differ in its payload (e5m2's cast
    gives 0x7F in torch, 0x7E in JAX: both NaN), so NaN positions must agree
    and every other code must match byte for byte."""
    tb, jb = _bytes(t), _bytes(j)
    if t.dtype in (torch.float8_e4m3fn, torch.float8_e5m2):
        tn, jn = torch.isnan(t.float()).numpy(), np.isnan(np.asarray(j, np.float32))
        np.testing.assert_array_equal(tn, jn)
        tb, jb = tb[~tn], jb[~jn]
    np.testing.assert_array_equal(tb, jb)


def _assert_same_stream(js, ts, lines=None):
    """Codes and scales of a port stream equal to a JAX stream's; ``lines``
    limits the codes to the real cache lines (the port writes out-of-range
    positions to the garbage line, which the reference drops)."""
    sl = (slice(None), slice(0, lines)) if lines else (slice(None),)
    _assert_same_codes(ts.data[sl], js.data[sl])
    np.testing.assert_array_equal(ts.scale.numpy(), np.asarray(js.scale))


# ---------------------------------------------------------------------------
# codes and scales
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("code", sorted(CODES))
def test_codes_and_scales_match_jax(code):
    """One write per layer from the same fp32 values: codes byte for byte,
    scales bit for bit. Layer 1's values hold the code type's qmax, so the
    factor qmax / scale is exactly 1 and the values listed land on rounding
    ties of the code type (half-integers for int8, midpoints of fp8
    neighbours), plus NaN and infinities (left out of the scale, clipped or
    cast in the codes)."""
    rng = np.random.RandomState(0)
    jc, tc = _both_caches(code)
    qmax = tkv.kv_qmax(CODES[code][1])
    ties = {"int8": [0.5, 1.5, -2.5, 126.5, -0.5], "e4m3": [1.0625, -1.0625, 17.0, 0.00146484375, 232.0],
            "e5m2": [1.125, -1.125, 2.5, 40960.0, -0.75]}[code]
    slots = np.arange(B, dtype=np.int32)
    pos = np.tile(np.arange(16, dtype=np.int32), (B, 1))
    for layer in range(L):
        k_new, v_new = _rand(rng, B, 16, HKV, D), _rand(rng, B, 16, HKV, D) * 5.0
        if layer == 1:
            k_new[0, 0, :, 0] = qmax
            k_new[0, 1, 0, : len(ties)] = ties
            k_new[1, 2, 1, : len(ties)] = ties
            v_new[0, 3, 0, :4] = [np.nan, np.inf, -np.inf, 1e30]
        jc = _write_both(jc, tc, k_new, v_new, layer, slots, pos)
    _assert_same_stream(jc.k, tc.k)
    _assert_same_stream(jc.v, tc.v)
    assert tc.k.scale[1].eq(qmax).all()
    # quantize_kv_codes alone, on a tensor of every tie and its neighbours
    x = np.concatenate([ties, np.nextafter(np.float32(ties), np.float32(np.inf)), [np.nan, 0.0]]).astype(np.float32)
    x = np.tile(x[None, :], (2, 1))[:, None, :]  # (2, H=1, D=n)
    s = np.full((1,), qmax, np.float32)
    _assert_same_codes(
        tkv.quantize_kv_codes(_t(x), _t(s), CODES[code][1]),
        jkv.quantize_kv_codes(jnp.asarray(x), jnp.asarray(s), CODES[code][0]),
    )


def test_dequantize_and_factors_match_jax():
    rng = np.random.RandomState(1)
    for code, (jdt, tdt) in CODES.items():
        x = _rand(rng, 4, 5, HKV, D)
        s = np.abs(x).max(axis=(0, 1, 3)).astype(np.float32)
        jcodes = jkv.quantize_kv_codes(jnp.asarray(x), jnp.asarray(s), jdt)
        tcodes = tkv.quantize_kv_codes(_t(x), _t(s), tdt)
        np.testing.assert_array_equal(
            tkv.dequantize_kv(tcodes, _t(s)).numpy(), np.asarray(jkv.dequantize_kv(jcodes, jnp.asarray(s)))
        )
        stream = tkv.QuantizedKV(tcodes, _t(s)[None].repeat(3, 1))
        jstream = jkv.QuantizedKV(jcodes, jnp.asarray(s)[None].repeat(3, axis=0))
        np.testing.assert_array_equal(
            tkv.layer_dequant_factors(stream, 2).numpy(), np.asarray(jkv.layer_dequant_factors(jstream, 2))
        )
        assert stream.shape == tcodes.shape and stream.dtype == tdt and stream.ndim == 4
    assert [tkv.kv_qmax(t) for _, t in CODES.values()] == [127.0, 448.0, 57344.0]
    assert tkv.is_kv_quant_dtype(torch.int8) and not tkv.is_kv_quant_dtype(torch.bfloat16)


@pytest.mark.parametrize("case", ["padded", "garbage_line", "non_finite", "garbage_block"])
def test_scale_update_leaves_out(case):
    """Writes that must not raise the scale (the reference's
    tests/test_kv_quant.py:110-215): pad-sentinel positions, a row routed to
    the garbage line with in-range positions, NaN / inf elements, and an
    idle paged row whose all-zero table maps into garbage block 0. The port
    and the JAX package give the same scale, at most the valid absmax."""
    rng = np.random.RandomState(7)
    x = _rand(rng, 2, 8, HKV, D)
    valid_amax = np.abs(x[0, :4]).max()
    if case == "garbage_block":
        NB, bs = 4, 16
        jb = jbk.init_block_cache(L, NB, bs, HKV, D, dtype=jnp.int8)
        tb = tbk.init_block_cache(L, NB, bs, HKV, D, dtype=torch.int8, device="cpu")
        bt = np.array([[2], [0]], np.int32)
        pos = np.zeros((2, 1), np.int32)
        sm = np.asarray(jbk.slot_mapping_from_block_table(jnp.asarray(bt), jnp.asarray(pos), bs))
        assert sm[1, 0] == 0 and np.array_equal(sm, tbk.slot_mapping_from_block_table(_t(bt), _t(pos), bs).numpy())
        new = x[:, :1].copy()
        new[1] *= 100.0
        valid_amax = np.abs(new[0]).max()
        jk, _ = jbk.update_block_cache_at_layer(jb.k, jb.v, jnp.asarray(new), jnp.asarray(new), jnp.int32(0),
                                                jnp.asarray(sm))
        tbk.update_block_cache_at_layer(tb.k, tb.v, _t(new), _t(new), 0, _t(sm))
        _assert_same_stream(jk, tb.k)
        assert tb.k.scale[0].max().item() <= valid_amax + 1e-6
        return
    jc, tc = jkv.init_cache(L, 2, S_MAX, HKV, D, dtype=jnp.int8), tkv.init_cache(L, 2, S_MAX, HKV, D, torch.int8,
                                                                                  device="cpu")
    slots = np.arange(2, dtype=np.int32)
    pos = np.tile(np.arange(8, dtype=np.int32), (2, 1))
    new = x.copy()
    if case == "padded":
        new[:, 4:] *= 100.0
        pos[:, 4:] = tkv.PAD_POSITION_SENTINEL
        new[1] = x[0]
    elif case == "garbage_line":
        new[1] *= 100.0
        slots[1] = 2  # rows + garbage: line 2 is the garbage line
        new[0, 4:] = x[0, :4]
    else:
        new[1] = x[0]
        new[0, 4:] = x[0, :4]
        new[0, 5, 0, 3] = np.nan
        new[1, 2, 1, 0] = np.inf
        new[1, 3, 0, 9] = -np.inf
    jc = _write_both(jc, tc, new, new, 0, slots, pos)
    _assert_same_stream(jc.k, tc.k, lines=2)
    assert tc.k.scale[0].max().item() <= valid_amax + 1e-6
    assert torch.isfinite(tc.k.scale).all()


def test_running_absmax_never_rescales_earlier_codes():
    rng = np.random.RandomState(1)
    _, tc = _both_caches("int8")
    slots = torch.arange(B, dtype=torch.int32)
    first = _t(_rand(rng, B, 16, HKV, D))
    tkv.update_cache_at_layer(tc.k, tc.v, first, first, 0, slots, torch.arange(16)[None].expand(B, 16))
    s0, codes0 = tc.k.scale[0].clone(), tc.k.data[0, :B, :16].clone()
    second = _t(_rand(rng, B, 4, HKV, D) * 10.0)
    tkv.update_cache_at_layer(tc.k, tc.v, second, second, 0, slots, 16 + torch.arange(4)[None].expand(B, 4))
    assert (tc.k.scale[0] >= s0).all() and tc.k.scale[0].max() > s0.max()
    assert torch.equal(tc.k.data[0, :B, :16], codes0)


def test_updates_stay_in_place():
    """A captured graph holds the codes' and the scales' addresses: writes
    and init_kv_cache's zeroing never rebind either."""
    _, tc = _both_caches("e4m3")
    ptrs = tkv.stream_ptrs(tc.k) + tkv.stream_ptrs(tc.v)
    new = torch.ones(B, 3, HKV, D)
    tkv.update_cache_at_layer(tc.k, tc.v, new, new, 2, torch.arange(B), torch.arange(3)[None].expand(B, 3))
    assert tc.k.scale[2].eq(1.0).all() and tc.k.data.float().abs().sum() > 0
    tkv.zero_stream(tc.k)
    tkv.zero_stream(tc.v)
    assert tkv.stream_ptrs(tc.k) + tkv.stream_ptrs(tc.v) == ptrs
    assert not tc.k.scale.any() and not tc.k.data.float().any()


# ---------------------------------------------------------------------------
# the plain versions of B1, B4, B5 and B3 against the JAX kernels
# ---------------------------------------------------------------------------


def _filled_contiguous(code, rng, S=100):
    jc, tc = _both_caches(code)
    k_new, v_new = _rand(rng, B, S, HKV, D), _rand(rng, B, S, HKV, D)
    slots = np.arange(B, dtype=np.int32)
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    for li in range(L):
        jc = _write_both(jc, tc, k_new, v_new, li, slots, pos)
    _assert_same_stream(jc.k, tc.k)
    return jc, tc


def _decode_mask(K, S, valid_len):
    pos = np.stack([np.arange(valid_len[b] - K, valid_len[b]) for b in range(len(valid_len))])
    return (np.arange(S)[None, None, :] <= pos[:, :, None])[:, None]


def _code_mode_decode(q, k_cache, v_cache, layer, mask, sink, n_kv, paged_table=None):
    """The code mode as the CUDA kernel computes it: attention over the raw
    codes converted to fp32 with each kv head's K factor scale / qmax on its
    scores (here folded into q, the same product), its V factor on the
    finalized output, one cast to q's dtype."""
    n_rep = q.shape[2] // n_kv
    ks = tkv.layer_dequant_factors(k_cache, layer).repeat_interleave(n_rep)[:, None]
    vs = tkv.layer_dequant_factors(v_cache, layer).repeat_interleave(n_rep)[:, None]
    qf = q.float() * ks
    kc, vc = k_cache.data.float(), v_cache.data.float()
    kw = dict(scale=D ** -0.5, n_kv=n_kv)
    if paged_table is None:
        out = tda.tkg_decode_attention_plain(qf, kc, vc, layer, mask, sink, **kw)
    else:
        out = tda.paged_tkg_decode_attention_plain(qf, kc, vc, layer, paged_table, mask, sink, **kw)
    return (out * vs).to(q.dtype)


@pytest.mark.parametrize("code", sorted(CODES))
@pytest.mark.parametrize("K,sink", [(1, False), (4, False), (1, True)])
def test_b1_plain_matches_jax_kernel(code, K, sink):
    rng = np.random.RandomState(3)
    jc, tc = _filled_contiguous(code, rng)
    bucket, layer = 128, 1
    q = _rand(rng, B, K, HQ, D)
    mask = _decode_mask(K, bucket, [100, 37])
    sink_w = _rand(rng, HQ) if sink else None
    ref = np.asarray(jax_decode(
        jnp.asarray(q), jc.k, jc.v, jnp.int32(layer), jnp.asarray(mask), None if sink_w is None else jnp.asarray(sink_w),
        scale=D ** -0.5, n_kv=HKV, bs=64, interpret=True,
    ))
    _cuda.reset_launch_counts()
    ts = None if sink_w is None else _t(sink_w)
    out = tda.tkg_decode_attention(_t(q), tc.k, tc.v, layer, _t(mask), ts, scale=D ** -0.5, n_kv=HKV)
    assert _cuda.launch_counts()["decode_attention_codes"] == 0
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=RTOL)
    code_mode = _code_mode_decode(_t(q), tc.k, tc.v, layer, _t(mask), ts, HKV)
    np.testing.assert_allclose(code_mode.numpy(), ref, atol=ATOL, rtol=RTOL)


def _filled_paged(code, rng, NB=12, bs=16, MB=8, valid=(7 * 16 - 3, 3 * 16 - 9)):
    jdt, tdt = CODES[code]
    jb = jbk.init_block_cache(L, NB, bs, HKV, D, dtype=jdt)
    tb = tbk.init_block_cache(L, NB, bs, HKV, D, dtype=tdt, device="cpu")
    bt = np.zeros((B, MB), np.int32)
    perm = rng.permutation(np.arange(1, NB + 1))
    bt[0, :7] = perm[:7]
    bt[1, :3] = perm[7:10]
    Sb = max(valid)
    posb = np.full((B, Sb), -1, np.int32)
    for b, v in enumerate(valid):
        posb[b, :v] = np.arange(v)
    sm = np.asarray(jbk.slot_mapping_from_block_table(
        jnp.asarray(bt), jnp.asarray(np.maximum(posb, 0)), bs, valid=jnp.asarray(posb >= 0)
    ))
    k_new, v_new = _rand(rng, B, Sb, HKV, D), _rand(rng, B, Sb, HKV, D)
    jk, jv = jb.k, jb.v
    for li in range(L):
        jk, jv = jbk.update_block_cache_at_layer(jk, jv, jnp.asarray(k_new), jnp.asarray(v_new), jnp.int32(li),
                                                 jnp.asarray(sm))
        tbk.update_block_cache_at_layer(tb.k, tb.v, _t(k_new), _t(v_new), li, _t(sm))
    # the port writes negative slots to block 0, the reference drops them:
    # only the real blocks must agree
    _assert_same_codes(tb.k.data[:, 1:], jk.data[:, 1:])
    np.testing.assert_array_equal(tb.k.scale.numpy(), np.asarray(jk.scale))
    np.testing.assert_array_equal(tb.v.scale.numpy(), np.asarray(jv.scale))
    return jk, jv, tb, bt, list(valid)


@pytest.mark.parametrize("code", sorted(CODES))
def test_b4_plain_matches_jax_kernel(code):
    rng = np.random.RandomState(5)
    jk, jv, tb, bt, valid = _filled_paged(code, rng)
    q = _rand(rng, B, 1, HQ, D)
    mask = _decode_mask(1, bt.shape[1] * 16, valid)
    ref = np.asarray(jax_paged_decode(
        jnp.asarray(q), jk, jv, jnp.int32(2), jnp.asarray(bt), jnp.asarray(mask), None,
        scale=D ** -0.5, n_kv=HKV, interpret=True,
    ))
    out = tda.paged_tkg_decode_attention(_t(q), tb.k, tb.v, 2, _t(bt), _t(mask), None, scale=D ** -0.5, n_kv=HKV)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=RTOL)
    code_mode = _code_mode_decode(_t(q), tb.k, tb.v, 2, _t(mask), None, HKV, paged_table=_t(bt))
    np.testing.assert_allclose(code_mode.numpy(), ref, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("code", sorted(CODES))
def test_codes_convert_to_bf16_exactly(code):
    """Every int8 code in [-127, 127] and every finite e4m3 / e5m2 byte is a
    bf16 value, sign of zero included: the code modes' tensor-core tiles
    (csrc/paged_attention_tile.cuh codes_to_bf16) convert the codes to bf16
    for mma.sync without rounding, and JAX's fp32 values of the same codes
    (what its kernels multiply) are the same numbers."""
    jdt, tdt = CODES[code]
    if tdt == torch.int8:
        codes = torch.arange(-127, 128, dtype=torch.int16).to(torch.int8)
    else:
        codes = torch.arange(256, dtype=torch.int16).to(torch.uint8).view(tdt)
    x = codes.float()
    finite = torch.isfinite(x)
    assert int(finite.sum()) == {"int8": 255, "e4m3": 254, "e5m2": 248}[code]
    x = x[finite]
    via_bf16 = x.to(torch.bfloat16).float()
    np.testing.assert_array_equal(via_bf16.view(torch.int32).numpy(), x.view(torch.int32).numpy())
    jx = np.asarray(jnp.asarray(codes.view(torch.uint8).numpy() if tdt != torch.int8 else codes.numpy())
                    .view(jdt).astype(jnp.float32))
    np.testing.assert_array_equal(jx[finite.numpy()].view(np.int32), x.view(torch.int32).numpy())


def _code_tiles_b5(q, k_layer, v_layer, bt, qpos, lim, tks, tvs, n_rep):
    """B5's code mode for a bf16 q as the card runs it (chip_smoke.
    paged_flash_plain_bf16_p, which the card's checks hold the kernel to):
    q unfolded, the raw scores over the codes, K's factor on the score
    scale, P rounded to bf16 at P.V relative to the running max of
    64-position tiles, V's factor on the finalized output."""
    import chip_smoke

    out, _ = chip_smoke.paged_flash_plain_bf16_p(
        torch, tpf, q, k_layer, v_layer, bt, qpos, lim, scale=D ** -0.5, n_rep=n_rep, tile=chip_smoke.B5_KV_TILE,
        k_scale=tks, v_scale=tvs,
    )
    return out


def _p_rounding_bound(v_layer, tvs):
    """What P's rounding to bf16 may move an output by: each p within 2^-9
    of itself and the p summing to l, at most 2^-9 of the largest |V|
    (dequantized; block 0 left out), plus ATOL for the fp32 sums."""
    return 2.0 ** -9 * (v_layer[1:].float().abs().amax(dim=(0, 2, 3)) * tvs).max().item() + ATOL


@pytest.mark.parametrize("code", sorted(CODES))
def test_b5_plain_matches_jax_kernel(code):
    """Chunked / prefix prefill over code blocks: 16 new tokens after a
    prior context of 48 and 23 positions, the layer's factors as k_scale /
    v_scale; the wrapper given the layer's running scales and qmax (as the
    model passes them) agrees too."""
    rng = np.random.RandomState(6)
    Sq, prior = 16, [48, 23]
    total = [p + Sq for p in prior]
    jk, jv, tb, bt, _ = _filled_paged(code, rng, valid=tuple(total))
    layer = 1
    q = _rand(rng, B, Sq, HQ, D)
    qpos = np.stack([np.arange(p, p + Sq) for p in prior]).astype(np.int32)
    lim = np.asarray(total, np.int32)
    ks, vs = jkv.layer_dequant_factors(jk, jnp.int32(layer)), jkv.layer_dequant_factors(jv, jnp.int32(layer))
    ref = np.asarray(jax_paged_flash(
        jnp.asarray(q), jk.data[layer], jv.data[layer], jnp.asarray(bt), jnp.asarray(qpos), jnp.asarray(lim),
        scale=D ** -0.5, n_rep=HQ // HKV, tq=16, k_scale=ks, v_scale=vs, interpret=True,
    ))
    tks, tvs = tkv.layer_dequant_factors(tb.k, layer), tkv.layer_dequant_factors(tb.v, layer)
    np.testing.assert_array_equal(tks.numpy(), np.asarray(ks))
    out = tpf.paged_flash_attention(
        _t(q), tb.k.data[layer], tb.v.data[layer], _t(bt), _t(qpos), _t(lim),
        scale=D ** -0.5, n_rep=HQ // HKV, k_scale=tks, v_scale=tvs,
    )
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=RTOL)
    k_l, v_l, codes = tkv.layer_streams(tb.k, tb.v, layer)
    by_scales = tpf.paged_flash_attention(_t(q), k_l, v_l, _t(bt), _t(qpos), _t(lim), scale=D ** -0.5,
                                          n_rep=HQ // HKV, **codes)
    np.testing.assert_array_equal(by_scales.numpy(), out.numpy())
    # the code mode's algorithm for a bf16 q (unfolded q, the codes as bf16,
    # K's factor on the score scale, P rounded to bf16 at P.V over
    # 64-position tiles, V's factor after) against the JAX kernel on the same
    # bf16-valued q, within what P's rounding may move the output
    qb = _t(q).to(torch.bfloat16).float()
    ref_b = np.asarray(jax_paged_flash(
        jnp.asarray(qb.numpy()), jk.data[layer], jv.data[layer], jnp.asarray(bt), jnp.asarray(qpos), jnp.asarray(lim),
        scale=D ** -0.5, n_rep=HQ // HKV, tq=16, k_scale=ks, v_scale=vs, interpret=True,
    ))
    model = _code_tiles_b5(qb, tb.k.data[layer], tb.v.data[layer], _t(bt), _t(qpos), _t(lim), tks, tvs, HQ // HKV)
    err = np.abs(model.numpy() - ref_b).max()
    assert 0 < err <= _p_rounding_bound(tb.v.data[layer], tvs), err


@pytest.mark.parametrize("code", sorted(CODES))
def test_b3_plain_matches_jax_kernel(code):
    """One mixed launch over code blocks (a 16-token chunk mid-context, two
    decode rows, an inactive row), the layer's factors as k_scale /
    v_scale; padded slots left out (the kernel writes zeros there)."""
    rng = np.random.RandomState(9)
    jk, jv, tb, bt, _ = _filled_paged(code, rng)
    layer = 2
    row_len = np.array([16, 1], np.int32)
    ctx = np.array([7 * 16 - 3, 3 * 16 - 9], np.int32)
    row_start = np.array([0, 16], np.int32)
    T = 32
    q = _rand(rng, T, HQ, D)
    ks, vs = jkv.layer_dequant_factors(jk, jnp.int32(layer)), jkv.layer_dequant_factors(jv, jnp.int32(layer))
    ref = np.asarray(jax_ragged(
        jnp.asarray(q), jk.data[layer], jv.data[layer], jnp.asarray(bt), jnp.asarray(row_start), jnp.asarray(row_len),
        jnp.asarray(ctx), scale=D ** -0.5, n_rep=HQ // HKV, k_scale=ks, v_scale=vs, interpret=True,
    ))
    tks, tvs = tkv.layer_dequant_factors(tb.k, layer), tkv.layer_dequant_factors(tb.v, layer)
    out = trp.ragged_paged_attention(
        _t(q), tb.k.data[layer], tb.v.data[layer], _t(bt), _t(row_start), _t(row_len), _t(ctx),
        scale=D ** -0.5, n_rep=HQ // HKV, k_scale=tks, v_scale=tvs,
    ).numpy()
    pos, _ = trp.packed_positions(T, _t(row_start), _t(row_len), _t(ctx))
    valid = (pos >= 0).numpy()
    np.testing.assert_allclose(out[valid], ref[valid], atol=ATOL, rtol=RTOL)
    # the code mode's algorithm for a bf16 q (the kernel model of
    # test_torch_ragged_attention over code blocks: the chunk's slots with P
    # rounded to bf16, the decode row over its splits) against the JAX
    # kernel on the same bf16-valued q
    from test_torch_ragged_attention import _kernel_model

    qb = _t(q).to(torch.bfloat16).float()
    ref_b = np.asarray(jax_ragged(
        jnp.asarray(qb.numpy()), jk.data[layer], jv.data[layer], jnp.asarray(bt), jnp.asarray(row_start),
        jnp.asarray(row_len), jnp.asarray(ctx), scale=D ** -0.5, n_rep=HQ // HKV, k_scale=ks, v_scale=vs,
        interpret=True,
    ))
    model, _ = _kernel_model(qb, tb.k.data[layer], tb.v.data[layer], _t(bt), _t(row_start), _t(row_len), _t(ctx),
                             scale=D ** -0.5, n_rep=HQ // HKV, round_p=True, k_scale=tks, v_scale=tvs)
    model = model.numpy()
    chunk, decode = slice(0, 16), slice(16, 17)
    err = np.abs(model[chunk] - ref_b[chunk]).max()
    assert 0 < err <= _p_rounding_bound(tb.v.data[layer], tvs), err
    np.testing.assert_allclose(model[decode], ref_b[decode], atol=ATOL, rtol=RTOL)
    # the layer dispatch hands the kernel's wrapper the layer's codes and factors
    from neuronx_distributed_inference_tpu_torch.modules.attention import AttnSpec

    spec = AttnSpec(num_heads=HQ, num_kv_heads=HKV, head_dim=D)
    disp = trp.ragged_attention(
        _t(q)[None], tb.k, tb.v, layer, _t(bt), pos[None], _t(row_start), _t(row_len), _t(ctx), spec,
    )[0].numpy()
    np.testing.assert_array_equal(disp, out)


def test_wrappers_refuse_mixed_streams_and_dtypes():
    rng = np.random.RandomState(4)
    _, tc = _filled_contiguous("int8", rng, S=8)
    q = torch.zeros(B, 1, HQ, D)
    mask = torch.ones(B, 1, 1, 16, dtype=torch.bool)
    with pytest.raises(ValueError, match="QuantizedKV"):
        tda.tkg_decode_attention(q, tc.k, tc.v.data.float(), 0, mask, scale=0.125, n_kv=HKV)
    with pytest.raises(ValueError, match="code dtypes"):
        bad = tkv.QuantizedKV(tc.v.data.to(torch.float8_e4m3fn), tc.v.scale)
        tda.tkg_decode_attention(q, tc.k, bad, 0, mask, scale=0.125, n_kv=HKV)
    layer = torch.zeros(4, HKV, 16, D, dtype=torch.int8)
    bt, pos, lim = torch.zeros(B, 1, dtype=torch.int32), torch.zeros(B, 8, dtype=torch.int32), torch.ones(B)
    with pytest.raises(ValueError, match="code caches"):
        tpf.paged_flash_attention(torch.zeros(B, 8, HQ, D), layer.float(), layer.float(), bt, pos, lim.int(),
                                  scale=0.125, n_rep=4, k_scale=torch.ones(HKV), v_scale=torch.ones(HKV))
    with pytest.raises(ValueError, match="together"):
        tpf.paged_flash_attention(torch.zeros(B, 8, HQ, D), layer, layer, bt, pos, lim.int(),
                                  scale=0.125, n_rep=4, k_scale=torch.ones(HKV))


# ---------------------------------------------------------------------------
# configs, pool sizing, bytes, faults and bounds
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("block", [False, True])
@pytest.mark.parametrize("name, dtype", [
    ("int8", torch.int8), ("fp8", torch.float8_e4m3fn), ("float8_e4m3", torch.float8_e4m3fn),
    ("float8_e5m2", torch.float8_e5m2),
])
def test_config_builds_the_quantized_cache(name, dtype, block):
    kw = dict(is_block_kv_layout=True, pa_num_blocks=8, pa_block_size=16) if block else {}
    c = Config(device="cpu", kv_cache_dtype=name, **kw)
    assert c.kv_quantized and c.kv_dtype == dtype
    shape = (2, 9, 4, 16, 64) if block else (2, 2, 128, 4, 64)
    make = (lambda: tbk.init_block_cache(2, 8, 16, 4, 64, dtype, "cpu")) if block else (
        lambda: tkv.init_cache(2, 1, 128, 4, 64, dtype, device="cpu"))
    cache = make()
    assert isinstance(cache.k, tkv.QuantizedKV) and cache.k.shape == shape and cache.k.dtype == dtype
    assert cache.k.scale.shape == (2, 4) and cache.k.scale.dtype == torch.float32
    assert not Config(device="cpu", kv_cache_dtype="bf16").kv_quantized


def test_int8_pool_holds_twice_the_blocks_and_bytes_halve():
    per_bf16 = tbk.kv_block_bytes(16, 32, 8, 64, torch.bfloat16)
    per_int8 = tbk.kv_block_bytes(16, 32, 8, 64, torch.int8)
    assert per_bf16 == 2 * per_int8 and per_int8 == jbk.kv_block_bytes(16, 32, 8, 64, jnp.int8)
    pool = 64 * per_bf16
    assert pool // per_int8 == 2 * (pool // per_bf16)
    plain = tkv.init_cache(4, 2, 256, 2, 64, torch.bfloat16, device="cpu")
    q8 = tkv.init_cache(4, 2, 256, 2, 64, torch.int8, device="cpu")
    assert tkv.cache_nbytes(q8) == tkv.cache_nbytes(plain) // 2 + 2 * 4 * 2 * 4
    assert tkv.cache_nbytes(q8) == jkv.cache_nbytes(jkv.init_cache(4, 2, 256, 2, 64, dtype=jnp.int8))


def test_fill_kv_rows_zeroes_codes_and_refuses_nan():
    rng = np.random.RandomState(2)
    _, tc = _filled_contiguous("int8", rng, S=16)
    scales = tc.k.scale.clone()
    assert tc.k.data[:, 1].any()
    fill_kv_rows(tc, [1], 0.0)
    assert not tc.k.data[:, 1].any() and not tc.v.data[:, 1].any() and tc.k.data[:, 0].any()
    assert torch.equal(tc.k.scale, scales)  # the scale is shared: a scrub leaves it
    with pytest.raises(ValueError, match="quantized KV stream"):
        fill_kv_rows(tc, [0], float("nan"))


def test_roofline_counts_code_bytes():
    m = roofline.MODEL_1B
    bf16 = roofline.attention_work(1, 8704, 8704, m)
    codes = roofline.attention_work(1, 8704, 8704, m, kv_elt=roofline.CODE)
    kv = 2 * 8704 * m["Hkv"] * m["D"]
    assert bf16[0] - codes[0] == kv - 2 * m["Hkv"] * 4 and bf16[1] == codes[1]
    pt = roofline.RAGGED_POINTS["decode"]
    rb, rc = roofline.ragged_work(**pt), roofline.ragged_work(**pt, kv_elt=roofline.CODE)
    assert rb[0] - rc[0] == 2 * 8 * 192 * m["Hkv"] * m["D"] - 2 * m["Hkv"] * 4 and rb[1] == rc[1]
