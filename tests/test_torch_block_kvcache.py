"""The port's paged KV cache (``modules/block_kvcache.py``) held against the
JAX package's: the host allocators step for step, and the device-side
scatter, slot mapping and gather on the same inputs made by numpy from a
seed, in fp32 (exact: these are copies and index arithmetic).

The one difference by design: JAX drops a negative-slot write (scatter
``mode="drop"``); the port writes it to offset 0 of the garbage block 0,
which every read scrubs to zeros. So block 0 offset 0 is compared nowhere
but the gather, where both read zeros."""

import jax.numpy as jnp
import numpy as np
import torch

from neuronx_distributed_inference_tpu.modules import block_kvcache as jbk
from neuronx_distributed_inference_tpu_torch.modules import block_kvcache as tbk

L, NB, H, BS, D = 2, 12, 2, 8, 16


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _state(a):
    """Everything a (prefix) allocator holds, in comparable form."""
    out = {"free": list(a.free), "seq_blocks": {k: list(v) for k, v in a.seq_blocks.items()}}
    for name in ("hash_of_block", "block_by_hash", "refcount"):
        if hasattr(a, name):
            out[name] = dict(getattr(a, name))
    if hasattr(a, "evictable"):
        out["evictable"] = list(a.evictable)
    return out


def _drive(a, ops):
    """Run one op list on an allocator; returns every op's result."""
    res = []
    for op, *args in ops:
        try:
            out = getattr(a, op)(*args)
        except RuntimeError as e:
            out = ("raised", "out of KV blocks" in str(e))
        if isinstance(out, np.ndarray):
            out = out.tolist()
        elif isinstance(out, list):
            out = list(out)
        res.append((op, out, _state(a)))
    return res


def test_block_allocator_lifecycle_matches_jax():
    ops = [
        ("alloc_seq", 0, 20), ("alloc_seq", 1, 9), ("slot_mapping", 0, np.arange(3, 19)),
        ("block_table", 0, 4), ("alloc_seq", 0, 30), ("free_seq", 1), ("alloc_seq", 2, 8 * 9),
        ("alloc_seq", 3, 8 * 20), ("quarantine_seq", 0), ("block_table", 2, 12),
        ("free_seq", 2), ("alloc_seq", 3, 5),
    ]
    assert _drive(tbk.BlockAllocator(NB, BS), ops) == _drive(jbk.BlockAllocator(NB, BS), ops)


def test_prefix_allocator_lifecycle_matches_jax():
    """Same block ids, same matches, same evictions, same quarantine scrub
    lists (the sequence of tests/test_chunked_prefill.py's lifecycle test,
    plus a shared-prefix quarantine)."""
    toks = np.arange(100, 114)
    other = np.arange(200, 214)
    ops = [
        ("alloc_seq", 0, len(toks)), ("commit_seq", 0, toks), ("match_prefix", 1, toks),
        ("match_prefix", 2, other), ("match_index_blocks", toks), ("free_seq", 0),
        ("free_seq", 1), ("match_prefix", 3, toks), ("alloc_seq", 3, len(toks)),
        ("quarantine_seq", 3), ("match_prefix", 4, toks), ("alloc_seq", 4, len(toks)),
        ("commit_seq", 4, toks), ("match_prefix", 5, toks), ("quarantine_seq", 4),
        ("free_seq", 2), ("alloc_seq", 9, 16 * 4), ("free_seq", 5), ("alloc_seq", 9, 16 * 8),
    ]
    t_res = _drive(tbk.PrefixCachingAllocator(16, 4), ops)
    j_res = _drive(jbk.PrefixCachingAllocator(16, 4), ops)
    assert t_res == j_res
    assert tbk.prefix_chain_keys(toks, 4) == jbk.prefix_chain_keys(toks, 4)


def test_init_and_block_bytes_match_jax():
    t = tbk.init_block_cache(L, NB, BS, H, D, dtype=torch.float32, device="cpu")
    j = jbk.init_block_cache(L, NB, BS, H, D, dtype=jnp.float32)
    assert tuple(t.k.shape) == j.k.shape == (L, NB + 1, H, BS, D)
    assert (t.num_layers, t.num_blocks, t.block_size) == (j.num_layers, j.num_blocks, j.block_size)
    for tdt, jdt in ((torch.bfloat16, jnp.bfloat16), (torch.float32, jnp.float32)):
        assert tbk.kv_block_bytes(16, 32, 8, 64, tdt) == jbk.kv_block_bytes(16, 32, 8, 64, jdt)


def test_update_block_cache_with_negative_slots():
    rng = np.random.RandomState(0)
    k0 = rng.randn(L, NB + 1, H, BS, D).astype(np.float32)
    v0 = rng.randn(L, NB + 1, H, BS, D).astype(np.float32)
    B, S = 2, 7
    kn = rng.randn(B, S, H, D).astype(np.float32)
    vn = rng.randn(B, S, H, D).astype(np.float32)
    slots = np.array([[9, 10, 11, -1, 40, 41, -1], [-1, -1, 63, 64, 65, 8, 95]], np.int32)
    jk, jv = jbk.update_block_cache_at_layer(
        jnp.asarray(k0), jnp.asarray(v0), jnp.asarray(kn), jnp.asarray(vn), 1, jnp.asarray(slots)
    )
    tk, tv = _t(k0.copy()), _t(v0.copy())
    out = tbk.update_block_cache_at_layer(tk, tv, _t(kn), _t(vn), 1, _t(slots))
    assert out[0] is tk and out[1] is tv  # in place
    for t, j in ((tk, jk), (tv, jv)):
        t, j = t.numpy(), np.asarray(j)
        np.testing.assert_array_equal(t[:, 1:], j[:, 1:])
        np.testing.assert_array_equal(t[:, 0, :, 1:], j[:, 0, :, 1:])
        np.testing.assert_array_equal(t[0], j[0])  # the other layer untouched
    # the negative slots' rows landed at garbage block 0, offset 0
    neg_rows = [kn[0, 3], kn[0, 6], kn[1, 0], kn[1, 1]]
    assert any(np.array_equal(tk.numpy()[1, 0, :, 0], r) for r in neg_rows)


def test_slot_mapping_from_block_table():
    rng = np.random.RandomState(1)
    bt = rng.randint(0, NB + 1, size=(3, 5)).astype(np.int32)
    pos = rng.randint(0, 5 * BS, size=(3, 6)).astype(np.int32)
    j = jbk.slot_mapping_from_block_table(jnp.asarray(bt), jnp.asarray(pos), BS)
    t = tbk.slot_mapping_from_block_table(_t(bt), _t(pos), BS)
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_read_block_cache_scrubs_garbage_block():
    """NaN in block 0 (zero-table tails) reads as exact zeros in both."""
    rng = np.random.RandomState(2)
    k0 = rng.randn(L, NB + 1, H, BS, D).astype(np.float32)
    v0 = rng.randn(L, NB + 1, H, BS, D).astype(np.float32)
    k0[:, 0] = np.nan
    v0[:, 0] = np.nan
    bt = np.array([[3, 7, 1, 0, 0], [12, 0, 5, 9, 2]], np.int32)
    jk, jv = jbk.read_block_cache_at_layer(jnp.asarray(k0), jnp.asarray(v0), 1, jnp.asarray(bt))
    tk, tv = tbk.read_block_cache_at_layer(_t(k0), _t(v0), 1, _t(bt))
    assert tuple(tk.shape) == (2, 5 * BS, H, D)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert np.isfinite(tk.numpy()).all() and np.isfinite(tv.numpy()).all()
