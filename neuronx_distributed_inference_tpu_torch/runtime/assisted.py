"""Vanilla (unfused) speculative decoding with two applications
(counterpart of the reference's ``runtime/assisted.py``).

The draft and the target are loaded independently; the host runs propose
-> verify -> accept. Each round the draft proposes k-1 tokens in one
multi-step decode chunk (B1, one query a row), the target verifies the k
candidates in ONE k-token pass over its contiguous cache (B1 with k
queries a row), and the accepted prefix plus one bonus token is emitted.

Verification (the reference's ``_speculative_token_selection`` family):

- greedy (default): contiguous argmax matching, so the emitted stream is
  byte-equal to the target's own greedy decoding;
- sampled: accept draft token d with probability min(1, p(d)/q(d)) and
  resample the residual at the first rejection
  (``modules/speculation.verify_and_accept``), whose emitted marginal is
  the target's distribution. Both apps must sample (``do_sample``) and
  return logits (``output_logits``); the draws come from the apps'
  generators and an accept generator seeded from the target's seed.

Both caches take write-then-attend writes, so a rejected candidate leaves
only a stale entry that a later round writes again before reading it. On a
ring cache (sliding-window models) that does not hold: a round's writes at
slots (p + j) mod W overwrite the live K/V of positions p + j - W, so
:class:`RingSnapshotGuard` saves those slots before a round and puts the
rejected ones back after it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from neuronx_distributed_inference_tpu_torch.modules.kvcache import InterleavedKVCache, QuantizedKV
from neuronx_distributed_inference_tpu_torch.modules.sampling import (
    prepare_sampling_params,
    validate_sampling_params,
    warped_probs,
)
from neuronx_distributed_inference_tpu_torch.modules.speculation import verify_and_accept
from neuronx_distributed_inference_tpu_torch.runtime.application import GenerationOutput


class RingSnapshotGuard:
    """Snapshot and restore of the at-risk ring slots around one
    speculation round (the reference's ``RingSnapshotGuard``).

    A round writes candidate K/V at positions p .. p + n - 1; on a ring
    cache (``spec.bounded_window``, or the ring stack of an interleaved
    cache, ``spec.ring_window``) they land in slots (p + j) mod W and
    overwrite the still-live K/V of positions p + j - W. The guard copies
    those n slots of every ring layer before the round (:meth:`snapshot`)
    and writes the rejected ones back after acceptance (:meth:`restore`:
    slot j of row b survives iff j < counts[b]). A quantized ring moves its
    codes, as the reference does. Apps without a ring make both a no-op."""

    def __init__(self, app, n_slots: int):
        spec = app.spec
        self.W = spec.bounded_window or spec.ring_window
        self.app = app
        self.n = int(n_slots)
        if self.W is not None and self.n > self.W:
            raise ValueError(
                f"speculation writes {self.n} positions but the ring window "
                f"holds only {self.W}: one round would wrap over its own "
                "writes; lower speculation_length"
            )
        self._snap = None
        self._slots = None

    def _ring_arrays(self):
        cache = self.app.kv_cache
        if isinstance(cache, InterleavedKVCache):
            return cache.k_ring, cache.v_ring
        if isinstance(cache.k, QuantizedKV):
            return cache.k.data, cache.v.data
        return cache.k, cache.v

    def snapshot(self, pos: np.ndarray) -> None:
        """Copy the ring slots that positions pos .. pos + n - 1 will write
        (rows 0 .. B - 1 are cache lines 0 .. B - 1)."""
        if self.W is None:
            return
        pos = np.asarray(pos, np.int64).reshape(-1)
        self._slots = (pos[:, None] + np.arange(self.n)) % self.W  # (B, n)
        arrays = self._ring_arrays()
        dev = arrays[0].device
        rows = torch.arange(pos.shape[0], device=dev)[:, None]
        slots = torch.from_numpy(self._slots).to(dev)
        self._snap = tuple(a[:, rows, slots].clone() for a in arrays)  # (L, B, n, H, D)

    def restore(self, counts: np.ndarray) -> None:
        """Write the snapshot back at the slots whose writes were rejected."""
        if self.W is None or self._snap is None:
            return
        rejected = np.arange(self.n)[None, :] >= np.asarray(counts)[:, None]  # (B, n)
        slots, snaps = self._slots, self._snap
        self._snap = self._slots = None
        b, j = np.nonzero(rejected)
        if b.size == 0:
            return
        arrays = self._ring_arrays()
        dev = arrays[0].device
        bt, jt = torch.from_numpy(b).to(dev), torch.from_numpy(j).to(dev)
        st = torch.from_numpy(slots[b, j]).to(dev)
        for a, snap in zip(arrays, snaps):
            a[:, bt, st] = snap[:, bt, jt]


def draft_propose(draft, last, pos, seq_ids, sp, k: int, generator=None):
    """One batched draft chunk proposing k-1 tokens per row. Returns
    (proposals (B, k-1) int32 numpy, draft logits (B, k-1, V) on the device
    or None). Shared by :func:`assisted_generate` and the speculative
    session's split path.

    The chunk runs k steps, not k-1: the k-th only writes the last
    proposal's K/V at pos + k - 1 (its own proposal is discarded), as the
    fused round's last draft step does. A fully accepted round commits that
    position, and a draft cache without it would attend a stale entry
    there from the next round on: a cost in acceptance only (the target's
    tokens are emitted either way), but on near-flat logits a large one.
    The reference's k-1-step chunk leaves that hole."""
    bucket = draft._decode_bucket(int(np.asarray(pos).max()) + k)
    d_tokens, d_logits, d_cache = draft.token_generation_model.decode_chunk(
        draft.params, draft.kv_cache, np.asarray(last), np.asarray(pos), seq_ids, sp,
        num_steps=k, bucket=bucket, generator=generator,
    )
    draft.kv_cache = d_cache
    B = np.asarray(last).shape[0]
    return d_tokens[:B, : k - 1].cpu().numpy(), (d_logits[:, : k - 1] if d_logits is not None else None)


def greedy_accept(cand: np.ndarray, greedy: np.ndarray) -> np.ndarray:
    """Greedy contiguous-match acceptance on the host: candidate
    ``cand[:, i + 1]`` is accepted while it equals the target's
    ``greedy[:, i]``, so a -1 sentinel stops it. Returns the counts (B,) in
    [1, k]: the accepted drafts plus the target's bonus token."""
    matches = (cand[:, 1:] == greedy[:, :-1]).astype(np.int64)
    return np.cumprod(matches, axis=1).sum(axis=1) + 1


def target_verify(target, cand, pos, seq_ids, sp, generator=None):
    """One k-token target pass over the candidates of every row (positions
    pos .. pos + k - 1). Returns the StepOutput: tokens (B, k) are the
    greedy (or sampled) prediction after each candidate."""
    k = cand.shape[1]
    cand_pos = np.asarray(pos) + np.arange(k, dtype=np.int32)[None, :]
    width = target._decode_bucket(int(cand_pos.max()) + 1)
    cache_mask = (np.arange(width)[None, :] <= cand_pos[:, -1:]).astype(np.int32)
    runner = target.token_generation_model
    v_inputs, _ = runner.prepare(cand, cache_mask, cand_pos, seq_ids, sp)
    out = runner(target.params, target.kv_cache, v_inputs, generator)
    target.kv_cache = out.cache
    return out


def assisted_generate(
    target,
    draft,
    input_ids: np.ndarray,
    attention_mask: Optional[np.ndarray] = None,
    max_new_tokens: int = 32,
    eos_token_id: Optional[int] = None,
    speculation_length: Optional[int] = None,
    top_k=None,
    top_p=None,
    temperature=None,
) -> GenerationOutput:
    """Draft-assisted generation (the reference's ``assisted_generate``).

    ``target`` and ``draft`` are loaded apps over contiguous caches (ring
    caches too, under :class:`RingSnapshotGuard`) sharing a vocabulary. Rows whose budget or EOS ends early stop collecting; the
    loop runs while a round of k positions still fits ``seq_len``."""
    tc = target.config.torch_config
    k = speculation_length or max(tc.speculation_length, 2)
    if k < 2:
        raise ValueError("speculation_length must be >= 2")
    # ring caches: rejected writes at (p + j) mod W would destroy the live
    # K/V of position p + j - W; the draft's chunk writes k positions too
    t_guard = RingSnapshotGuard(target, k)
    d_guard = RingSnapshotGuard(draft, k)
    do_sample = bool(target.spec.do_sample)
    if do_sample:
        if not (target.spec.output_logits and draft.spec.output_logits):
            raise ValueError(
                "sampled assisted decoding needs output_logits=True on both "
                "apps (the host computes the p/q accept ratio)"
            )
        if not draft.spec.do_sample:
            raise ValueError(
                "sampled assisted decoding needs the draft app loaded with "
                "do_sample on-device sampling (proposals must be drawn from "
                "the warped draft distribution q)"
            )
    input_ids = np.asarray(input_ids)
    B, S_in = input_ids.shape
    attention_mask = np.ones_like(input_ids) if attention_mask is None else np.asarray(attention_mask)
    seq_ids = np.arange(B, dtype=np.int32)
    sp = prepare_sampling_params(B, top_k, top_p, temperature)
    validate_sampling_params(sp, tc.max_topk)
    t_gen = d_gen = accept_gen = None
    if do_sample:
        target._advance_rng()
        draft._advance_rng()
        t_gen, d_gen = target._rng, draft._rng
        accept_gen = torch.Generator(device=target.device)
        accept_gen.manual_seed(tc.seed + 7919)

    # --- prefill both apps on the prompt ---
    ctx_lens = attention_mask.sum(axis=1).astype(np.int32)
    position_ids = np.tile(np.arange(S_in, dtype=np.int32), (B, 1))
    for app, gen in ((target, t_gen), (draft, None)):
        cte = app.context_encoding_model
        inputs, _ = cte.prepare(input_ids, attention_mask, position_ids, seq_ids, sp)
        out = cte(app.params, app.kv_cache, inputs, gen)
        app.kv_cache = out.cache
        if app is target:
            first = out.tokens[:B].cpu().numpy()[:, -1]

    collected = [[int(first[b])] for b in range(B)]
    done = np.zeros(B, bool)
    eos_arr = np.atleast_1d(np.asarray(eos_token_id)) if eos_token_id is not None else None
    if eos_arr is not None:
        done |= np.isin(first, eos_arr)
    pos = ctx_lens.copy()  # position of the token in `last`
    last = first.astype(np.int32)
    spt = torch.from_numpy(sp).to(target.device)

    while not done.all() and int(pos.max()) + k <= tc.seq_len and not all(
        len(c) >= max_new_tokens for c in collected
    ):
        t_guard.snapshot(pos)
        d_guard.snapshot(pos)
        proposals, d_logits = draft_propose(draft, last[:, None], pos[:, None], seq_ids, sp, k, d_gen)
        cand = np.concatenate([last[:, None], proposals], axis=1).astype(np.int32)
        v_out = target_verify(target, cand, pos[:, None], seq_ids, sp)
        if do_sample:
            tlogits = v_out.logits[:B].float()  # (B, k, V)
            dlog = d_logits[:B].float().to(target.device)  # (B, k-1, V)
            draft_dists = [warped_probs(dlog[:, i], spt, tc.max_topk) for i in range(k - 1)]
            toks_t, counts_t = verify_and_accept(
                torch.from_numpy(cand).to(target.device), tlogits, draft_dists, spt, accept_gen, True,
                tc.max_topk,
            )
            toks = toks_t.cpu().numpy()
            counts = counts_t.cpu().numpy().astype(np.int64)
        else:
            toks = v_out.tokens[:B].cpu().numpy()  # (B, k)
            counts = greedy_accept(cand, toks)
        t_guard.restore(counts)
        d_guard.restore(counts)
        for b in range(B):
            if done[b]:
                continue
            row = toks[b, : counts[b]].tolist()
            if eos_arr is not None:
                hits = [i for i, t in enumerate(row) if t in eos_arr]
                if hits:
                    row = row[: hits[0] + 1]
                    done[b] = True
            collected[b].extend(row)
            if len(collected[b]) >= max_new_tokens:
                done[b] = True
        last = toks[np.arange(B), counts - 1].astype(np.int32)
        pos = pos + counts.astype(np.int32)

    n_new = min(max_new_tokens, max(len(c) for c in collected))
    pad_tok = eos_token_id if eos_token_id is not None else 0
    gen = np.full((B, n_new), pad_tok, np.int64)
    for b in range(B):
        row = collected[b][:n_new]
        gen[b, : len(row)] = row
    sequences = np.concatenate([input_ids, gen], axis=1)
    return GenerationOutput(sequences=sequences, logits=None, num_generated=n_new)
