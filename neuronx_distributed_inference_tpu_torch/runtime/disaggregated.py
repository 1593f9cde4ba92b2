"""Disaggregated prefill/decode serving: a PREFILL-stage application encodes
prompts and hands per-request KV to a DECODE-stage application
(counterpart of the reference's ``runtime/disaggregated.py``).

Each stage is an ordinary :class:`ModelForCausalLM` whose config sets
``is_prefill_stage`` (True = warm the context-encoding runner only, False =
the token-generation runner only). The hand-off unit is a request's cache
lines of the contiguous cache: a ``(L, n_req, S, Hkv, D)`` gather on the
prefill stage, written into the decode stage's lines. Between two apps on
one card that is a device-to-device copy; when the stages sit on different
devices the payload moves with ``.to(device, non_blocking=True)``. It never
passes through the host.

Streams: the payload carries a CUDA event recorded after the gather, and
inject makes its own stream wait on it and marks the payload's tensors as
used there, so the prefill stage's and the decode stage's streams may
differ (the router runs each replica on its own stream). Inject writes the
decode cache IN PLACE on the current stream, so a captured graph holding
that cache replays after it.
"""

from __future__ import annotations

from collections import namedtuple
from typing import Dict, Optional

import numpy as np
import torch

from neuronx_distributed_inference_tpu_torch.modules.autobucketing import get_target_bucket
from neuronx_distributed_inference_tpu_torch.modules.kvcache import KVCache, QuantizedKV, kv_batch_size
from neuronx_distributed_inference_tpu_torch.modules.sampling import (
    prepare_sampling_params,
    validate_sampling_params,
)
from neuronx_distributed_inference_tpu_torch.runtime.application import GenerationOutput, _pick_chunk

#: KV-head layout of a stage: the reference replicates each KV head
#: ``kv_repeat`` consecutive times for its model-parallel degree; the port
#: runs one device per stage, so its own stages carry ``kv_repeat`` 1
KVLayout = namedtuple("KVLayout", ["kv_heads", "kv_repeat"])


def kv_layout(app) -> KVLayout:
    return KVLayout(kv_heads=int(app.spec.attn.num_kv_heads), kv_repeat=1)


def _plain_cache(app) -> KVCache:
    cache = app.kv_cache
    if (
        type(cache) is not KVCache
        or app.config.torch_config.is_block_kv_layout
        or app.spec.bounded_window is not None
    ):
        raise NotImplementedError(
            "disaggregated serving supports the plain contiguous KV cache "
            "(no ring/interleaved/paged layouts)"
        )
    return cache


def _host_lines(cache: KVCache, seq_ids) -> np.ndarray:
    """Cache line per request, computed on the host: the port's slot mapping
    (``kvcache.slot_ids_from_seq_ids``: line ``s`` for a valid seq id, the
    garbage line ``B`` otherwise), with no device round trip."""
    s = np.asarray(seq_ids, np.int64)
    b = kv_batch_size(cache)
    return np.where((s >= 0) & (s < b), s, b)


def _index(lines: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(lines, dtype=torch.long).to(device, non_blocking=True)


def extract_request_kv(app, seq_ids, upto: Optional[int] = None) -> Dict:
    """Gather the cache lines of ``seq_ids`` from the prefill stage: a copy
    ``{"k": (L, n, S, Hkv, D), "v": ...}`` on its device. ``upto`` bounds
    the position axis to the populated prefix.

    A quantized cache (int8/fp8) hands over the codes with the (L, Hkv)
    running-absmax scales they were written under (``k_scale`` /
    ``v_scale``, copies): :func:`inject_request_kv` folds the scales into
    the decode stage's running max. On a card the payload also carries
    ``event``, recorded after the gather on the current stream."""
    cache = _plain_cache(app)
    S = upto if upto is not None else cache.k.shape[2]
    idx = _index(_host_lines(cache, seq_ids), cache.k.device)
    out: Dict = {"gqa": kv_layout(app)}
    if isinstance(cache.k, QuantizedKV):
        out.update(
            k=cache.k.data[:, idx, :S],
            v=cache.v.data[:, idx, :S],
            k_scale=cache.k.scale.clone(),
            v_scale=cache.v.scale.clone(),
            quantized=True,
        )
    else:
        out.update(k=cache.k[:, idx, :S], v=cache.v[:, idx, :S])
    if out["k"].is_cuda:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(out["k"].device))
        out["event"] = ev
    return out


def _arrive(t: torch.Tensor, device) -> torch.Tensor:
    """One payload tensor on the decode stage's device and stream: moved
    there if it lives elsewhere, and held by the current stream until its
    work on it ends (the caching allocator reuses it only after)."""
    t = t.to(device, non_blocking=True)
    if t.is_cuda:
        t.record_stream(torch.cuda.current_stream(t.device))
    return t


def inject_request_kv(app, seq_ids, kv: Dict) -> None:
    """Write handed-over KV into the decode stage's cache lines, in place.

    Quantized hand-off: the codes land untouched and the source's (L, Hkv)
    scales fold into the decode stage's running absmax by elementwise max,
    the write path's own monotone update, so a fresh decode stage (zero
    scales) adopts the prefill stage's exactly. A decode stage already
    carrying larger scales dequantizes the handed codes under its grown
    scale (the batch-shared running absmax, as within one session)."""
    cache = _plain_cache(app)
    dev = cache.k.device
    S = kv["k"].shape[2]
    if S > cache.k.shape[2]:
        raise ValueError(
            f"handed-over KV covers {S} positions but the decode cache holds "
            f"{cache.k.shape[2]}"
        )
    quantized_src = bool(kv.get("quantized"))
    quantized_dst = isinstance(cache.k, QuantizedKV)
    if quantized_src != quantized_dst:
        raise ValueError(
            "quantized KV hand-off needs BOTH stages on the same cache "
            "format: the prefill stage sent "
            f"{'codes+scales' if quantized_src else 'plain values'} but the "
            f"decode cache is {'quantized' if quantized_dst else 'plain'} "
            "(set kv_cache_dtype identically on both stage configs)"
        )
    ev = kv.get("event")
    if ev is not None and dev.type == "cuda":
        torch.cuda.current_stream(dev).wait_event(ev)
    # the stages may replicate KV heads differently: recover the original
    # heads from the source layout, re-replicate for the destination's
    src_gqa, dst_gqa = kv.get("gqa"), kv_layout(app)
    k_arr, v_arr = kv["k"], kv["v"]
    k_scale, v_scale = kv.get("k_scale"), kv.get("v_scale")
    if src_gqa is not None and (src_gqa.kv_repeat != dst_gqa.kv_repeat or src_gqa.kv_heads != dst_gqa.kv_heads):
        r_src, r_dst = src_gqa.kv_repeat, dst_gqa.kv_repeat
        k_arr = k_arr[:, :, :, ::r_src].repeat_interleave(r_dst, dim=3)
        v_arr = v_arr[:, :, :, ::r_src].repeat_interleave(r_dst, dim=3)
        if quantized_src:
            k_scale = k_scale[:, ::r_src].repeat_interleave(r_dst, dim=1)
            v_scale = v_scale[:, ::r_src].repeat_interleave(r_dst, dim=1)
    idx = _index(_host_lines(cache, seq_ids), dev)
    k_in, v_in = _arrive(k_arr, dev), _arrive(v_arr, dev)
    if quantized_src:
        cache.k.data[:, idx, :S] = k_in.to(cache.k.data.dtype)
        cache.v.data[:, idx, :S] = v_in.to(cache.v.data.dtype)
        torch.maximum(cache.k.scale, _arrive(k_scale, dev), out=cache.k.scale)
        torch.maximum(cache.v.scale, _arrive(v_scale, dev), out=cache.v.scale)
    else:
        cache.k[:, idx, :S] = k_in.to(cache.k.dtype)
        cache.v[:, idx, :S] = v_in.to(cache.v.dtype)


def validate_handoff_payload(app, kv, expected_requests: int, expected_tokens: int) -> Optional[str]:
    """Inject-side validation of one hand-off payload against the decode
    stage's cache: a corrupt, truncated or malformed hand-off becomes a
    typed per-request failure instead of a poisoned batch. Returns a reason
    (``handoff_*``) or None when the payload is safe to inject.

    Checks, in order: structure and rank, cache-format agreement (quantized
    or plain, code dtype), layers / requests / head dim, declared length
    (a truncated transfer shows here), then finiteness of every float leaf
    (fp8 codes read as floats, and a quantized payload's scales: a NaN
    scale would dequantize every row of the destination to NaN). The
    finiteness reduce runs on the device and fetches ONE flag, the hand-off
    path's one host sync."""
    cache = _plain_cache(app)
    quantized_dst = isinstance(cache.k, QuantizedKV)
    dst_codes = cache.k.data if quantized_dst else cache.k
    if not isinstance(kv, dict) or "k" not in kv or "v" not in kv:
        return "handoff_malformed"
    k, v = kv["k"], kv["v"]
    if getattr(k, "ndim", 0) != 5 or getattr(v, "ndim", 0) != 5:
        return "handoff_malformed"
    if k.shape != v.shape:
        return "handoff_malformed"
    if bool(kv.get("quantized")) != quantized_dst:
        return "handoff_format"
    if quantized_dst and k.dtype != dst_codes.dtype:
        return "handoff_format"
    if k.shape[0] != dst_codes.shape[0]:  # layers
        return "handoff_shape"
    if k.shape[1] != expected_requests:
        return "handoff_shape"
    if k.shape[4] != dst_codes.shape[-1]:  # head_dim survives any head remap
        return "handoff_shape"
    if k.shape[2] != expected_tokens:
        # fewer (or more) positions than the prefill stage declared: a
        # partial prompt would decode plausibly but wrong
        return "handoff_truncated"
    if quantized_dst:
        ks, vs = kv.get("k_scale"), kv.get("v_scale")
        if ks is None or vs is None:
            return "handoff_malformed"
        if tuple(ks.shape) != (k.shape[0], k.shape[3]) or vs.shape != ks.shape:
            return "handoff_malformed"
        leaves = [ks, vs]
        if k.dtype.is_floating_point:  # fp8 codes carry NaN/Inf
            leaves += [k, v]
    else:
        leaves = [k, v]
    ev = kv.get("event")
    if ev is not None and k.is_cuda:
        torch.cuda.current_stream(k.device).wait_event(ev)
    flags = torch.stack([torch.isfinite(a.float()).all().to(k.device) for a in leaves])
    if not bool(flags.all()):
        return "handoff_corrupt"
    return None


class DisaggregatedPipeline:
    """Prefill-stage + decode-stage orchestration (one process; the two apps
    may live on different devices). ``generate`` reproduces the monolithic
    application's greedy / sampled semantics: context encoding on the
    prefill stage, the KV hand-off, then chunked decode on the decode
    stage."""

    def __init__(self, prefill_app, decode_app):
        tc_p = prefill_app.config.torch_config
        tc_d = decode_app.config.torch_config
        if tc_p.is_prefill_stage is not True or tc_d.is_prefill_stage is not False:
            raise ValueError(
                "DisaggregatedPipeline needs a prefill-stage app "
                "(is_prefill_stage=True) and a decode-stage app (False)"
            )
        self.prefill_app = prefill_app
        self.decode_app = decode_app

    def generate(
        self,
        input_ids: np.ndarray,
        attention_mask: Optional[np.ndarray] = None,
        max_new_tokens: int = 32,
        eos_token_id: Optional[int] = None,
        top_k=None,
        top_p=None,
        temperature=None,
    ) -> GenerationOutput:
        pre, dec = self.prefill_app, self.decode_app
        tc = dec.config.torch_config
        pre._advance_rng()
        dec._advance_rng()
        input_ids = np.asarray(input_ids)
        B, S_in = input_ids.shape
        if attention_mask is None:
            attention_mask = np.ones_like(input_ids)
        attention_mask = np.asarray(attention_mask)
        seq_ids = np.arange(B, dtype=np.int32)
        sp = prepare_sampling_params(B, top_k, top_p, temperature)
        validate_sampling_params(sp, tc.max_topk)
        ctx_lens = attention_mask.sum(axis=1).astype(np.int32)

        # --- prefill stage: one context pass, or windows for long prompts
        if pre.validate_prefill_length(S_in):
            tokens_dev, _ = pre._windowed_prefill(input_ids, attention_mask, seq_ids, sp)
        else:
            position_ids = np.tile(np.arange(S_in, dtype=np.int32), (B, 1))
            inputs, _ = pre.context_encoding_model.prepare(input_ids, attention_mask, position_ids, seq_ids, sp)
            out = pre.context_encoding_model(pre.params, pre.kv_cache, inputs, pre._rng)
            tokens_dev = out.tokens

        # --- KV hand-off, recorded under the router tier's instruments
        from neuronx_distributed_inference_tpu_torch.telemetry.tracing import default_session

        tel = default_session()
        tel.handoff_attempt()
        t0 = tel.clock()
        inject_request_kv(dec, seq_ids, extract_request_kv(pre, seq_ids, upto=S_in))
        tel.handoff_done((tel.clock() - t0) * 1e3)
        first = tokens_dev[:B, -1].cpu().numpy()

        # --- decode stage: the monolithic application's EOS-path loop
        eos_arr = np.atleast_1d(np.asarray(eos_token_id)).astype(np.int64) if eos_token_id is not None else None
        eos_fill = int(eos_arr[0]) if eos_arr is not None else 0
        generated = [first.astype(np.int64)]
        done = np.zeros(B, bool)
        if eos_arr is not None:
            done |= np.isin(generated[-1], eos_arr)
        pos = ctx_lens.copy()
        last = first[:, None].astype(np.int32)
        remaining = max_new_tokens - 1
        pos_limit = dec._pos_limit()
        tkg = dec.token_generation_model
        while remaining > 0 and not done.all():
            headroom = pos_limit - int(pos.max())
            if headroom < 1:
                raise ValueError(
                    f"generation needs positions past the largest TKG "
                    f"bucket/cache window ({pos_limit}); raise "
                    f"token_generation_buckets or seq_len"
                )
            chunk = _pick_chunk(remaining, eos_arr is not None, headroom)
            take = min(chunk, remaining)
            bucket = get_target_bucket(tkg.buckets, int(pos.max()) + chunk)
            tokens_c, _, dec.kv_cache = tkg.decode_chunk(
                dec.params, dec.kv_cache, last, pos[:, None], seq_ids, sp,
                num_steps=chunk, bucket=bucket, generator=dec._rng,
            )
            toks = tokens_c[:B].cpu().numpy()
            for j in range(take):
                col = np.where(done, eos_fill, toks[:, j])
                if eos_arr is not None:
                    done |= np.isin(col, eos_arr)
                generated.append(col.astype(np.int64))
            last = toks[:, take - 1 : take].astype(np.int32)
            pos = pos + take
            remaining -= take

        gen = np.stack(generated, axis=1)
        return GenerationOutput(
            sequences=np.concatenate([input_ids, gen], axis=1),
            logits=None,
            num_generated=gen.shape[1],
        )
