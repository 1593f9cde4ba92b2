"""Serving fault containment: typed faults and a deterministic
FaultInjector (counterpart of the reference's ``runtime/faults.py``).

- :class:`TransientDispatchError` / :data:`RETRYABLE_DISPATCH_ERRORS`: what
  the session's bounded-backoff dispatch retry treats as transient.
  Everything else propagates. The reference also retries the JAX runtime's
  device error; here a CUDA error is NOT retried, because a device fault
  leaves the CUDA context unusable and a retry would only hide it.
- :class:`WatchdogError`: raised, with a diagnostic snapshot, when the
  no-forward-progress watchdog trips twice.
- :class:`HandoffTransitError` / :data:`RETRYABLE_HANDOFF_ERRORS`: a KV
  hand-off attempt of the disaggregated prefill tier that failed in
  transit (payload lost, stalled, past its timeout); the router retries it
  with capped backoff, as it does a transient dispatch error on the tier
  member (``runtime/router.py``).
- :class:`FaultInjector`: a seedable fault source armed per session step —
  NaN-poisoned KV rows, a NaN garbage block, corrupted token fetches,
  forced pool exhaustion, raised dispatch errors, injected latency, stalls
  — and per router hand-off (:data:`HANDOFF_FAULT_KINDS`). Faults fire at
  the session's and the router's host boundaries, so the same serving code
  runs with and without them, and an armed-but-idle injector is
  byte-identical to none.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

import numpy as np


class TransientDispatchError(RuntimeError):
    """A dispatch failure worth retrying (the injected stand-in for a
    transient runtime error)."""


class WatchdogError(RuntimeError):
    """The serving session made no forward progress for two consecutive
    watchdog windows; carries the session's diagnostic snapshot."""

    def __init__(self, message: str, snapshot: Optional[dict] = None):
        super().__init__(message)
        self.snapshot = snapshot or {}


class HandoffTransitError(RuntimeError):
    """One KV hand-off attempt failed IN TRANSIT (payload lost, transfer
    stalled or past the operator timeout): the payload never reached the
    decode replica, so the attempt is retryable. A corrupt or truncated
    payload DID arrive; the decode side's inject validation fails it as a
    terminal FAILED(handoff)."""


RETRYABLE_DISPATCH_ERRORS: Tuple[type, ...] = (TransientDispatchError,)

#: what a hand-off attempt may fail with and still be retried: the transit
#: faults and a transient dispatch error of the prefill pass (a CUDA error
#: is not among them, as for the session's dispatch retry)
RETRYABLE_HANDOFF_ERRORS: Tuple[type, ...] = (HandoffTransitError,) + RETRYABLE_DISPATCH_ERRORS

#: every fault kind random_schedule can draw (also the session-hook names)
FAULT_KINDS = (
    "nan_tokens",
    "poison_kv_row",
    "poison_garbage_block",
    "exhaust_pool",
    "dispatch_error",
    "latency",
    "stall",
)

#: KV hand-off fault kinds (the disaggregated prefill tier): armed by
#: HAND-OFF INDEX (the router's monotone hand-off counter; the attempts of
#: one hand-off share it), not by session step, since hand-offs happen at
#: placement time. drop / latency / stall are transit faults (retryable,
#: bounded by handoff_max_retries); corrupt / truncate change the delivered
#: payload, which the decode side's validation fails (FAILED(handoff)).
HANDOFF_FAULT_KINDS = (
    "handoff_drop",
    "handoff_corrupt",
    "handoff_truncate",
    "handoff_latency",
    "handoff_stall",
)


class FaultInjector:
    """Deterministic, seedable fault source for serving sessions.

    Arm faults against step indices, hand the injector to
    ``ServingSession(app, fault_injector=...)`` and drive the session;
    ``injector.log`` records every fault that fired (step, kind, detail)."""

    def __init__(self, seed: int = 0):
        self.rng = np.random.RandomState(seed)
        self.log: List[dict] = []
        self._latency: Dict[int, float] = {}
        self._stall: Set[int] = set()
        self._exhaust_pool: Set[int] = set()
        # step -> dispatch ATTEMPTS still to fail at that step
        self._dispatch_fail: Dict[int, int] = {}
        self._nan_tokens: Dict[int, List[int]] = {}
        self._poison_rows: Dict[int, List[int]] = {}
        self._poison_garbage: Set[int] = set()
        # hand-off faults by hand-off index
        self._handoff_drop: Dict[int, int] = {}  # index -> attempts to drop
        self._handoff_latency: Dict[int, float] = {}
        self._handoff_stall: Set[int] = set()
        self._handoff_corrupt: Set[int] = set()
        self._handoff_truncate: Set[int] = set()

    # ---- arming ----------------------------------------------------------

    def latency(self, step: int, seconds: float) -> "FaultInjector":
        """Sleep ``seconds`` (through the session's injectable sleep) at the
        start of ``step``."""
        self._latency[step] = float(seconds)
        return self

    def stall(self, *steps: int) -> "FaultInjector":
        """Suppress the model dispatch entirely at ``steps``."""
        self._stall.update(int(s) for s in steps)
        return self

    def exhaust_pool(self, *steps: int) -> "FaultInjector":
        """Every KV-block allocation at ``steps`` fails as if the pool were
        empty."""
        self._exhaust_pool.update(int(s) for s in steps)
        return self

    def dispatch_error(self, step: int, attempts: int = 1) -> "FaultInjector":
        """Raise :class:`TransientDispatchError` for the first ``attempts``
        dispatch attempts at ``step``."""
        self._dispatch_fail[int(step)] = int(attempts)
        return self

    def nan_logits(self, step: int, slot: int) -> "FaultInjector":
        """Corrupt the HOST-fetched tokens of ``slot`` at ``step`` to the
        non-finite sentinel (the device cache stays clean)."""
        self._nan_tokens.setdefault(int(step), []).append(int(slot))
        return self

    def poison_kv_row(self, step: int, slot: int) -> "FaultInjector":
        """Write NaN over ``slot``'s live KV at the start of ``step``."""
        self._poison_rows.setdefault(int(step), []).append(int(slot))
        return self

    def poison_garbage_block(self, step: int) -> "FaultInjector":
        """Write NaN over the shared garbage sink (paged block 0 / the
        contiguous garbage line) at ``step``."""
        self._poison_garbage.add(int(step))
        return self

    # ---- KV hand-off faults (disaggregated prefill tier) -----------------

    def handoff_drop(self, handoff: int, attempts: int = 1) -> "FaultInjector":
        """Lose hand-off ``handoff``'s payload in transit for its first
        ``attempts`` attempts (:class:`HandoffTransitError`): up to
        handoff_max_retries the retry recovers, past it the request fails
        FAILED(handoff)."""
        self._handoff_drop[int(handoff)] = int(attempts)
        return self

    def handoff_latency(self, handoff: int, seconds: float) -> "FaultInjector":
        """Sleep ``seconds`` (through the router's injectable sleep) inside
        the FIRST attempt of hand-off ``handoff``; with handoff_timeout_s
        set, the router sees the overrun and retries latency-free."""
        self._handoff_latency[int(handoff)] = float(seconds)
        return self

    def handoff_stall(self, handoff: int) -> "FaultInjector":
        """Stall hand-off ``handoff``'s transfer on every attempt: each one
        reads as timed out (retryable), so the bounded retry exhausts."""
        self._handoff_stall.add(int(handoff))
        return self

    def handoff_corrupt(self, handoff: int) -> "FaultInjector":
        """Write NaN into hand-off ``handoff``'s delivered K stream (into
        the running-absmax scales of a quantized payload): the decode
        side's validation fails ONE request FAILED(handoff) and scrubs the
        line."""
        self._handoff_corrupt.add(int(handoff))
        return self

    def handoff_truncate(self, handoff: int) -> "FaultInjector":
        """Deliver half of hand-off ``handoff``'s positions: the decode
        side's length check fails the request FAILED(handoff)."""
        self._handoff_truncate.add(int(handoff))
        return self

    def random_schedule(
        self,
        n_steps: int,
        rate: float,
        kinds: Tuple[str, ...] = ("exhaust_pool", "dispatch_error", "latency"),
        slots: Tuple[int, ...] = (0,),
    ) -> "FaultInjector":
        """Arm a reproducible random schedule from the seed: each step fires
        one fault of a random ``kind`` with probability ``rate``."""
        for step in range(n_steps):
            if self.rng.rand() >= rate:
                continue
            kind = kinds[self.rng.randint(len(kinds))]
            if kind == "latency":
                self.latency(step, float(self.rng.rand()) * 0.01)
            elif kind == "dispatch_error":
                self.dispatch_error(step, attempts=1)
            elif kind == "exhaust_pool":
                self.exhaust_pool(step)
            elif kind == "stall":
                self.stall(step)
            elif kind == "nan_tokens":
                self.nan_logits(step, int(slots[self.rng.randint(len(slots))]))
            elif kind == "poison_kv_row":
                self.poison_kv_row(step, int(slots[self.rng.randint(len(slots))]))
            elif kind == "poison_garbage_block":
                self.poison_garbage_block(step)
            else:
                raise ValueError(f"unknown fault kind {kind!r}")
        return self

    # ---- session hooks ---------------------------------------------------

    def _fired(self, step: int, kind: str, **detail) -> None:
        self.log.append({"step": step, "kind": kind, **detail})

    def on_step_begin(self, session) -> None:
        """Start-of-step faults: injected latency and device KV poisoning."""
        step = session._step_index
        # pool-exhaustion arms stay live for their whole step; retire the past
        self._exhaust_pool = {s for s in self._exhaust_pool if s >= step}
        delay = self._latency.pop(step, None)
        if delay is not None:
            session._sleep(delay)
            self._fired(step, "latency", seconds=delay)
        for slot in self._poison_rows.pop(step, ()):
            if _poison_row(session, slot):
                self._fired(step, "poison_kv_row", slot=slot)
        if step in self._poison_garbage:
            self._poison_garbage.discard(step)
            _poison_garbage(session)
            self._fired(step, "poison_garbage_block")

    def stalled(self, session) -> bool:
        step = session._step_index
        if step in self._stall:
            self._stall.discard(step)
            self._fired(step, "stall")
            return True
        return False

    def on_dispatch(self, session, label: str) -> None:
        """Called once per dispatch ATTEMPT inside the session's retry loop:
        raises while this step still has armed attempt-failures."""
        step = session._step_index
        remaining = self._dispatch_fail.get(step, 0)
        if remaining > 0:
            self._dispatch_fail[step] = remaining - 1
            self._fired(step, "dispatch_error", label=label)
            raise TransientDispatchError(f"injected dispatch fault (step {step}, {label})")

    def dispatch_gave_up(self, session) -> None:
        """The retry budget ran out: retire this step's remaining armed
        failures so the fault stays scoped to the dispatch it hit."""
        self._dispatch_fail.pop(session._step_index, None)

    def pool_exhausted(self, session) -> bool:
        step = session._step_index
        if step in self._exhaust_pool:
            if not any(f["step"] == step and f["kind"] == "exhaust_pool" for f in self.log):
                self._fired(step, "exhaust_pool")
            return True
        return False

    def corrupt_tokens(self, session, tokens: np.ndarray) -> np.ndarray:
        """Armed slots of a freshly fetched slot-indexed token array ((B,)
        or (B, K): a decode chunk, the split speculative path's (B, k)
        verify tokens, the spec-ragged step's (R, k+1) tokens with the
        accepted count) read as the non-finite sentinel in every column, so
        a speculative row quarantines on its accepted window."""
        from neuronx_distributed_inference_tpu_torch.models.base import NON_FINITE_TOKEN

        step = session._step_index
        slots = self._nan_tokens.pop(step, None)
        if not slots:
            return tokens
        tokens = np.array(tokens, copy=True)
        for slot in slots:
            tokens[slot] = NON_FINITE_TOKEN
            self._fired(step, "nan_tokens", slot=slot)
        return tokens


    # ---- hand-off hooks (the router's hand-off boundary) ------------------

    def _fired_handoff(self, handoff: int, kind: str, **detail) -> None:
        self.log.append({"handoff": handoff, "kind": kind, **detail})

    def handoff_transit(self, handoff: int, sleep_fn) -> None:
        """Called once per hand-off ATTEMPT, between extract and inject:
        injected latency (through ``sleep_fn``), then
        :class:`HandoffTransitError` for an armed stall (every attempt) or
        drop (its first n attempts)."""
        idx = int(handoff)
        delay = self._handoff_latency.pop(idx, None)
        if delay is not None:
            sleep_fn(delay)
            self._fired_handoff(idx, "handoff_latency", seconds=delay)
        if idx in self._handoff_stall:
            self._fired_handoff(idx, "handoff_stall")
            raise HandoffTransitError(
                f"injected hand-off stall (hand-off {idx}: transfer never "
                f"completed; observed as a timed-out attempt)"
            )
        remaining = self._handoff_drop.get(idx, 0)
        if remaining > 0:
            self._handoff_drop[idx] = remaining - 1
            self._fired_handoff(idx, "handoff_drop")
            raise HandoffTransitError(f"injected hand-off payload loss (hand-off {idx})")

    def corrupt_handoff_payload(self, handoff: int, kv: Dict) -> Dict:
        """Hand-off ``handoff``'s delivered payload, truncated on the
        position axis and/or with a NaN in its K stream (the fp32 scales of
        a quantized payload: int8 codes have no NaN); a new dict, the
        payload's tensors untouched. Fires once per armed hand-off."""
        idx = int(handoff)
        if idx in self._handoff_truncate:
            self._handoff_truncate.discard(idx)
            kv = dict(kv)
            S = int(kv["k"].shape[2])
            keep = max(1, S // 2)
            kv["k"] = kv["k"][:, :, :keep]
            kv["v"] = kv["v"][:, :, :keep]
            self._fired_handoff(idx, "handoff_truncate", kept=keep, of=S)
        if idx in self._handoff_corrupt:
            self._handoff_corrupt.discard(idx)
            kv = dict(kv)
            key, at = ("k_scale", (0, 0)) if kv.get("quantized") else ("k", (0, 0, 0, 0, 0))
            kv[key] = kv[key].clone()
            kv[key][at] = float("nan")
            self._fired_handoff(idx, "handoff_corrupt")
        return kv


# ---------------------------------------------------------------------------
# device KV filling (shared with the session's scrub-on-release)
# ---------------------------------------------------------------------------


def fill_kv_rows(cache, row_ids, value: float):
    """Overwrite whole dim-1 rows (paged: block ids; contiguous: cache
    lines) of both streams of a KV cache with ``value``, across all layers,
    IN PLACE (the reference returns a new cache). Returns the cache.
    Quantized streams take only ``value == 0`` (zero codes dequantize to
    exactly 0; NaN has no int8 code), and raise ValueError otherwise, as
    the reference's do: a poison fault needs a float cache."""
    import torch

    from neuronx_distributed_inference_tpu_torch.modules.kvcache import QuantizedKV, cache_streams

    streams = cache_streams(cache)
    idx = torch.as_tensor(np.asarray(row_ids, np.int64), device=streams[0].device)
    if isinstance(streams[0], QuantizedKV) and value != 0:
        raise ValueError(
            "cannot write non-zero fill into a quantized KV stream "
            "(int8/fp8 codes; poison faults need a float cache)"
        )
    for stream in streams:
        (stream.data if isinstance(stream, QuantizedKV) else stream)[:, idx] = value
    return cache


def _poison_row(session, slot: int) -> bool:
    """NaN a live row's KV (paged: its allocated blocks; contiguous: its
    cache line, which is line ``slot``). Returns False when the slot holds
    nothing to poison."""
    nan = float("nan")
    if session.block_mode:
        blocks = session.allocator.seq_blocks.get(slot)
        if not blocks:
            return False
        session.app.kv_cache = fill_kv_rows(session.app.kv_cache, blocks, nan)
        return True
    session.app.kv_cache = fill_kv_rows(session.app.kv_cache, [slot], nan)
    return True


def _poison_garbage(session) -> None:
    """NaN the shared garbage sink: paged block 0, or the contiguous garbage
    line (the line after the session's slots)."""
    if session.block_mode:
        from neuronx_distributed_inference_tpu_torch.modules.block_kvcache import GARBAGE_BLOCK

        rows = [GARBAGE_BLOCK]
    else:
        rows = [session.num_slots]
    session.app.kv_cache = fill_kv_rows(session.app.kv_cache, rows, float("nan"))
