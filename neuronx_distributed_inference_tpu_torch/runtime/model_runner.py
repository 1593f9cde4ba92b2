"""Per-sub-model runners: bucket dispatch and host padding (counterpart of
the reference's ``runtime/model_runner.py``: ``SubModelRunner`` and the
ragged ``MixedStepRunner``).

The reference holds one jitted program per (bucket, batch); the port runs
eagerly, so a runner pads its inputs to the compiled batch and the bucket
and calls :func:`models.base.forward` / :func:`models.base.decode_steps`.
CUDA graphs per bucket are a later step (ROADMAP A3b).

On the paged cache (``block_kv``) a prefill carries a host ``slot_mapping``
(padded with -1, the garbage slot), a decode step carries only a
``block_table`` (its write slots are derived on the device), and a chunked
or prefix prefill pass — a multi-token token-generation pass — carries
both.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from neuronx_distributed_inference_tpu_torch.models.base import (
    PHASE_CONTEXT_ENCODING,
    Cache,
    MixedStepInputs,
    ModelSpec,
    StepInputs,
    StepOutput,
    decode_steps,
    forward,
    mixed_forward,
)
from neuronx_distributed_inference_tpu_torch.modules.autobucketing import get_target_bucket
from neuronx_distributed_inference_tpu_torch.modules.sampling import prepare_sampling_params

TAG_CONTEXT_ENCODING = "context_encoding_model"
TAG_TOKEN_GENERATION = "token_generation_model"
TAG_MIXED_STEP = "mixed_step_model"


class SubModelRunner:
    def __init__(
        self,
        tag: str,
        phase: str,
        spec: ModelSpec,
        buckets: List[int],
        batch_size: int,
        device: torch.device,
        mlp_fn: Callable,
        block_kv: bool = False,
        block_size: int = 16,
    ):
        self.tag = tag
        self.phase = phase
        self.spec = spec
        self.buckets = sorted(buckets)
        self.batch_size = batch_size
        self.device = device
        self.mlp_fn = mlp_fn
        self.block_kv = block_kv
        self.block_size = block_size
        # the bucket the last prepare()/decode_chunk resolved to (the serving
        # session's bucket census reads it)
        self.last_bucket: Optional[int] = None

    # ---- host-side padding ------------------------------------------------

    def _pad_batch(self, arrs: Dict[str, object], batch: int) -> Dict[str, torch.Tensor]:
        """Pad every array's batch dim to ``batch`` (seq_ids and slot_mapping
        pad with -1 so padded rows write to the garbage line or block, the
        rest with 0) and move it to the device. A tensor already on the
        device (a previous chunk's tokens) is padded there, without a host
        round trip."""
        out = {}
        for name, a in arrs.items():
            t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))
            t = t.to(self.device)
            pad = batch - t.shape[0]
            if pad < 0:
                raise ValueError(f"{self.tag}: input batch {t.shape[0]} > compiled batch {batch}")
            if pad:
                fill = -1 if name in ("seq_ids", "slot_mapping") else 0
                t = torch.cat([t, torch.full((pad,) + tuple(t.shape[1:]), fill, dtype=t.dtype, device=self.device)])
            out[name] = t
        return out

    def prepare(
        self,
        input_ids: np.ndarray,
        attention_mask: np.ndarray,
        position_ids: np.ndarray,
        seq_ids: np.ndarray,
        sampling_params: Optional[np.ndarray] = None,
        slot_mapping: Optional[np.ndarray] = None,
        block_table: Optional[np.ndarray] = None,
    ) -> Tuple[StepInputs, int]:
        """Pad to (compiled batch, bucket) and build StepInputs.
        ``input_ids`` may be a device tensor (an async decode step chained
        on the previous step's tokens)."""
        B, S = input_ids.shape
        if self.phase == PHASE_CONTEXT_ENCODING:
            bucket = get_target_bucket(self.buckets, S)
            pad_s = bucket - S
            if pad_s:
                input_ids = np.pad(input_ids, ((0, 0), (0, pad_s)))
                attention_mask = np.pad(attention_mask, ((0, 0), (0, pad_s)))
                # pad positions continue the sequence so padded K/V lands in
                # the masked tail, not on real slots
                tail = position_ids[:, -1:] + 1 + np.arange(pad_s)[None, :]
                position_ids = np.concatenate([position_ids, tail], axis=1)
                if slot_mapping is not None:
                    # padded tokens write to the garbage block
                    slot_mapping = np.pad(slot_mapping, ((0, 0), (0, pad_s)), constant_values=-1)
        else:
            # token generation (one token, or a multi-token chunked/prefix
            # prefill pass): bucket over the cache width
            bucket = get_target_bucket(self.buckets, attention_mask.shape[1])
            pad_s = bucket - attention_mask.shape[1]
            if pad_s:
                attention_mask = np.pad(attention_mask, ((0, 0), (0, pad_s)))
        self.last_bucket = bucket
        if sampling_params is None:
            sampling_params = prepare_sampling_params(B)
        arrs = {
            "input_ids": input_ids if isinstance(input_ids, torch.Tensor) else np.asarray(input_ids, np.int64),
            "attention_mask": np.asarray(attention_mask, np.int32),
            "position_ids": np.asarray(position_ids, np.int32),
            "seq_ids": np.asarray(seq_ids, np.int32),
            "sampling_params": np.asarray(sampling_params, np.float32),
        }
        if slot_mapping is not None:
            arrs["slot_mapping"] = np.asarray(slot_mapping, np.int32)
        if block_table is not None:
            arrs["block_table"] = np.asarray(block_table, np.int32)
        return StepInputs(**self._pad_batch(arrs, self.batch_size)), B

    @torch.no_grad()
    def __call__(self, params, cache: Cache, inputs: StepInputs) -> StepOutput:
        """Run one step; the cache is updated in place."""
        return forward(params, cache, inputs, spec=self.spec, phase=self.phase, mlp_fn=self.mlp_fn)

    @torch.no_grad()
    def decode_chunk(
        self,
        params,
        cache: Cache,
        last,  # (B, 1) np array or device tensor
        pos: np.ndarray,  # (B, 1)
        seq_ids: np.ndarray,
        sampling_params: np.ndarray,
        num_steps: int,
        bucket: int,
        block_table: Optional[np.ndarray] = None,
    ):
        """``num_steps`` decode steps with device-resident tokens.
        ``block_table`` (B, bucket // block_size) runs the chunk over the
        PAGED cache; blocks must be allocated for pos + num_steps.
        Returns (tokens (Bc, num_steps), logits | None, cache)."""
        self.last_bucket = bucket
        arrs = {
            "last": last,
            "pos": np.asarray(pos, np.int32),
            "seq_ids": np.asarray(seq_ids, np.int32),
            "sampling_params": np.asarray(sampling_params, np.float32),
        }
        if block_table is not None:
            arrs["block_table"] = np.asarray(block_table, np.int32)
        arrs = self._pad_batch(arrs, self.batch_size)
        return decode_steps(
            params, cache, arrs["last"], arrs["pos"], arrs["seq_ids"], arrs["sampling_params"],
            spec=self.spec, num_steps=num_steps, bucket=bucket, mlp_fn=self.mlp_fn,
            block_table=arrs.get("block_table"),
        )

    # ---- warmup ----------------------------------------------------------

    def example_inputs(self, bucket: int, q_len: Optional[int] = None) -> StepInputs:
        """A warmup step at one bucket. ``q_len`` builds a chunked/prefix
        prefill pass (multi-token token generation with both slot_mapping
        and block_table). On the paged cache the warmup writes go to the
        garbage block and the table reads block 0, with the same fields a
        real serving call carries (CTE: slot mapping; decode: block table;
        chunk pass: both)."""
        B = self.batch_size
        if self.phase == PHASE_CONTEXT_ENCODING:
            S = bucket
        else:
            S = q_len or 1
        arrs = {
            "input_ids": np.zeros((B, S), np.int64),
            "attention_mask": np.ones((B, bucket), np.int32),
            "position_ids": np.tile(np.arange(S, dtype=np.int32), (B, 1)),
            "seq_ids": np.arange(B, dtype=np.int32),
            "sampling_params": prepare_sampling_params(B),
        }
        if self.block_kv:
            if self.phase == PHASE_CONTEXT_ENCODING or q_len:
                arrs["slot_mapping"] = np.full((B, S), -1, np.int32)
            if self.phase != PHASE_CONTEXT_ENCODING:
                arrs["block_table"] = np.zeros((B, max(1, bucket // self.block_size)), np.int32)
        return StepInputs(**self._pad_batch(arrs, B))

    def warmup(self, params, cache: Cache, chunk_q_lens: Optional[List[int]] = None) -> Cache:
        """Run every bucket once, and each chunked-prefill q length at the
        largest bucket: builds the kernels and touches every shape before
        the first request (the reference compiles here; the port has no
        compile)."""
        for bucket in self.buckets:
            out = self(params, cache, self.example_inputs(bucket))
            cache = out.cache
        for q in chunk_q_lens or ():
            out = self(params, cache, self.example_inputs(self.buckets[-1], q_len=q))
            cache = out.cache
        return cache


class MixedStepRunner:
    """Runner of the ragged mixed prefill+decode serving step (the
    reference's ``MixedStepRunner``).

    Its bucket axis is the TOTAL packed query-token count of one serving
    step (prefill chunks and decode rows share it), crossed with the kv-width
    ladder the block table covers. One ``step()`` dispatch replaces the
    context/decode pair of the split path.

    Packing contract: row r's segment starts at ``row_start[r]``, a multiple
    of :attr:`q_tile`, and row index == serving slot == block-table row.
    :meth:`prepare` pads the packed axis to the bucket and the block table
    to the kv width, and moves every int32 descriptor to the device in ONE
    copy (from pinned memory on a card, so the copy does not wait for the
    step in flight)."""

    def __init__(
        self,
        spec: ModelSpec,
        buckets: List[int],  # total-query-token ladder
        num_rows: int,  # serving slot count (fixed R axis)
        device: torch.device,
        mlp_fn: Callable,
        block_size: int,
        kv_buckets: List[int],  # kv-width ladder (block-aligned decode buckets)
    ):
        from neuronx_distributed_inference_tpu_torch.ops.ragged_paged_attention import RAGGED_Q_TILE

        self.tag = TAG_MIXED_STEP
        self.spec = spec
        self.buckets = sorted(buckets)
        self.num_rows = num_rows
        self.device = device
        self.mlp_fn = mlp_fn
        self.block_size = block_size
        self.kv_buckets = sorted(kv_buckets)
        self.q_tile = RAGGED_Q_TILE
        self.last_bucket: Optional[int] = None

    def prepare(
        self,
        input_ids: np.ndarray,  # (T,) packed tokens
        positions: np.ndarray,  # (T,) absolute positions; -1 = padded
        slot_mapping: np.ndarray,  # (T,) flat paged write slots; -1 = garbage block
        row_start: np.ndarray,  # (R,)
        row_len: np.ndarray,  # (R,)
        ctx_len: np.ndarray,  # (R,)
        block_table: np.ndarray,  # (R, mb) covering each row's blocks
        width: int,  # kv width bucket (block-aligned)
        sampling_params: Optional[np.ndarray] = None,
        chain_src: Optional[np.ndarray] = None,  # (T,) int32; -1 = host id
        chain_tokens: Optional[torch.Tensor] = None,  # (R, 1) device tokens of the previous step
    ) -> Tuple[MixedStepInputs, int]:
        """Pad the packed axis to its total-token bucket and the block table
        to ``width // block_size`` columns; build MixedStepInputs. Returns
        (inputs, T_real). Without ``chain_src``/``chain_tokens`` inert
        values (all -1 / zeros) go in, so the synchronous and the pipelined
        step run the same program."""
        T = int(input_ids.shape[0])
        bucket = get_target_bucket(self.buckets, max(T, self.q_tile))
        R = self.num_rows
        mb = max(1, width // self.block_size)
        if block_table.shape[0] != R:
            raise ValueError(f"{self.tag}: block table has {block_table.shape[0]} rows, built for {R}")
        if block_table.shape[1] > mb:
            raise ValueError(
                f"{self.tag}: block table covers {block_table.shape[1]} blocks > width "
                f"bucket {width} ({mb} blocks)"
            )
        if chain_src is None:
            chain_src = np.full(T, -1, np.int32)
        # one int32 buffer: [ids, positions, slots, chain_src] (bucket each),
        # then the table (R, mb), row_start, row_len, ctx_len (R each)
        buf = np.zeros(4 * bucket + R * (mb + 3), np.int32)
        packed = buf[: 4 * bucket].reshape(4, bucket)
        packed[1:, T:] = -1
        for i, a in enumerate((input_ids, positions, slot_mapping, chain_src)):
            packed[i, :T] = a
        table = buf[4 * bucket : 4 * bucket + R * mb].reshape(R, mb)
        table[:, : block_table.shape[1]] = block_table
        rows = buf[4 * bucket + R * mb :].reshape(3, R)
        rows[0], rows[1], rows[2] = row_start, row_len, ctx_len
        dev = _to_device(buf, self.device)
        packed_d = dev[: 4 * bucket].view(4, 1, bucket)
        rows_d = dev[4 * bucket + R * mb :].view(3, R)
        if chain_tokens is None:
            chain_tokens = torch.zeros((R, 1), dtype=torch.int32, device=self.device)
        if sampling_params is None:
            sampling_params = prepare_sampling_params(R)
        self.last_bucket = bucket
        inputs = MixedStepInputs(
            input_ids=packed_d[0],
            position_ids=packed_d[1],
            slot_mapping=packed_d[2],
            block_table=dev[4 * bucket : 4 * bucket + R * mb].view(R, mb),
            row_start=rows_d[0],
            row_len=rows_d[1],
            ctx_len=rows_d[2],
            sampling_params=_to_device(np.asarray(sampling_params, np.float32), self.device),
            chain_src=packed_d[3],
            chain_tokens=chain_tokens,
        )
        return inputs, T

    @torch.no_grad()
    def __call__(self, params, cache: Cache, inputs: MixedStepInputs) -> StepOutput:
        """Run one mixed step; the cache is updated in place."""
        return mixed_forward(params, cache, inputs, spec=self.spec, mlp_fn=self.mlp_fn)

    # ---- warmup ----------------------------------------------------------

    def example_inputs(self, bucket: int, width: Optional[int] = None) -> MixedStepInputs:
        """A warmup step at one total-token bucket: as many rows as fit claim
        one q-tile decode segment each, their writes going to the garbage
        block and their reads off block 0, with the fields and shapes of a
        real serving call."""
        width = width if width is not None else self.kv_buckets[-1]
        R, tq = self.num_rows, self.q_tile
        n_fit = min(R, bucket // tq)
        ids = np.zeros(bucket, np.int32)
        pos = np.full(bucket, -1, np.int32)
        sm = np.full(bucket, -1, np.int32)
        row_start = np.zeros(R, np.int32)
        row_len = np.zeros(R, np.int32)
        ctx_len = np.zeros(R, np.int32)
        row_start[:n_fit] = np.arange(n_fit) * tq
        row_len[:n_fit] = 1
        ctx_len[:n_fit] = 1
        pos[row_start[:n_fit]] = 0
        bt = np.zeros((R, max(1, width // self.block_size)), np.int32)
        inputs, _ = self.prepare(ids, pos, sm, row_start, row_len, ctx_len, bt, width)
        return inputs

    def warmup(self, params, cache: Cache) -> Cache:
        """Run every total-token bucket once at the largest kv width
        (kernel builds included)."""
        for bucket in self.buckets:
            cache = self(params, cache, self.example_inputs(bucket)).cache
        return cache


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device``. To a card it goes from pinned memory
    without blocking: PyTorch's pinned-memory allocator keeps the buffer
    until the copy has run, and the copy is ordered on the current stream
    before the kernels that read it."""
    t = torch.from_numpy(a)
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)
