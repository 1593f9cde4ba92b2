"""Encoder-decoder application, Whisper speech to text (counterpart of the
reference's ``runtime/encoder_decoder.py``, ``TpuWhisperModel``).

Once a request the encoder and the forced ids' prefill run eagerly. Each
single-token decode step runs as ONE CUDA graph per (batch, encoder length)
(``runtime/graphs.GraphSet``), the counterpart of the reference's jitted
``_decode_fn`` with its donated cache: its static inputs are the last
tokens, the position, the cache mask, the finished rows and the encoder
states; the step writes the self-attention cache in place, takes the
argmax, fills finished rows with the first EOS id and advances token,
position and mask in place, so steps replay without the host. The host
reads the finished rows once a step only when an ``eos_token_id`` is given
(the loop stops when every row is done), as the reference's loop does.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from neuronx_distributed_inference_tpu_torch.config import InferenceConfig, resolve_device, to_dtype
from neuronx_distributed_inference_tpu_torch.models.whisper import (
    convert_whisper_state_dict,
    whisper_decoder_step,
    whisper_encoder,
    whisper_spec,
)
from neuronx_distributed_inference_tpu_torch.modules.kvcache import init_cache
from neuronx_distributed_inference_tpu_torch.runtime.application import GenerationOutput
from neuronx_distributed_inference_tpu_torch.runtime.graphs import GraphSet, binding
from neuronx_distributed_inference_tpu_torch.runtime.model_runner import as_device_tensor

TAG_WHISPER_DECODE = "whisper_decode"


class WhisperModel:
    """Whisper speech to text (the reference's ``TpuWhisperModel``)."""

    def __init__(self, model_path: Optional[str], config: InferenceConfig):
        self.config = config
        self.model_path = model_path
        self.spec = whisper_spec(config)
        self.decoder_start = getattr(config, "decoder_start_token_id", 1)
        tc = config.torch_config
        self.device = resolve_device(tc.device)
        self.dtype = to_dtype(tc.dtype)
        self.batch = tc.batch_size
        self.max_len = min(tc.seq_len, self.spec.max_target_positions)
        self.params = None
        self.kv_cache = None
        self.graphs: Optional[GraphSet] = None
        self._decode: Dict[Tuple[int, int, int], list] = {}

    def load(self, model_path=None, state_dict=None, params=None):
        """An HF state dict converted in the config's dtype, or ``params``
        in the port's layout taken as they are (the card seeds them on the
        device). A checkpoint path is refused."""
        if params is None:
            if state_dict is None:
                raise NotImplementedError(
                    "loading a checkpoint from a path is not ported to PyTorch yet "
                    "(ROADMAP A11); pass state_dict= or params="
                )
            params = convert_whisper_state_dict(state_dict, self.spec, self.dtype, self.device)
        self.params = params
        self.kv_cache = init_cache(
            self.spec.decoder_layers, self.batch, self.max_len, self.spec.num_heads, self.spec.head_dim,
            self.dtype, device=self.device,
        )
        if self.graphs is not None:
            self.graphs.close()
        self.graphs = GraphSet(self.device, self.config.torch_config.cuda_graphs)
        self._decode = {}
        return self

    def _fresh_cache(self):
        """Zero the self-attention cache in place (the graphs hold its
        addresses)."""
        self.kv_cache.k.zero_()
        self.kv_cache.v.zero_()
        return self.kv_cache

    @torch.no_grad()
    def encode(self, input_features) -> torch.Tensor:
        """(B, num_mel_bins, T) log-mel -> (B, T // 2, d_model)."""
        if self.params is None:
            raise RuntimeError("call load() first")
        return whisper_encoder(self.params["encoder"], as_device_tensor(input_features, self.device), self.spec)

    def _decode_program(self, B: int, T: int, n_eos: int) -> list:
        """Batch ``B``'s decode statics and step over ``T`` encoder states
        with ``n_eos`` EOS ids (one graph a key)."""
        ent = self._decode.get((B, T, n_eos))
        if ent is None:
            dev = self.device
            W = self.max_len
            st = SimpleNamespace(
                last=torch.zeros((B, 1), dtype=torch.int32, device=dev),
                pos=torch.zeros((B, 1), dtype=torch.int32, device=dev),
                cache_mask=torch.zeros((B, W), dtype=torch.int32, device=dev),
                done=torch.zeros((B,), dtype=torch.bool, device=dev),
                eos=torch.zeros((n_eos,), dtype=torch.int32, device=dev),
                enc=torch.zeros((B, T, self.spec.d_model), dtype=self.dtype, device=dev),
                cols=torch.arange(W, dtype=torch.int32, device=dev)[None, :],
            )

            def body():
                logits = whisper_decoder_step(
                    self.params["decoder"], self.kv_cache, st.last, st.pos, st.cache_mask, st.enc, self.spec
                )
                tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
                tok = torch.where(st.done, st.eos[0], tok)
                st.done.logical_or_(torch.isin(tok, st.eos))
                st.last.copy_(tok[:, None])
                st.pos.add_(1)
                st.cache_mask.copy_((st.cols <= st.pos).to(torch.int32))
                return tok

            ent = self._decode[(B, T, n_eos)] = [st, body, None]
        return ent

    def _decode_step(self, ent) -> torch.Tensor:
        """One decode step: the graph's replay, or at first use an eager run
        that is then captured. Returns the step's (B,) tokens (a copy)."""
        st, body, graph = ent
        gs = self.graphs
        if graph is not None:
            graph.check_binding(binding(self.params, self.kv_cache), TAG_WHISPER_DECODE)
            graph.replay()
            return graph.outputs.clone()
        if not gs.enabled:
            return body()
        scope = gs.scope(TAG_WHISPER_DECODE, *st.enc.shape[:2], st.eos.shape[0])
        out = gs.eager(scope, body)
        ent[2] = gs.capture(scope, body, binding(self.params, self.kv_cache))
        return out

    @torch.no_grad()
    def generate(
        self,
        input_features,
        decoder_input_ids: Optional[np.ndarray] = None,
        max_new_tokens: int = 64,
        eos_token_id: Optional[int] = None,
    ) -> GenerationOutput:
        """Greedy transcription: encode once, prefill the forced decoder ids
        in one pass, then single-token decode steps to EOS / max. A row that
        emitted an EOS id emits the first one from then on; the loop ends
        when every row is done, at ``max_new_tokens`` tokens or at
        ``max_len`` positions."""
        dev = self.device
        enc = self.encode(input_features)
        B, T = enc.shape[:2]
        if decoder_input_ids is None:
            decoder_input_ids = np.full((B, 1), self.decoder_start, np.int64)
        decoder_input_ids = np.asarray(decoder_input_ids)
        S0 = decoder_input_ids.shape[1]
        cache = self._fresh_cache()
        W = self.max_len

        pos = torch.arange(S0, dtype=torch.int32, device=dev)[None, :].expand(B, S0).contiguous()
        cache_mask = (torch.arange(W, device=dev)[None, :] < S0).to(torch.int32).expand(B, W).contiguous()
        logits = whisper_decoder_step(
            self.params["decoder"], cache, torch.as_tensor(decoder_input_ids, dtype=torch.int32, device=dev), pos,
            cache_mask, enc, self.spec,
        )
        first = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        tokens = [first]
        eos_arr = np.atleast_1d(np.asarray(eos_token_id)) if eos_token_id is not None else None
        done = np.zeros(B, bool)
        if eos_arr is not None:
            done |= np.isin(first.cpu().numpy(), eos_arr)
        p = S0
        if max_new_tokens > 1 and p < W and not done.all():
            # no EOS id: -1, which no argmax takes, so no row is ever done
            eos_ids = eos_arr if eos_arr is not None else np.array([-1])
            ent = self._decode_program(B, T, len(eos_ids))
            st = ent[0]
            st.last.copy_(first[:, None])
            st.pos.fill_(p)
            st.cache_mask.copy_((st.cols <= p).to(torch.int32))
            st.enc.copy_(enc)
            st.done.copy_(torch.as_tensor(done, device=dev))
            st.eos.copy_(torch.as_tensor(eos_ids, dtype=torch.int32, device=dev))
            while len(tokens) < max_new_tokens and p < W and not done.all():
                nxt = self._decode_step(ent)
                tokens.append(nxt)
                p += 1
                if eos_arr is not None:
                    done |= np.isin(nxt.cpu().numpy(), eos_arr)
        gen = torch.stack(tokens, dim=1).cpu().numpy().astype(np.int64)
        sequences = np.concatenate([decoder_input_ids, gen], axis=1)
        return GenerationOutput(sequences=sequences, num_generated=gen.shape[1])
