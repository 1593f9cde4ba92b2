"""Mllama (Llama-3.2-Vision) application: vision tower -> cross-KV prefill ->
cross-attention decode (counterpart of the reference's
``runtime/mllama.py``).

Once a request the vision tower and the prefill run eagerly: the tower
(plain PyTorch) over each row's tiles, the projector, then the text
prefill, which writes the self-attention cache (through B2a) and each cross
layer's K / V of the vision states into the cross-KV stream. Each decode
step runs as ONE CUDA graph per batch size (``runtime/graphs.GraphSet``;
the reference's jitted decode step): its static inputs are the last token,
the position, the seq ids, the prompt's last cross-mask row and its
full-text-row flag; the step advances token and position in place, so the
steps replay without the host. Self-attention decodes through B1; the cross
layers read the stream in plain PyTorch.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from neuronx_distributed_inference_tpu_torch.config import InferenceConfig, resolve_device, to_dtype
from neuronx_distributed_inference_tpu_torch.models.base import (
    PHASE_CONTEXT_ENCODING,
    PHASE_TOKEN_GENERATION,
    ModelSpec,
    StepInputs,
    flat_layers,
)
from neuronx_distributed_inference_tpu_torch.models.mllama import (
    NEG_INF,
    convert_mllama_vision_state_dict,
    init_mllama_cache,
    mllama_text_forward,
    mllama_vision_encoder,
    mllama_vision_spec,
    prepare_cross_attention_mask,
)
from neuronx_distributed_inference_tpu_torch.models.pixtral import stack_layers, tower_tensor
from neuronx_distributed_inference_tpu_torch.modules.attention import AttnSpec
from neuronx_distributed_inference_tpu_torch.modules.rope import compute_inv_freq
from neuronx_distributed_inference_tpu_torch.modules.sampling import prepare_sampling_params
from neuronx_distributed_inference_tpu_torch.runtime.application import GenerationOutput
from neuronx_distributed_inference_tpu_torch.runtime.graphs import GraphSet
from neuronx_distributed_inference_tpu_torch.runtime.model_runner import as_device_tensor

TAG_MLLAMA_DECODE = "mllama_decode"


class MllamaForConditionalGeneration:
    """Cross-attention multimodal app (the reference's
    ``MllamaForConditionalGeneration``)."""

    def __init__(self, model_path: Optional[str], config: InferenceConfig):
        self.config = config
        self.model_path = model_path
        tc = config.torch_config
        txt, vis = config.text_config, config.vision_config
        tg = txt.get if isinstance(txt, dict) else lambda k, d=None: getattr(txt, k, d)
        self._tg = tg
        H = tg("hidden_size")
        heads = tg("num_attention_heads")
        kv = tg("num_key_value_heads", heads)
        self.hidden_size = H
        self.head_dim = H // heads
        self.cross_layers: List[int] = sorted(tg("cross_attention_layers"))
        self.num_layers = tg("num_hidden_layers")
        self.num_self = self.num_layers - len(self.cross_layers)
        # the layer order as runs: ('self', run length) / ('cross', local index)
        runs: List[Tuple] = []
        local = run_len = 0
        for i in range(self.num_layers):
            if i in self.cross_layers:
                if run_len:
                    runs.append(("self", run_len))
                    run_len = 0
                runs.append(("cross", local))
                local += 1
            else:
                run_len += 1
        if run_len:
            runs.append(("self", run_len))
        self.runs = tuple(runs)
        self.vision_spec = mllama_vision_spec(vis)
        self.device = resolve_device(tc.device)
        self.dtype = to_dtype(tc.dtype)
        eps = tg("rms_norm_eps", 1e-5)
        self.spec = ModelSpec(
            num_layers=self.num_self,
            vocab_size=tg("vocab_size"),
            attn=AttnSpec(
                num_heads=heads, num_kv_heads=kv, head_dim=self.head_dim, rms_norm_eps=eps,
                softmax_fp32=tc.attention_softmax_fp32, use_flash_kernel=tc.attn_kernel_enabled,
                use_tkg_kernel=tc.attn_block_tkg_kernel_enabled,
            ),
            rms_eps=eps,
            act=tg("hidden_act", "silu"),
            output_logits=tc.output_logits,
            attention_scaling=1.0,
        )
        self.params = None
        self.cache = None
        self.graphs: Optional[GraphSet] = None
        self._decode: Dict[int, tuple] = {}

    # ---- params ----------------------------------------------------------

    def convert_hf_state_dict(self, sd: Dict, dtype=None) -> Dict:
        """An HF MllamaForConditionalGeneration state dict -> the params
        tree: ``vision``, ``projector``, ``embed_tokens`` (vocab + 8 rows),
        ``rope``, ``self_runs`` (a stacked tree a run of self layers),
        ``cross_layers`` (a list), ``norm``, ``lm_head``; on the device."""
        dtype = dtype or self.dtype
        dev = self.device

        def get(name):
            if name not in sd:
                raise KeyError(f"missing HF weight {name}")
            v = sd[name]
            return v.float().numpy() if isinstance(v, torch.Tensor) else np.asarray(v, np.float32)

        def lt(name):
            return get(name).T

        def t(a):
            return tower_tensor(a, dtype, dev)

        def mlp(p):
            return {n: {"weight": lt(p + f"mlp.{n}.weight")} for n in ("gate_proj", "up_proj", "down_proj")}

        tpre = "model.language_model."
        self_runs, cross_params = [], []
        i = 0
        for kind, n in self.runs:
            if kind == "self":
                layers = []
                for j in range(i, i + n):
                    p = tpre + f"layers.{j}."
                    layers.append({
                        "input_layernorm": {"weight": get(p + "input_layernorm.weight")},
                        "post_attention_layernorm": {"weight": get(p + "post_attention_layernorm.weight")},
                        "self_attn": {
                            m: {"weight": lt(p + f"self_attn.{m}.weight")} for m in ("q_proj", "k_proj", "v_proj", "o_proj")
                        },
                        "mlp": mlp(p),
                    })
                self_runs.append(stack_layers(layers, dtype, dev))
                i += n
            else:
                p = tpre + f"layers.{i}."
                ca = {m: {"weight": t(lt(p + f"cross_attn.{m}.weight"))} for m in ("q_proj", "k_proj", "v_proj", "o_proj")}
                ca["q_norm"] = {"weight": t(get(p + "cross_attn.q_norm.weight"))}
                ca["k_norm"] = {"weight": t(get(p + "cross_attn.k_norm.weight"))}
                cross_params.append({
                    "input_layernorm": {"weight": t(get(p + "input_layernorm.weight"))},
                    "post_attention_layernorm": {"weight": t(get(p + "post_attention_layernorm.weight"))},
                    "cross_attn": ca,
                    "cross_attn_attn_gate": t(get(p + "cross_attn_attn_gate")),
                    "cross_attn_mlp_gate": t(get(p + "cross_attn_mlp_gate")),
                    "mlp": {k: {"weight": t(v["weight"])} for k, v in mlp(p).items()},
                })
                i += 1
        rope_cfg = SimpleNamespace(
            hidden_size=self.hidden_size, num_attention_heads=self.spec.attn.num_heads,
            rope_theta=self._tg("rope_theta", 500000.0), rope_scaling=self._tg("rope_scaling"), head_dim=self.head_dim,
        )
        return {
            "vision": convert_mllama_vision_state_dict(sd, self.vision_spec, "model.vision_model.", dtype, dev),
            "projector": {
                "weight": t(lt("model.multi_modal_projector.weight")),
                "bias": t(get("model.multi_modal_projector.bias")),
            },
            "embed_tokens": {"weight": t(get(tpre + "embed_tokens.weight"))},
            "rope": {"inv_freq": compute_inv_freq(rope_cfg).float().to(dev)},
            "self_runs": self_runs,
            "cross_layers": cross_params,
            "norm": {"weight": t(get(tpre + "norm.weight"))},
            "lm_head": {"weight": t(lt("lm_head.weight"))},
        }

    def load(self, model_path=None, state_dict=None, random_weights: bool = False, params=None):
        """An HF state dict, or ``params`` in the port's layout taken as
        they are (the card seeds them on the device). The int8/fp8 KV cache
        and random weights are refused, as in the reference."""
        tc = self.config.torch_config
        if tc.kv_quantized:
            raise NotImplementedError(
                "kv_cache_dtype int8/fp8 is not implemented for the mllama self+cross cache (no scale "
                "streams); use a plain kv dtype (ROADMAP C (Mllama's quantized KV cache))"
            )
        if random_weights:
            raise NotImplementedError(
                "mllama random-weight init is test-only; pass an HF state dict "
                "(ROADMAP C (Mllama's random weights))"
            )
        if params is None:
            if state_dict is None:
                raise NotImplementedError(
                    "loading a checkpoint from a path is not ported to PyTorch yet "
                    "(ROADMAP A11); pass state_dict= or params="
                )
            params = self.convert_hf_state_dict(state_dict)
        params = dict(params)
        params["self_runs"] = [flat_layers(run) for run in params["self_runs"]]
        self.params = params
        aspec = self.spec.attn
        vs = self.vision_spec
        self.num_vision_tokens = vs.num_patches
        self.max_sv = self._tg("max_num_images", 1) * vs.max_num_tiles * vs.num_patches
        self.cache = init_mllama_cache(
            self.num_self, len(self.cross_layers), tc.max_batch_size, tc.seq_len, self.max_sv, aspec.num_kv_heads,
            aspec.head_dim, to_dtype(tc.kv_cache_dtype or tc.dtype), self.device,
        )
        if self.graphs is not None:
            self.graphs.close()
        self.graphs = GraphSet(self.device, tc.cuda_graphs)
        self._decode = {}
        return self

    @property
    def cross_kv_nbytes(self) -> int:
        """Device bytes of the cross-KV stream (both tensors)."""
        return sum(t.numel() * t.element_size() for t in (self.cache.cross_k, self.cache.cross_v))

    # ---- generation ------------------------------------------------------

    @torch.no_grad()
    def encode(self, pixel_values, aspect_ratio_ids, aspect_ratio_mask) -> torch.Tensor:
        """The vision tower, one batch row a call (each row's tiles attend
        together; one row's fp32 scores at a time), then the projector:
        (B, num_img * tiles * patches, H) cross states in the compute
        dtype."""
        dev = self.device
        px = as_device_tensor(pixel_values, dev)
        ar = as_device_tensor(aspect_ratio_ids, dev).long()
        am = as_device_tensor(aspect_ratio_mask, dev)
        rows = [
            mllama_vision_encoder(self.params["vision"], px[b : b + 1], ar[b : b + 1], am[b : b + 1], self.vision_spec)
            for b in range(px.shape[0])
        ]
        vision_out = torch.cat(rows, dim=0)  # (B, NI, T, np, vd)
        proj = self.params["projector"]
        return (vision_out @ proj["weight"] + proj["bias"]).reshape(px.shape[0], -1, self.hidden_size)

    def _decode_program(self, B: int):
        """Batch ``B``'s decode statics and step (one graph a batch)."""
        ent = self._decode.get(B)
        if ent is None:
            dev = self.device
            st = SimpleNamespace(
                last=torch.zeros((B, 1), dtype=torch.int32, device=dev),
                pos=torch.zeros((B, 1), dtype=torch.int32, device=dev),
                seq_ids=torch.zeros((B,), dtype=torch.int32, device=dev),
                cross_mask=torch.zeros((B, 1, 1, self.max_sv), dtype=torch.float32, device=dev),
                full_row=torch.zeros((B, 1, 1), dtype=torch.float32, device=dev),
                cols=torch.arange(self.config.torch_config.seq_len, dtype=torch.int32, device=dev)[None, :],
                sampling=torch.as_tensor(prepare_sampling_params(B), device=dev),
            )

            def body():
                inputs = StepInputs(
                    input_ids=st.last, attention_mask=(st.cols <= st.pos).to(torch.int32), position_ids=st.pos,
                    seq_ids=st.seq_ids, sampling_params=st.sampling,
                )
                logits, _ = mllama_text_forward(
                    self.params, self.cache, inputs, st.cross_mask, st.full_row, None, spec=self.spec, runs=self.runs,
                    phase=PHASE_TOKEN_GENERATION,
                )
                tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
                st.last.copy_(tok[:, None])
                st.pos.add_(1)
                return tok

            ent = self._decode[B] = [st, body, None]
        return ent

    def _binding(self):
        c = self.cache
        return (id(self.params), c.k.data_ptr(), c.v.data_ptr(), c.cross_k.data_ptr(), c.cross_v.data_ptr())

    def _decode_step(self, ent) -> torch.Tensor:
        """One decode step: the graph's replay, or at first use an eager run
        that is then captured. Returns the step's (B,) tokens (a copy)."""
        st, body, graph = ent
        gs = self.graphs
        if graph is not None:
            graph.check_binding(self._binding(), TAG_MLLAMA_DECODE)
            graph.replay()
            return graph.outputs.clone()
        if not gs.enabled:
            return body()
        scope = gs.scope(TAG_MLLAMA_DECODE, st.last.shape[0])
        out = gs.eager(scope, body)
        ent[2] = gs.capture(scope, body, self._binding())
        return out

    def generate(
        self,
        input_ids: np.ndarray,  # (B, S)
        attention_mask: Optional[np.ndarray],
        pixel_values: np.ndarray,  # (B, num_img, tiles, C, Hp, Wp)
        aspect_ratio_ids: np.ndarray,  # (B, num_img)
        aspect_ratio_mask: np.ndarray,  # (B, num_img, tiles)
        cross_attention_mask: np.ndarray,  # (B, S, num_img, tiles)
        max_new_tokens: int = 16,
    ) -> GenerationOutput:
        """Greedy generation: the tower and the prefill eagerly, then
        ``max_new_tokens - 1`` decode steps through the batch's graph, each
        reading the prompt's LAST cross-mask row (HF's
        prepare_inputs_for_generation extends the mask so)."""
        dev = self.device
        input_ids = np.asarray(input_ids)
        B, S = input_ids.shape
        attention_mask = np.ones_like(input_ids) if attention_mask is None else np.asarray(attention_mask)
        with torch.no_grad():
            cross_states = self.encode(pixel_values, aspect_ratio_ids, aspect_ratio_mask)
            sv = cross_states.shape[1]
            if sv != self.max_sv:
                # the vision-token axis padded to the stream's width
                cross_states = torch.nn.functional.pad(cross_states, (0, 0, 0, self.max_sv - sv))
            add_mask, full_row = prepare_cross_attention_mask(
                np.asarray(cross_attention_mask, np.float32), self.num_vision_tokens
            )
            if add_mask.shape[-1] != self.max_sv:
                # padded vision tokens are never attended
                add_mask = np.pad(
                    add_mask, ((0, 0), (0, 0), (0, 0), (0, self.max_sv - add_mask.shape[-1])), constant_values=NEG_INF
                )
            seq_ids = np.arange(B, dtype=np.int32)
            inputs = StepInputs(
                input_ids=torch.as_tensor(input_ids, dtype=torch.int64, device=dev),
                attention_mask=torch.as_tensor(attention_mask, dtype=torch.int32, device=dev),
                position_ids=torch.arange(S, dtype=torch.int32, device=dev)[None, :].expand(B, S).contiguous(),
                seq_ids=torch.as_tensor(seq_ids, device=dev),
                sampling_params=torch.as_tensor(prepare_sampling_params(B), device=dev),
            )
            logits, _ = mllama_text_forward(
                self.params, self.cache, inputs, torch.as_tensor(add_mask, dtype=torch.float32, device=dev),
                torch.as_tensor(full_row, device=dev), cross_states, spec=self.spec, runs=self.runs,
                phase=PHASE_CONTEXT_ENCODING,
            )
            tokens = [torch.argmax(logits[:, -1], dim=-1).to(torch.int32)]
            if max_new_tokens > 1:
                ent = self._decode_program(B)
                st = ent[0]
                st.last.copy_(tokens[0][:, None])
                st.pos.copy_(torch.as_tensor(attention_mask.sum(axis=1)[:, None], dtype=torch.int32, device=dev))
                st.seq_ids.copy_(torch.as_tensor(seq_ids, device=dev))
                st.cross_mask.copy_(torch.as_tensor(add_mask[:, :, -1:, :], dtype=torch.float32, device=dev))
                st.full_row.copy_(torch.as_tensor(full_row[:, -1:, :], device=dev))
                for _ in range(1, max_new_tokens):
                    tokens.append(self._decode_step(ent))
            gen = torch.stack(tokens, dim=1).cpu().numpy().astype(np.int64)
        sequences = np.concatenate([input_ids, gen], axis=1)
        return GenerationOutput(sequences=sequences, logits=None, num_generated=gen.shape[1])
