"""Medusa application: the target and its prediction heads, one program per
phase (counterpart of the reference's ``runtime/medusa.py``).

:class:`MedusaModelForCausalLM` runs on the speculation apps' host loop
(``runtime/fused_spec._SpecAppBase``): a prefill that stashes the last
hidden state, then rounds of ``modules/medusa.medusa_token_gen`` (the heads'
k - 1 proposals and one k-token verify pass), each captured as one CUDA
graph. The params carry ``medusa_heads``: ``res`` (weight (n, H, H), bias
(n, H)) and ``lm_head`` (weight (n, H, Vpad)), stacked by head.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from neuronx_distributed_inference_tpu_torch.config import InferenceConfig
from neuronx_distributed_inference_tpu_torch.models import get_model_builder
from neuronx_distributed_inference_tpu_torch.models.base import prepare_params, unstack_layers
from neuronx_distributed_inference_tpu_torch.models.builder import _to_torch, hf_array
from neuronx_distributed_inference_tpu_torch.modules.eagle import init_hidden_buffer
from neuronx_distributed_inference_tpu_torch.modules.kvcache import cache_streams, init_cache, zero_stream
from neuronx_distributed_inference_tpu_torch.modules.medusa import medusa_context_encoding, medusa_token_gen
from neuronx_distributed_inference_tpu_torch.ops.quant import prepare_int4_params, prepare_quantized_params
from neuronx_distributed_inference_tpu_torch.runtime.fused_spec import _SpecAppBase
from neuronx_distributed_inference_tpu_torch.runtime.graphs import binding

TAG_MEDUSA_CTE = "medusa:cte"
TAG_MEDUSA_TKG = "medusa:tkg"

#: std of random head weights (the reference's)
HEAD_STD = 0.05


class MedusaModelForCausalLM(_SpecAppBase):
    """Medusa speculation (the reference's ``TpuMedusaModelForCausalLM``):
    ``medusa_speculation_length`` k tokens verified a round, proposed by
    ``num_medusa_heads`` >= k - 1 heads. Greedy only, over the contiguous
    cache, for models of the shared decoder layer."""

    def __init__(self, model_path: Optional[str], config: InferenceConfig):
        tc = config.torch_config
        self.k = tc.medusa_speculation_length
        self.reserve_slots = self.k
        self.num_heads = tc.num_medusa_heads
        if self.k < 2:
            raise ValueError("medusa_speculation_length must be >= 2")
        if self.num_heads < self.k - 1:
            raise ValueError(
                f"medusa needs num_medusa_heads >= speculation_length-1 "
                f"({self.num_heads} < {self.k - 1})"
            )
        if tc.is_block_kv_layout:
            raise NotImplementedError(
                "medusa with the paged cache or context parallelism is not "
                "implemented"
            )
        ods = tc.on_device_sampling_config
        if ods and ods.do_sample:
            raise NotImplementedError(
                "medusa verification is greedy-only; for sampled speculation "
                "use fused speculation's multinomial accept/reject"
            )
        self.model_path = model_path
        self.builder = get_model_builder(getattr(config, "model_type", "llama"))(config)
        if self.builder.layer_fn() is not None:
            raise NotImplementedError(
                "medusa over models with custom decoder layers (MLA, Llama4) "
                "is not implemented"
            )
        self.spec = self.builder.model_spec()
        self.mlp_fn = self.builder.mlp_fn()
        tags = (TAG_MEDUSA_CTE, TAG_MEDUSA_TKG)
        super().__init__(config, self.builder.device, tags, self.builder.host_read_tokens())
        self.params = None
        self.kv_cache = None
        self.hidden_buffer = None

    def load(self, state_dict=None, medusa_head_state_dict=None, random_weights: bool = False, params=None):
        """The target's weights with its heads, the cache and the hidden
        buffer. ``random_weights``: the target seeded from ``Config.seed``,
        the heads from ``seed + 3`` (residual weights and lm heads of std
        0.05, zero biases); ``state_dict``: an HF state dict, the heads
        from ``medusa_head_state_dict`` or the same dict
        (:meth:`_convert_medusa_heads`); ``params``: ready params holding
        ``medusa_heads``, taken as they are."""
        tc = self.config.torch_config
        if params is None:
            if random_weights:
                params = self.builder.random_params()
                params["medusa_heads"] = self.random_heads()
            elif state_dict is not None:
                params = self.builder.convert_hf_state_dict(state_dict)
                params["medusa_heads"] = self._convert_medusa_heads(medusa_head_state_dict or state_dict)
            else:
                raise NotImplementedError(
                    "loading a checkpoint from a path is not ported to PyTorch yet "
                    "(ROADMAP A11); pass state_dict=, params= or random_weights=True"
                )
            if tc.quantized:
                params = prepare_quantized_params(params, tc)
            elif tc.weight_int4:
                params = prepare_int4_params(params, tc)
        params = prepare_params(params)
        params["medusa_heads"] = unstack_layers(params["medusa_heads"])
        self.params = params
        kv_batch = tc.kv_cache_batch_size or tc.max_batch_size
        a = self.spec.attn
        self.kv_cache = init_cache(
            self.spec.num_layers, kv_batch, tc.seq_len, a.num_kv_heads, a.head_dim, dtype=tc.kv_dtype,
            device=self.device,
        )
        self.hidden_buffer = init_hidden_buffer(kv_batch, self.config.hidden_size, tc.torch_dtype, self.device)
        self._bind_graphs()
        return self

    def random_heads(self) -> Dict:
        """Seeded random heads (``Config.seed + 3``; residual weights and lm
        heads of std 0.05, zero biases), made on the device one head at a
        time."""
        n, H, V = self.num_heads, self.config.hidden_size, self.builder.padded_vocab
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.config.torch_config.seed + 3)
        dt = self.config.torch_config.torch_dtype

        def normal(shape):
            out = torch.empty(shape, dtype=dt, device=self.device)
            for part in out:  # one head at a time: a head's fp32 transient only
                part.copy_(torch.randn(part.shape, generator=gen, device=self.device).mul_(HEAD_STD))
            return out

        return {
            "res": {"weight": normal((n, H, H)), "bias": torch.zeros((n, H), dtype=dt, device=self.device)},
            "lm_head": {"weight": normal((n, H, V))},
        }

    def _convert_medusa_heads(self, sd: Dict) -> Dict:
        """Heads of a Medusa checkpoint: ``{i}.0.linear.weight`` / ``.bias``
        (the residual block) and ``{i}.1.weight`` (the head's lm head), with
        or without a ``medusa_head.`` / ``medusa_heads.`` prefix."""
        V, dt = self.builder.padded_vocab, self.config.torch_config.torch_dtype

        def get(i, suffix):
            for prefix in ("", "medusa_head.", "medusa_heads."):
                name = f"{prefix}{i}.{suffix}"
                if name in sd:
                    return hf_array(sd, name)
            raise KeyError(f"missing medusa head weight {i}.{suffix}")

        res_w, res_b, lm = [], [], []
        for i in range(self.num_heads):
            res_w.append(get(i, "0.linear.weight").T)
            res_b.append(get(i, "0.linear.bias"))
            w = get(i, "1.weight").T  # (H, V_orig)
            lm.append(np.pad(w, ((0, 0), (0, V - w.shape[1]))))
        return {
            "res": {"weight": _to_torch(np.stack(res_w), dt, self.device),
                    "bias": _to_torch(np.stack(res_b), dt, self.device)},
            "lm_head": {"weight": _to_torch(np.stack(lm), dt, self.device)},
        }

    def init_kv_cache(self):
        """Zero the cache and the hidden buffer in place."""
        for stream in cache_streams(self.kv_cache):
            zero_stream(stream)
        self.hidden_buffer.zero_()

    def _binding(self):
        return binding(self.params, self.kv_cache) + (self.hidden_buffer.data_ptr(),)

    def _cte_step(self, inputs, gen):
        return medusa_context_encoding(
            self.params, self.kv_cache, self.hidden_buffer, inputs, gen, spec=self.spec, mlp_fn=self.mlp_fn,
            max_topk=self.config.torch_config.max_topk,
        )

    def _tkg_step(self, inputs, gen, bucket):
        return medusa_token_gen(
            self.params, self.kv_cache, self.hidden_buffer, inputs, gen, spec_len=self.k, bucket=bucket,
            spec=self.spec, mlp_fn=self.mlp_fn,
        )
