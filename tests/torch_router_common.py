"""Shared set-up of the router tests of the port (tests/test_torch_router*.py,
test_torch_elastic_router.py, test_torch_disagg.py, test_torch_telemetry.py):
the same tiny head_dim-64 Llama loaded from one HF state dict into JAX apps
and port apps (fp32, CPU), the reference's request set, and drains of a
single session and of a router on either package."""

from types import SimpleNamespace

import torch

from neuronx_distributed_inference_tpu.config import ChunkedPrefillConfig as JaxChunked
from neuronx_distributed_inference_tpu.config import TpuConfig
from neuronx_distributed_inference_tpu.models.llama import LlamaInferenceConfig as JaxLlamaConfig
from neuronx_distributed_inference_tpu.runtime import faults as jfaults
from neuronx_distributed_inference_tpu.runtime import replica as jreplica
from neuronx_distributed_inference_tpu.runtime import router as jrouter
from neuronx_distributed_inference_tpu.runtime import serving as jserving
from neuronx_distributed_inference_tpu.runtime.application import TpuModelForCausalLM
from neuronx_distributed_inference_tpu.telemetry import TelemetrySession as JaxTelemetry
from neuronx_distributed_inference_tpu_torch.config import ChunkedPrefillConfig, Config
from neuronx_distributed_inference_tpu_torch.models.llama import LlamaInferenceConfig
from neuronx_distributed_inference_tpu_torch.runtime import faults as tfaults
from neuronx_distributed_inference_tpu_torch.runtime import replica as treplica
from neuronx_distributed_inference_tpu_torch.runtime import router as trouter
from neuronx_distributed_inference_tpu_torch.runtime import serving as tserving
from neuronx_distributed_inference_tpu_torch.runtime.application import ModelForCausalLM
from neuronx_distributed_inference_tpu_torch.telemetry import TelemetrySession
from tests.conftest import make_random_hf_state_dict

HF = dict(
    model_type="llama", hidden_size=256, intermediate_size=256, num_attention_heads=4,
    num_key_value_heads=2, num_hidden_layers=2, vocab_size=128, rms_norm_eps=1e-5,
    rope_theta=10000.0, max_position_embeddings=256, hidden_act="silu", tie_word_embeddings=False,
)
BASE = dict(is_continuous_batching=True, batch_size=4, ctx_batch_size=1, seq_len=64, dtype="float32")
#: the reference's router config (tests/test_router.py::_paged_cfg)
PAGED = dict(
    is_block_kv_layout=True, pa_block_size=16, pa_num_blocks=24, is_chunked_prefill=True,
    chunked=dict(max_num_seqs=2, kernel_q_tile_size=16),
)
MODES = {
    "paged": PAGED,
    "prefix": {**PAGED, "is_prefix_caching": True},
    "contiguous": {},
    "prefill_stage": dict(is_prefill_stage=True),
}

#: the reference's request set: mixed prompt lengths (r2 prefills over
#: several chunks)
REQS = {
    "r1": dict(ids=[5, 17, 92, 41], gen=6),
    "r2": dict(ids=list(range(30, 52)), gen=6),
    "r3": dict(ids=[7, 7, 7], gen=5),
    "r4": dict(ids=[11, 23, 5, 99, 100, 3], gen=6),
    "r5": dict(ids=[64, 2, 90, 14], gen=5),
    "r6": dict(ids=[33, 88, 2], gen=6),
}

#: one namespace per package: a test body reads the same names off either
JAX_NS = SimpleNamespace(faults=jfaults, replica=jreplica, router=jrouter, serving=jserving, Telemetry=JaxTelemetry)
PORT_NS = SimpleNamespace(
    faults=tfaults, replica=treplica, router=trouter, serving=tserving, Telemetry=TelemetrySession
)


def _load(c):
    for k, v in HF.items():
        setattr(c, k, v)


def _kw(mode, **extra):
    kw = {**BASE, **MODES[mode], **extra}
    chunked = kw.pop("chunked", None)
    return kw, chunked


def jax_app(mode, sd, **extra):
    kw, chunked = _kw(mode, **extra)
    if chunked:
        kw["chunked_prefill_config"] = JaxChunked(**chunked)
    return TpuModelForCausalLM(None, JaxLlamaConfig(TpuConfig(**kw), load_config=_load)).load(state_dict=sd)


def port_app(mode, sd, **extra):
    kw, chunked = _kw(mode, **extra)
    if chunked:
        kw["chunked_prefill_config"] = ChunkedPrefillConfig(**chunked)
    cfg = LlamaInferenceConfig(Config(**kw, device="cpu"), load_config=_load)
    return ModelForCausalLM(None, cfg).load(state_dict=sd)


def state_dict():
    torch.set_num_threads(1)
    return make_random_hf_state_dict(JaxLlamaConfig(TpuConfig(**BASE), load_config=_load), seed=5)


class Apps:
    """Apps built once per module and handed out with fresh caches:
    ``get(pkg, mode, n, **extra)`` -> n apps of ``pkg`` ("jax" / "port")."""

    def __init__(self, sd):
        self.sd = sd
        self.built = {}

    def get(self, pkg, mode, n=2, **extra):
        key = (pkg, mode, repr(sorted(extra.items())))
        apps = self.built.setdefault(key, [])
        while len(apps) < n:
            apps.append((jax_app if pkg == "jax" else port_app)(mode, self.sd, **extra))
        for a in apps[:n]:
            a.init_kv_cache()
        return apps[:n]


def ns(pkg):
    return JAX_NS if pkg == "jax" else PORT_NS


def single_session_drain(pkg, app, reqs=REQS):
    """ONE session serving the whole request set (queuing at the front when
    slots run out): the reference the routed drains must equal."""
    app.init_kv_cache()
    sess = ns(pkg).serving.ServingSession(app)
    items = list(reqs.items())
    i = guard = 0
    while i < len(items):
        rid, spec = items[i]
        if sess.add_request(rid, spec["ids"], max_new_tokens=spec["gen"], eos_token_id=spec.get("eos")):
            i += 1
        else:
            sess.step()
        guard += 1
        assert guard < 500
    sess.run_to_completion()
    return {rid: list(sess.requests[rid].generated) for rid, _ in items}


def make_router(pkg, apps, reqs=REQS, policy="least_loaded", telemetry=None, injectors=None,
                session_kw=None, **router_kw):
    m = ns(pkg)
    for app in apps:
        app.init_kv_cache()
    sessions = [
        m.serving.ServingSession(
            app, fault_injector=injectors[i] if injectors else None, telemetry=telemetry, **(session_kw or {})
        )
        for i, app in enumerate(apps)
    ]
    router = m.router.ServingRouter(sessions, policy=policy, telemetry=telemetry, **router_kw)
    for rid, spec in reqs.items():
        assert router.add_request(rid, spec["ids"], max_new_tokens=spec["gen"], eos_token_id=spec.get("eos"))
    return router


def drain(router, max_steps=500):
    for _ in range(max_steps):
        if not router.has_live_work:
            break
        router.step()
    else:
        raise AssertionError("router failed to drain")
    return {rid: list(r.tokens) for rid, r in router.requests.items()}


def verdicts(router):
    """Every request's router status and reason, and the rejected ones."""
    out = {rid: (r.status, r.fail_reason) for rid, r in router.requests.items()}
    out.update({rid: (r.status, r.fail_reason) for rid, r in router.rejected.items()})
    return out


def family_counts(snapshot, names=None, skip=()):
    """{family: {labels: value or histogram count}} of a registry snapshot:
    what two packages' telemetry must agree on (wall-clock sums and bucket
    splits are not compared)."""
    out = {}
    for name, fam in snapshot.items():
        if (names is not None and name not in names) or name in skip:
            continue
        rows = {}
        for smp in fam["samples"]:
            key = tuple(sorted(smp["labels"].items()))
            rows[key] = smp["count"] if fam["type"] == "histogram" else smp["value"]
        out[name] = (fam["type"], rows)
    return out
