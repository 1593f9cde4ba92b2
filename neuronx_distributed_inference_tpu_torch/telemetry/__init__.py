"""Serving telemetry of the port (counterpart of the reference's
``telemetry/``): the metric registry, the span timeline and the
request-lifecycle session. The SLO monitor and the ops server wait for
ROADMAP A8 (workload and SLO)."""

from neuronx_distributed_inference_tpu_torch.telemetry.metrics import (  # noqa: F401
    ACCEPT_LEN_BUCKETS,
    CHUNK_COUNT_BUCKETS,
    LATENCY_MS_BUCKETS,
    PROMETHEUS_CONTENT_TYPE,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    default_registry,
)
from neuronx_distributed_inference_tpu_torch.telemetry.spans import (  # noqa: F401
    SpanStore,
    to_chrome_trace,
)
from neuronx_distributed_inference_tpu_torch.telemetry.tracing import (  # noqa: F401
    RequestTrace,
    TelemetrySession,
    default_session,
    enable_default_session,
    load_events,
    set_default_session,
)
