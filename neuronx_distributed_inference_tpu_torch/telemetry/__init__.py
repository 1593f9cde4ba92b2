"""Serving telemetry of the port (counterpart of the reference's
``telemetry/``; the per-request host-clock subset, see ``tracing.py``)."""

from neuronx_distributed_inference_tpu_torch.telemetry.tracing import (  # noqa: F401
    RequestTrace,
    TelemetrySession,
    default_session,
)
