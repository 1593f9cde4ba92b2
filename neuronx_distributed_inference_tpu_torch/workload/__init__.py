"""Workload engine and SLO goodput scoring (counterpart of the reference's
``workload/``).

Three pieces, all host-side and fully deterministic from a seed:

- :mod:`.generator` — composable arrival processes (Poisson / bursty on-off
  / diurnal envelope) × heavy-tailed prompt/output length distributions ×
  multi-tenant pools with shared prompt prefixes × per-tenant
  spec-acceptance profiles, emitting a reproducible
  :class:`~.generator.WorkloadTrace` (same seed ⇒ byte-identical JSON).
- :mod:`.driver` — the open-loop driver: steps a
  :class:`~..runtime.router.ServingRouter` (or a single serving session) on
  a virtual clock, admitting each request no earlier than its arrival step;
  refused arrivals retry from a backlog and count against goodput; a seeded
  :class:`~.driver.ChaosPlan` kills a replica mid-run.
- :mod:`.slo` — the SLO scorer: per-request TTFT/ITL deadline attainment
  from the telemetry ``RequestTrace``s (measured from ARRIVAL, so backlog
  wait counts), **goodput** (SLO-met tokens per second), attainment by
  tenant, a time-bucketed goodput series, and the chaos metrics
  (goodput-dip depth + recovery time) extracted from that series.
"""

from neuronx_distributed_inference_tpu_torch.workload.generator import (  # noqa: F401
    Arrival,
    ArrivalSpec,
    TenantProfile,
    WorkloadSpec,
    WorkloadTrace,
    generate,
    make_accept_gate,
    standard_spec,
)
from neuronx_distributed_inference_tpu_torch.workload.driver import (  # noqa: F401
    ChaosPlan,
    VirtualClock,
    WorkloadDriver,
    WorkloadResult,
)
from neuronx_distributed_inference_tpu_torch.workload.slo import (  # noqa: F401
    DipReport,
    RequestScore,
    SloReport,
    extract_dip,
    score,
)
