"""SLO attainment + goodput scoring over an open-loop workload run
(counterpart of the reference's ``workload/slo.py``).

Raw tok/s rewards a server for finishing work nobody is waiting for
anymore. The serving literature's answer is **goodput under SLO**: only
tokens from requests that met their latency deadlines count. This module
scores one :class:`~.driver.WorkloadResult` against its trace:

- **Per-request attainment.** A request MEETS its SLO iff it finished
  (terminal ``finished`` — validation rejects, backlog give-ups, deadline
  expiries and fault terminals all miss) AND its TTFT — measured from
  ARRIVAL (the workload trace's step), so driver-backlog and router-queue
  wait count — is within the tenant's ``ttft_slo_s`` AND its average
  inter-token latency (first→last token span / (tokens−1), which absorbs
  multi-token fetch amortization and failover gaps) is within
  ``itl_slo_s``. A ``None`` SLO term always passes, so generous-SLO runs
  pin ``attainment == 1.0`` exactly.
- **Goodput.** ``slo_met_tokens`` = committed tokens of SLO-met requests;
  callers divide by wall seconds for a tok/s goodput comparable to the
  closed-loop rows (the report also carries tokens per VIRTUAL second).
- **Time-bucketed series + chaos metrics.** ``step_commits`` from the
  driver, restricted to SLO-met requests and bucketed ``bucket_steps`` at a
  time, is the goodput series; :func:`extract_dip` reads the seeded
  replica-kill's cost off it: ``dip_frac`` (1 − dip/pre-kill baseline) and
  ``recovery_steps`` (kill until the series regains ``recovery_frac`` of
  the CAPACITY-ADJUSTED baseline — after killing 1 of N replicas the
  recoverable level is ``(N−1)/N`` of the pre-kill baseline, so recovery is
  judged against ``recovery_frac × alive_frac × baseline``, not a level the
  surviving capacity cannot reach).

Telemetry: when called with an enabled session, every miss increments
``nxdi_slo_missed_total{kind, tenant}`` (kinds: ``ttft`` / ``itl`` /
``failed`` / ``never_served``) — host-side and post-hoc.

Router note: session-level telemetry traces are keyed by the session-side
request id, which carries a ``~fN`` suffix per failover incarnation; the
scorer merges incarnations back onto the base id (earliest first token,
latest last token, summed token counts).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from neuronx_distributed_inference_tpu_torch.telemetry.slo_monitor import judge
from neuronx_distributed_inference_tpu_torch.workload.driver import WorkloadResult
from neuronx_distributed_inference_tpu_torch.workload.generator import base_req_id


@dataclass
class RequestScore:
    req_id: str
    tenant: str
    arrival_s: float
    tokens: int
    finished: bool
    ttft_s: Optional[float] = None
    avg_itl_s: Optional[float] = None
    ttft_ok: bool = True
    itl_ok: bool = True
    miss_kind: Optional[str] = None  # ttft | itl | failed | never_served

    @property
    def met(self) -> bool:
        return self.miss_kind is None


@dataclass
class DipReport:
    """Chaos cost read off the goodput series (bucket units are driver
    steps × ``bucket_steps``)."""

    kill_bucket: int
    baseline: float  # mean pre-kill bucket goodput (tokens/bucket)
    dip_value: float  # worst post-kill bucket
    dip_frac: float  # 1 - dip/baseline, clamped at 0
    recovery_target: float  # recovery_frac * alive_frac * baseline
    recovery_steps: Optional[int]  # kill -> first bucket back at target


@dataclass
class SloReport:
    per_request: List[RequestScore]
    attainment: float
    attainment_by_tenant: Dict[str, float]
    slo_met_tokens: int
    total_tokens: int
    goodput_tok_per_virtual_s: float
    misses_by_kind: Dict[str, int]
    series: List[int] = field(default_factory=list)  # SLO-met tokens/bucket
    bucket_steps: int = 1
    dip: Optional[DipReport] = None


def _traces_by_base(telemetry) -> Dict[str, List]:
    """One pass over the telemetry RequestTraces — the completed deque AND
    the still-open table (a harvested failover incarnation never 'finishes'
    in its session, so its trace stays open) — keyed by the BASE workload
    request id, incarnations merged onto it."""
    out: Dict[str, List] = {}
    for tr in list(telemetry.completed) + list(telemetry.traces.values()):
        out.setdefault(base_req_id(tr.req_id), []).append(tr)
    return out


def extract_dip(
    series: List[float],
    kill_bucket: int,
    *,
    bucket_steps: int = 1,
    warmup_buckets: int = 1,
    alive_frac: float = 1.0,
    recovery_frac: float = 0.8,
    dip_window_buckets: int = 4,
) -> Optional[DipReport]:
    """Dip depth + recovery time from a goodput series. Pure function —
    unit-tested on hand-built series. Returns None when the series cannot
    support the read (kill outside the series, or no pre-kill baseline).

    The dip is read over a BOUNDED window of ``dip_window_buckets`` buckets
    after the kill — the failover transient (harvest + re-queue +
    re-prefill on the survivors) — not the whole tail: every finite run
    eventually drains down to zero as its last requests finish, and a
    global post-kill minimum would report that drain as chaos damage.
    Recovery is the first bucket at/after the dip back at
    ``recovery_frac × alive_frac × baseline``."""
    if not (0 < kill_bucket < len(series)):
        return None
    # the baseline must come from POST-warmup pre-kill buckets: a kill
    # inside the ramp-up window has no steady level to measure a dip
    # against — refusing the read beats silently comparing against the
    # ramp bucket (which understates every dip to ~0)
    pre = series[warmup_buckets:kill_bucket]
    if not pre:
        return None
    baseline = float(sum(pre)) / len(pre)
    if baseline <= 0:
        return None
    window = series[kill_bucket:kill_bucket + max(1, dip_window_buckets)]
    dip_value = float(min(window))
    dip_idx = kill_bucket + window.index(min(window))
    dip_frac = max(0.0, 1.0 - dip_value / baseline)
    target = recovery_frac * alive_frac * baseline
    recovery_steps: Optional[int] = None
    for b in range(dip_idx, len(series)):
        if series[b] >= target:
            recovery_steps = (b - kill_bucket) * bucket_steps
            break
    return DipReport(
        kill_bucket=kill_bucket,
        baseline=baseline,
        dip_value=dip_value,
        dip_frac=round(dip_frac, 4),
        recovery_target=target,
        recovery_steps=recovery_steps,
    )


def score(
    result: WorkloadResult,
    telemetry,
    *,
    bucket_steps: int = 4,
    recovery_frac: float = 0.8,
    alive_frac: Optional[float] = None,
    record: bool = True,
) -> SloReport:
    """Score one run. ``telemetry`` is the TelemetrySession the serving
    stack recorded into (its RequestTraces carry the virtual-clock
    timestamps); ``record=True`` additionally increments
    ``nxdi_slo_missed_total{kind, tenant}`` per miss."""
    trace = result.trace
    dt = result.step_dt_s
    scores: List[RequestScore] = []
    misses: Dict[str, int] = {}
    traces_of = _traces_by_base(telemetry)
    for arr in trace.arrivals:
        rid = arr.req_id
        arrival_s = arr.step * dt
        tokens = len(result.outputs.get(rid, ()))
        status = result.statuses.get(rid, "never_served")
        finished = status == "finished"
        sc = RequestScore(
            req_id=rid, tenant=arr.tenant, arrival_s=arrival_s,
            tokens=tokens, finished=finished,
        )
        trs = traces_of.get(rid, [])
        firsts = [t.t_first_token for t in trs if t.t_first_token is not None]
        lasts = [t.t_last_token for t in trs if t.t_last_token is not None]
        n_tok = sum(t.tokens for t in trs)
        if firsts:
            sc.ttft_s = min(firsts) - arrival_s
            if n_tok > 1 and lasts:
                sc.avg_itl_s = (max(lasts) - min(firsts)) / (n_tok - 1)
        # the per-request verdict routes through the SAME predicate the live
        # SloMonitor applies mid-run (telemetry/slo_monitor.py) — the two
        # surfaces can never drift
        if arr.ttft_slo_s is not None:
            sc.ttft_ok = sc.ttft_s is not None and sc.ttft_s <= arr.ttft_slo_s
        if arr.itl_slo_s is not None and sc.avg_itl_s is not None:
            sc.itl_ok = sc.avg_itl_s <= arr.itl_slo_s
        sc.miss_kind = judge(
            finished=finished,
            served=rid not in result.never_served and bool(firsts),
            ttft_s=sc.ttft_s,
            avg_itl_s=sc.avg_itl_s,
            ttft_slo_s=arr.ttft_slo_s,
            itl_slo_s=arr.itl_slo_s,
        )
        if sc.miss_kind is not None:
            misses[sc.miss_kind] = misses.get(sc.miss_kind, 0) + 1
            if record:
                telemetry.slo_missed(sc.miss_kind, arr.tenant)
        scores.append(sc)

    met_ids = {s.req_id for s in scores if s.met}
    slo_met_tokens = sum(s.tokens for s in scores if s.met)
    total_tokens = sum(s.tokens for s in scores)
    by_tenant: Dict[str, List[RequestScore]] = {}
    for s in scores:
        by_tenant.setdefault(s.tenant, []).append(s)
    attainment_by_tenant = {
        t: sum(1 for s in ss if s.met) / len(ss)
        for t, ss in sorted(by_tenant.items())
    }
    attainment = (
        sum(1 for s in scores if s.met) / len(scores) if scores else 0.0
    )

    # the time-bucketed goodput series: SLO-met tokens per bucket, trimmed
    # to the live span (trailing idle steps would fake a terminal dip).
    # live_steps is recorded AFTER each step, so the step that commits the
    # run's LAST tokens reads not-live — a step with commits always stays
    # in the span (and in virtual_span), only genuinely idle tails trim.
    live = result.live_steps
    end = len(result.step_commits)
    while end > 0 and not (
        (live[end - 1] if end - 1 < len(live) else True)
        or result.step_commits[end - 1]
    ):
        end -= 1
    series: List[int] = []
    for i in range(0, end, bucket_steps):
        series.append(sum(
            n
            for commits in result.step_commits[i:i + bucket_steps]
            for rid, n in commits.items()
            if rid in met_ids
        ))
    virtual_span = max(1, end) * dt
    dip = None
    if result.chaos is not None:
        af = alive_frac
        if af is None:
            # the driver may pin capacity explicitly: a PREFILL-tier kill
            # leaves decode capacity intact (alive_frac 1.0 — the router
            # degrades to local prefill), so the recovery target must not
            # assume a decode replica died
            af = result.chaos.get("alive_frac")
        if af is None:
            # capacity left after the kill(s): (N-k)/N of the replicas that
            # were alive when the chaos plan first fired (k = kills that
            # actually landed; multi-kill schedules record them in events)
            n_before = max(1, int(result.chaos.get("alive_before", 2)))
            events = result.chaos.get("events") or [{}]
            n_killed = max(
                1, sum(1 for e in events if not e.get("exhausted"))
            )
            af = max(1, n_before - n_killed) / n_before
        dip = extract_dip(
            series,
            result.chaos["step"] // bucket_steps,
            bucket_steps=bucket_steps,
            alive_frac=af,
            recovery_frac=recovery_frac,
        )
    return SloReport(
        per_request=scores,
        attainment=round(attainment, 4),
        attainment_by_tenant=attainment_by_tenant,
        slo_met_tokens=slo_met_tokens,
        total_tokens=total_tokens,
        goodput_tok_per_virtual_s=round(slo_met_tokens / virtual_span, 4),
        misses_by_kind=misses,
        series=series,
        bucket_steps=bucket_steps,
        dip=dip,
    )
