"""Seeded workload generation: arrivals × lengths × tenants × spec profiles
(a copy of the reference's ``workload/generator.py``: the same spec gives
the same trace and digest).

A closed-loop drain of a fixed request mix never overloads the server.
Production traffic does: it is OPEN-LOOP (requests arrive on their own schedule, whether
or not the server is ready), bursty or diurnal, multi-tenant (pools of users
sharing system-prompt prefixes), and heavy-tailed in both prompt and output
length. This module builds that traffic shape as data:

- **Arrival processes** (:class:`ArrivalSpec`): per-step arrival counts are
  Poisson draws around a rate envelope — constant (``poisson``), bursty
  on/off square wave (``onoff``), or a sinusoidal diurnal envelope
  (``diurnal``). One step of the envelope == one driver step == one virtual
  second (:mod:`.driver`).
- **Length distributions**: prompt lengths are lognormal (the classic
  heavy-ish body), output budgets are Zipf (the genuinely heavy tail), both
  clipped to the per-tenant bounds so every request stays admissible within
  the session's bucket limits.
- **Tenant pools** (:class:`TenantProfile`): each arrival draws a tenant by
  weight; a tenant's requests share a prompt PREFIX (drawn once per trace —
  the system-prompt / multi-turn regime prefix caching and the router's
  ``cache_aware`` placement exist for) and carry the tenant's TTFT/ITL SLOs
  and optional wall-clock deadline.
- **Spec-acceptance profiles**: a tenant's ``spec_accept_rate`` models how
  often a draft model agrees with the target on that tenant's text (prose-ish
  high, code-ish low). On the CPU harness — where random weights pin real
  draft agreement near zero or (same weights) near one — the profile is
  consumed through :func:`make_accept_gate`: a deterministic per-(request,
  round, position) agreement draw that CAPS the accepted draft count of a
  verify round. Capping acceptance is output-invariant (capped tokens are
  the target's own greedy tokens and are simply regenerated in later
  rounds), so the adaptive draft-length machinery actually moves per tenant
  while token streams stay byte-identical.

Determinism contract: :func:`generate` is a pure function of its
:class:`WorkloadSpec` — same seed ⇒ byte-identical trace (pinned via
:meth:`WorkloadTrace.digest`), and the JSON round trip
(:meth:`WorkloadTrace.dumps` / :func:`WorkloadTrace.loads`) is exact, so a
trace can be archived next to a measurement and replayed.
"""

from __future__ import annotations

import hashlib
import json
import math
from dataclasses import asdict, dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

#: arrival-process kinds ArrivalSpec.kind may take
ARRIVAL_KINDS = ("poisson", "onoff", "diurnal")


def base_req_id(rid: str) -> str:
    """Session-side request id -> workload request id: the router suffixes
    each failover incarnation ``~fN`` (RouterRequest.session_id); the
    workload layer (tenant profiles, SLO scoring) always speaks base ids."""
    head, sep, tail = rid.rpartition("~f")
    if sep and tail.isdigit():
        return head
    return rid


@dataclass(frozen=True)
class ArrivalSpec:
    """Rate envelope for the per-step Poisson arrival draws.

    ``rate`` is the mean arrivals per driver step (the ON-phase rate for
    ``onoff``, the PEAK rate for ``diurnal``). ``onoff`` alternates
    ``period_on`` steps at ``rate`` with ``period_off`` steps at
    ``off_rate``; ``diurnal`` scales ``rate`` by a sinusoid bounded below at
    ``diurnal_floor`` of the peak (one full period every
    ``diurnal_period`` steps)."""

    kind: str = "poisson"
    rate: float = 1.0
    off_rate: float = 0.0
    period_on: int = 8
    period_off: int = 8
    diurnal_period: int = 64
    diurnal_floor: float = 0.25

    def __post_init__(self):
        if self.kind not in ARRIVAL_KINDS:
            raise ValueError(
                f"unknown arrival kind {self.kind!r}; known: {ARRIVAL_KINDS}"
            )
        if self.rate < 0 or self.off_rate < 0:
            raise ValueError("arrival rates must be >= 0")

    def rate_at(self, step: int) -> float:
        """The envelope value at one driver step."""
        if self.kind == "poisson":
            return self.rate
        if self.kind == "onoff":
            period = max(1, self.period_on + self.period_off)
            return (
                self.rate
                if (step % period) < self.period_on
                else self.off_rate
            )
        # diurnal: peak `rate`, trough `diurnal_floor * rate`
        phase = 2.0 * math.pi * step / max(1, self.diurnal_period)
        depth = 0.5 * (1.0 + math.sin(phase))  # in [0, 1]
        return self.rate * (
            self.diurnal_floor + (1.0 - self.diurnal_floor) * depth
        )


@dataclass(frozen=True)
class TenantProfile:
    """One tenant pool: traffic share, length distributions, shared prompt
    prefix, SLO class, and the spec-acceptance profile. SLOs are in VIRTUAL
    seconds (one driver step == one virtual second by default); ``None``
    disables that SLO term. ``deadline_s`` rides the session's wall-clock TTL
    (``add_request(deadline_s=...)``) so overruns terminate server-side as
    ``deadline_exceeded``, not just in post-hoc scoring."""

    name: str
    weight: float = 1.0
    shared_prefix_len: int = 0
    prompt_len_mu: float = 2.5  # lognormal of tokens
    prompt_len_sigma: float = 0.5
    min_prompt_len: int = 1
    max_prompt_len: int = 32
    output_zipf_a: float = 2.5  # Zipf tail exponent for output budgets
    min_output_len: int = 1
    max_output_len: int = 16
    ttft_slo_s: Optional[float] = None
    itl_slo_s: Optional[float] = None
    deadline_s: Optional[float] = None
    spec_accept_rate: Optional[float] = None

    def __post_init__(self):
        if self.weight <= 0:
            raise ValueError(f"tenant {self.name!r}: weight must be > 0")
        if not (0 < self.min_prompt_len <= self.max_prompt_len):
            raise ValueError(f"tenant {self.name!r}: bad prompt bounds")
        if not (0 < self.min_output_len <= self.max_output_len):
            raise ValueError(f"tenant {self.name!r}: bad output bounds")
        if self.shared_prefix_len >= self.max_prompt_len:
            raise ValueError(
                f"tenant {self.name!r}: shared_prefix_len must leave room "
                "for at least one per-request suffix token"
            )
        if self.spec_accept_rate is not None and not (
            0.0 <= self.spec_accept_rate <= 1.0
        ):
            raise ValueError(f"tenant {self.name!r}: accept rate in [0, 1]")


@dataclass(frozen=True)
class WorkloadSpec:
    """Everything :func:`generate` needs; pure data, JSON-able."""

    seed: int
    n_requests: int
    vocab_size: int
    arrival: ArrivalSpec = field(default_factory=ArrivalSpec)
    tenants: Tuple[TenantProfile, ...] = (TenantProfile(name="default"),)
    max_steps: int = 100_000  # envelope safety bound (rate ~0 tails)

    def __post_init__(self):
        if self.n_requests < 1:
            raise ValueError("n_requests must be >= 1")
        if self.vocab_size < 2:
            raise ValueError("vocab_size must be >= 2")
        if not self.tenants:
            raise ValueError("at least one tenant profile")


@dataclass(frozen=True)
class Arrival:
    """One request of the trace, fully materialized (tokens included) so a
    replayed trace needs no rng."""

    req_id: str
    step: int
    tenant: str
    input_ids: Tuple[int, ...]
    max_new_tokens: int
    ttft_slo_s: Optional[float] = None
    itl_slo_s: Optional[float] = None
    deadline_s: Optional[float] = None
    spec_accept_rate: Optional[float] = None


@dataclass
class WorkloadTrace:
    """The reproducible arrival trace: spec + materialized arrivals (step
    order, stable req_ids). ``dumps()``/``loads()`` round-trip exactly;
    ``digest()`` is the byte-identity pin."""

    spec: WorkloadSpec
    arrivals: List[Arrival]

    def to_json(self) -> dict:
        return {
            "spec": asdict(self.spec),
            "arrivals": [asdict(a) for a in self.arrivals],
        }

    def dumps(self) -> str:
        """Canonical JSON (sorted keys, no whitespace drift) — two traces
        are byte-identical iff their dumps() are equal."""
        return json.dumps(self.to_json(), sort_keys=True, separators=(",", ":"))

    def digest(self) -> str:
        return hashlib.sha256(self.dumps().encode()).hexdigest()

    @staticmethod
    def loads(payload) -> "WorkloadTrace":
        d = json.loads(payload) if isinstance(payload, str) else payload
        sd = dict(d["spec"])
        sd["arrival"] = ArrivalSpec(**sd["arrival"])
        sd["tenants"] = tuple(
            TenantProfile(**t) for t in sd["tenants"]
        )
        spec = WorkloadSpec(**sd)
        arrivals = [
            Arrival(**{**a, "input_ids": tuple(a["input_ids"])})
            for a in d["arrivals"]
        ]
        return WorkloadTrace(spec=spec, arrivals=arrivals)

    @property
    def tenants_of(self) -> Dict[str, str]:
        return {a.req_id: a.tenant for a in self.arrivals}

    @property
    def arrival_steps(self) -> Dict[str, int]:
        return {a.req_id: a.step for a in self.arrivals}


def generate(spec: WorkloadSpec) -> WorkloadTrace:
    """Materialize the trace: walk the rate envelope step by step, drawing
    per-step Poisson arrival counts, then per arrival a weighted tenant, a
    lognormal prompt length (tenant prefix + random suffix) and a Zipf
    output budget — all from ONE seeded RandomState, so the whole trace is a
    pure function of the spec."""
    rng = np.random.RandomState(spec.seed)
    tenants = spec.tenants
    weights = np.asarray([t.weight for t in tenants], np.float64)
    weights = weights / weights.sum()
    # tenant shared prefixes drawn FIRST (order-stable): one per tenant, so
    # every request of a tenant pool shares the same leading blocks
    prefixes = {
        t.name: tuple(
            int(x)
            for x in rng.randint(0, spec.vocab_size, size=t.shared_prefix_len)
        )
        for t in tenants
    }
    arrivals: List[Arrival] = []
    step = 0
    while len(arrivals) < spec.n_requests:
        if step >= spec.max_steps:
            raise ValueError(
                f"arrival envelope produced only {len(arrivals)}/"
                f"{spec.n_requests} arrivals within max_steps={spec.max_steps}"
                " — raise the rate or max_steps"
            )
        n = int(rng.poisson(spec.arrival.rate_at(step)))
        for _ in range(min(n, spec.n_requests - len(arrivals))):
            t = tenants[int(rng.choice(len(tenants), p=weights))]
            prompt_len = int(np.clip(
                int(round(rng.lognormal(t.prompt_len_mu, t.prompt_len_sigma))),
                max(t.min_prompt_len, t.shared_prefix_len + 1),
                t.max_prompt_len,
            ))
            suffix_len = prompt_len - t.shared_prefix_len
            suffix = tuple(
                int(x) for x in rng.randint(0, spec.vocab_size, size=suffix_len)
            )
            out_len = int(np.clip(
                t.min_output_len + int(rng.zipf(t.output_zipf_a)) - 1,
                t.min_output_len,
                t.max_output_len,
            ))
            i = len(arrivals)
            arrivals.append(Arrival(
                req_id=f"{t.name}-{i:04d}",
                step=step,
                tenant=t.name,
                input_ids=prefixes[t.name] + suffix,
                max_new_tokens=out_len,
                ttft_slo_s=t.ttft_slo_s,
                itl_slo_s=t.itl_slo_s,
                deadline_s=t.deadline_s,
                spec_accept_rate=t.spec_accept_rate,
            ))
        step += 1
    return WorkloadTrace(spec=spec, arrivals=arrivals)


def make_accept_gate(trace: WorkloadTrace, seed: Optional[int] = None):
    """Build the CPU-harness draft-agreement gate for a speculative serving
    session (``session.draft_accept_cap``): per verify round it returns how
    many of the round's drafted tokens "agree", drawn per (request, round,
    position) from a counter-free hash of the seed — deterministic under ANY
    step interleaving (sequential or thread-per-replica routing), with
    contiguous-match semantics (the draw stops at the first disagreement,
    the geometric acceptance model speculative decoding is analyzed under).

    Returns None (no cap) for requests whose tenant carries no profile.
    Capping is output-invariant: the accepted window holds the TARGET's own
    greedy tokens, so accepting fewer merely defers them to later rounds —
    byte-identical streams, lower measured acceptance, and the adaptive
    draft-length policy reacts exactly as it would to real disagreement."""
    profiles = {
        a.req_id: a.spec_accept_rate
        for a in trace.arrivals
        if a.spec_accept_rate is not None
    }
    gate_seed = trace.spec.seed if seed is None else seed
    rounds: Dict[str, int] = {}

    def gate(req_id: str, drafted: int) -> Optional[int]:
        # the session calls with ITS request id, which carries a `~fN`
        # suffix per router-failover incarnation (RouterRequest.session_id)
        # — the tenant profile (and the round counter, so the agreement
        # sequence continues across incarnations) follows the BASE id
        req_id = base_req_id(req_id)
        rate = profiles.get(req_id)
        if rate is None:
            return None
        i = rounds.get(req_id, 0)
        rounds[req_id] = i + 1
        agreed = 0
        for j in range(drafted):
            h = hashlib.sha256(
                f"{gate_seed}:{req_id}:{i}:{j}".encode()
            ).digest()
            u = int.from_bytes(h[:8], "big") / 2.0**64
            if u >= rate:
                break  # contiguous-match: first disagreement ends the round
            agreed += 1
        return agreed

    return gate


def standard_spec(
    *,
    seed: int = 0,
    n_requests: int = 16,
    vocab_size: int = 32000,
    arrival_kind: str = "poisson",
    rate: float = 1.0,
    n_tenants: int = 2,
    shared_prefix_len: int = 16,
    max_prompt_len: int = 32,
    min_output_len: int = 1,
    max_output_len: int = 16,
    ttft_slo_s: Optional[float] = None,
    itl_slo_s: Optional[float] = None,
    deadline_s: Optional[float] = None,
    spec_profiles: bool = False,
) -> WorkloadSpec:
    """The stock multi-tenant spec of the goodput runs: ``n_tenants``
    pools alternating prose-ish (high draft agreement) and code-ish (low)
    profiles, each with its own shared prefix, equal
    weights, common length bounds and one SLO class. A convenience, not a
    constraint — build WorkloadSpec directly for anything richer."""
    tenants = []
    for i in range(max(1, n_tenants)):
        prose = i % 2 == 0
        tenants.append(TenantProfile(
            name=("prose" if prose else "code") + str(i),
            weight=1.0,
            shared_prefix_len=max(0, min(shared_prefix_len,
                                         max_prompt_len - 8)),
            prompt_len_mu=math.log(max(2.0, max_prompt_len / 2.0)),
            prompt_len_sigma=0.5,
            max_prompt_len=max_prompt_len,
            min_output_len=min(min_output_len, max_output_len),
            max_output_len=max_output_len,
            ttft_slo_s=ttft_slo_s,
            itl_slo_s=itl_slo_s,
            deadline_s=deadline_s,
            spec_accept_rate=(
                (0.9 if prose else 0.2) if spec_profiles else None
            ),
        ))
    if arrival_kind == "onoff":
        arrival = ArrivalSpec(kind="onoff", rate=rate, off_rate=0.0,
                              period_on=4, period_off=8)
    elif arrival_kind == "diurnal":
        arrival = ArrivalSpec(kind="diurnal", rate=rate, diurnal_period=32)
    else:
        arrival = ArrivalSpec(kind="poisson", rate=rate)
    return WorkloadSpec(
        seed=seed,
        n_requests=n_requests,
        vocab_size=vocab_size,
        arrival=arrival,
        tenants=tuple(tenants),
    )
