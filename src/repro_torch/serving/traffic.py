"""Production-shaped traffic harness for the serving engine (port of
``repro.serving.traffic``).

The harness is host code: it generates a trace, submits it to the engine at
each record's arrival step, and reads the engine's lifecycle hooks.  On the
card every step it drives launches the engine's burst kernels.

* **Seeded load generator** (:class:`TrafficConfig` →
  :func:`generate_trace`): Poisson or bursty-diurnal arrivals, heavy-tailed
  lognormal prompt/generation lengths, a weighted priority-class mix, and
  an SLO-deadline mix — emitted as replayable :class:`TraceRecord` rows
  (JSON round-trippable via :func:`save_trace`/:func:`load_trace`).  The
  draws are numpy's ``default_rng(seed)`` in the reference's order, so a
  config gives the reference's trace bit for bit and the same JSON file.

* **:class:`MetricsRecorder`**: stamps every request's lifecycle in engine
  steps — submit → first admit → first token → retire or shed — and
  reports per-class TTFT / TPOT / queue-wait percentiles, goodput and the
  shed/SLO census.  The engine calls the ``record_*`` hooks itself
  (``ServingEngine(recorder=...)``); stamps are first-write-wins, so a
  fault-replayed step never double-counts.

* **:class:`ReplicaRouter`**: an in-process N-replica fleet behind a
  least-loaded router.  Each replica is a full
  :class:`~repro_torch.serving.engine.ServingEngine`; ``submit`` routes to
  the replica with the least outstanding work (queued + live + parked
  requests, then live tokens, then index — fully deterministic), ``step``
  advances all replicas in lockstep.

:func:`drive` replays a trace against one engine or a router;
:func:`fault_soak` runs the same seeded trace fault-free and under a
:class:`~repro_torch.runtime.fault_tolerance.FaultInjector`, asserting the
two runs converge token-exact with zero page leaks (``PagePool.check()`` at
drain).  ``python -m repro_torch.launch.loadgen`` is the CLI on top.
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from repro_torch.serving.engine import Request, ServingEngine


# ---------------------------------------------------------------------------
# trace generation
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TrafficConfig:
    """Knobs for one seeded, replayable traffic trace.

    Arrivals: ``"poisson"`` draws per-step arrival counts at a flat
    ``rate``; ``"diurnal"`` modulates the rate sinusoidally over
    ``diurnal_period`` steps (depth ``diurnal_amp``) and opens multi-step
    burst windows (``burst_prob`` per step, ``burst_mult`` × rate for
    ``burst_len`` steps) — the bursty-diurnal ramp of production serving.

    Lengths: prompt and generation lengths are lognormal (heavy-tailed —
    a few giants among many small requests), clipped to
    ``[prompt_min, prompt_max]`` / ``[gen_min, gen_max]``.

    Classes: request priorities draw from ``class_weights`` over
    ``0..classes-1`` (default: geometric favouring the lowest class, the
    production shape where bulk traffic is cheap and latency-sensitive
    traffic is rare).

    Deadlines: a ``deadline_frac`` fraction of requests carry an SLO
    deadline ``arrival + ceil(deadline_slack * (max_new_tokens + 2))`` —
    slack 1.0 is the tightest meetable bound (one committed token per
    engine step plus admission), below 1.0 requests are born provably
    unmeetable and must be shed up front.
    """

    seed: int = 0
    n_requests: int = 32
    arrival: str = "poisson"               # "poisson" | "diurnal"
    rate: float = 0.5                      # mean arrivals per engine step
    diurnal_period: int = 64
    diurnal_amp: float = 0.8
    burst_prob: float = 0.05
    burst_mult: float = 4.0
    burst_len: int = 4
    prompt_mean: float = 10.0
    prompt_sigma: float = 0.6
    prompt_min: int = 2
    prompt_max: int = 48
    gen_mean: float = 8.0
    gen_sigma: float = 0.7
    gen_min: int = 2
    gen_max: int = 32
    classes: int = 3
    class_weights: Optional[Sequence[float]] = None
    deadline_frac: float = 0.0
    deadline_slack: float = 3.0
    vocab: int = 256

    def validate(self) -> "TrafficConfig":
        if self.arrival not in ("poisson", "diurnal"):
            raise ValueError(f"arrival must be 'poisson' or 'diurnal', "
                             f"got {self.arrival!r}")
        if self.classes < 1:
            raise ValueError(f"need >= 1 priority class, got {self.classes}")
        if self.class_weights is not None \
                and len(self.class_weights) != self.classes:
            raise ValueError(
                f"class_weights has {len(self.class_weights)} entries for "
                f"{self.classes} classes")
        if not 0.0 <= self.deadline_frac <= 1.0:
            raise ValueError(f"deadline_frac must be in [0, 1], got "
                             f"{self.deadline_frac}")
        return self


@dataclasses.dataclass
class TraceRecord:
    """One replayable request: everything :class:`Request` needs plus the
    arrival step :func:`drive` submits it at."""

    rid: int
    arrival_step: int
    prompt: np.ndarray                     # [prompt_len] int32
    max_new_tokens: int
    priority: int = 0
    deadline: Optional[int] = None

    def to_request(self) -> Request:
        return Request(self.rid, np.asarray(self.prompt, np.int32).copy(),
                       max_new_tokens=self.max_new_tokens,
                       priority=self.priority, deadline=self.deadline)

    def to_json(self) -> dict:
        return {"rid": self.rid, "arrival_step": self.arrival_step,
                "prompt": np.asarray(self.prompt).tolist(),
                "max_new_tokens": self.max_new_tokens,
                "priority": self.priority, "deadline": self.deadline}

    @staticmethod
    def from_json(d: dict) -> "TraceRecord":
        return TraceRecord(d["rid"], d["arrival_step"],
                           np.asarray(d["prompt"], np.int32),
                           d["max_new_tokens"], d.get("priority", 0),
                           d.get("deadline"))


def _clipped_lognormal(rng: np.random.Generator, mean: float, sigma: float,
                       lo: int, hi: int) -> int:
    """Heavy-tailed integer length: lognormal with median ``mean``, clipped
    into ``[lo, hi]`` (the clip keeps the tail real but servable)."""
    x = rng.lognormal(mean=math.log(max(mean, 1.0)), sigma=sigma)
    return int(min(max(round(x), lo), hi))


def _arrival_rate(cfg: TrafficConfig, step: int, burst_left: int) -> float:
    rate = cfg.rate
    if cfg.arrival == "diurnal":
        rate *= 1.0 + cfg.diurnal_amp * math.sin(
            2.0 * math.pi * step / max(cfg.diurnal_period, 1))
        if burst_left > 0:
            rate *= cfg.burst_mult
    return max(rate, 0.0)


def generate_trace(cfg: TrafficConfig) -> List[TraceRecord]:
    """The seeded generator: same config → bit-identical trace (lengths,
    tokens, arrivals, classes and deadlines all draw from one
    ``np.random.default_rng(seed)`` stream in a fixed order)."""
    cfg.validate()
    rng = np.random.default_rng(cfg.seed)
    weights = cfg.class_weights
    if weights is None:
        weights = [2.0 ** -c for c in range(cfg.classes)]
    w = np.asarray(weights, np.float64)
    w = w / w.sum()
    trace: List[TraceRecord] = []
    step, burst_left = 0, 0
    while len(trace) < cfg.n_requests:
        if cfg.arrival == "diurnal":
            if burst_left > 0:
                burst_left -= 1
            elif rng.random() < cfg.burst_prob:
                burst_left = cfg.burst_len
        n = int(rng.poisson(_arrival_rate(cfg, step, burst_left)))
        for _ in range(min(n, cfg.n_requests - len(trace))):
            rid = len(trace)
            p_len = _clipped_lognormal(rng, cfg.prompt_mean, cfg.prompt_sigma,
                                       cfg.prompt_min, cfg.prompt_max)
            g_len = _clipped_lognormal(rng, cfg.gen_mean, cfg.gen_sigma,
                                       cfg.gen_min, cfg.gen_max)
            prompt = rng.integers(0, cfg.vocab, size=p_len, dtype=np.int32)
            priority = int(rng.choice(cfg.classes, p=w))
            deadline = None
            if rng.random() < cfg.deadline_frac:
                deadline = step + int(
                    math.ceil(cfg.deadline_slack * (g_len + 2)))
            trace.append(TraceRecord(rid, step, prompt, g_len, priority,
                                     deadline))
        step += 1
    return trace


def trace_t_max(trace: Sequence[TraceRecord], pad: int = 1) -> int:
    """The cache depth this trace needs: the widest prompt + generation
    reach, plus ``pad`` (the decode loop writes one position past the last
    committed token)."""
    return max(len(t.prompt) + t.max_new_tokens for t in trace) + pad


def save_trace(path: str, trace: Sequence[TraceRecord]) -> None:
    with open(path, "w") as f:
        json.dump([t.to_json() for t in trace], f)


def load_trace(path: str) -> List[TraceRecord]:
    with open(path) as f:
        return [TraceRecord.from_json(d) for d in json.load(f)]


# ---------------------------------------------------------------------------
# lifecycle metrics
# ---------------------------------------------------------------------------

_PCTS = (50, 90, 99)


def _pcts(xs: List[float]) -> Dict[str, float]:
    if not xs:
        return {f"p{p}": None for p in _PCTS}
    arr = np.asarray(xs, np.float64)
    return {f"p{p}": float(np.percentile(arr, p)) for p in _PCTS}


class MetricsRecorder:
    """Per-request lifecycle stamps, in engine steps.

    The engine calls :meth:`record_admit` / :meth:`record_first_token` /
    :meth:`record_retire` / :meth:`record_shed`; :func:`drive` calls
    :meth:`record_submit`.  All stamps are first-write-wins (``retire`` and
    ``shed`` excepted — they are terminal and idempotent under the fault
    injector's deterministic replay), so preemption/re-admission keeps the
    FIRST admit and first token, which is what TTFT means.
    """

    def __init__(self):
        self._rec: Dict[int, dict] = {}
        self.requests: Dict[int, Request] = {}   # filled by drive()

    def _entry(self, req: Request) -> dict:
        return self._rec.setdefault(req.rid, {
            "priority": req.priority, "deadline": req.deadline,
            "prompt_len": len(req.prompt),
            "max_new_tokens": req.max_new_tokens,
            "submit": None, "admit": None, "first_token": None,
            "retire": None, "shed": None, "shed_reason": None,
            "tokens": 0})

    def record_submit(self, req: Request, step: int) -> None:
        e = self._entry(req)
        if e["submit"] is None:
            e["submit"] = step

    def record_admit(self, req: Request, step: int) -> None:
        e = self._entry(req)
        if e["admit"] is None:
            e["admit"] = step

    def record_first_token(self, req: Request, step: int) -> None:
        e = self._entry(req)
        if e["first_token"] is None:
            e["first_token"] = step

    def record_retire(self, req: Request, step: int) -> None:
        e = self._entry(req)
        e["retire"] = step
        e["tokens"] = len(req.generated)

    def record_shed(self, req: Request, step: int, reason: str) -> None:
        e = self._entry(req)
        e["shed"] = step
        e["shed_reason"] = reason

    # -- reporting -----------------------------------------------------------
    def report(self) -> dict:
        """Per-class and aggregate metrics.  TTFT = first token − submit;
        queue wait = first admit − submit; TPOT = decode steps per
        committed token after the first; goodput = requests served within
        their deadline (no-deadline requests count as on time when served)
        over requests submitted."""
        classes: Dict[int, dict] = {}
        for e in self._rec.values():
            by = classes.setdefault(e["priority"], {
                "n": 0, "served": 0, "shed": 0, "tokens": 0, "on_time": 0,
                "slo_missed_served": 0, "slo_missed_shed": 0,
                "ttft": [], "wait": [], "tpot": []})
            by["n"] += 1
            if e["retire"] is not None:
                by["served"] += 1
                by["tokens"] += e["tokens"]
                late = (e["deadline"] is not None
                        and e["retire"] > e["deadline"])
                by["slo_missed_served"] += int(late)
                by["on_time"] += int(not late)
                if e["submit"] is not None and e["first_token"] is not None:
                    by["ttft"].append(e["first_token"] - e["submit"])
                if e["submit"] is not None and e["admit"] is not None:
                    by["wait"].append(e["admit"] - e["submit"])
                if e["first_token"] is not None and e["tokens"] > 1:
                    by["tpot"].append((e["retire"] - e["first_token"])
                                      / (e["tokens"] - 1))
            elif e["shed_reason"] is not None:
                by["shed"] += 1
                by["slo_missed_shed"] += int(e["deadline"] is not None)
        out: Dict[str, dict] = {}
        agg = {"n": 0, "served": 0, "shed": 0, "tokens": 0, "on_time": 0,
               "slo_missed_served": 0, "slo_missed_shed": 0,
               "ttft": [], "wait": [], "tpot": []}
        for p, by in sorted(classes.items()):
            for k in agg:
                agg[k] = (agg[k] + by[k]) if not isinstance(agg[k], list) \
                    else agg[k] + by[k]
            out[f"class{p}"] = self._finalize(by)
        out["aggregate"] = self._finalize(agg)
        return out

    @staticmethod
    def _finalize(by: dict) -> dict:
        cell = {k: by[k] for k in ("n", "served", "shed", "tokens",
                                   "slo_missed_served", "slo_missed_shed")}
        cell["goodput"] = by["on_time"] / by["n"] if by["n"] else None
        for name in ("ttft", "wait", "tpot"):
            for k, v in _pcts(by[name]).items():
                cell[f"{name}_{k}"] = v
        return cell

    def format_table(self) -> str:
        rows = ["class      n  served  shed  goodput  ttft p50/p90/p99  "
                "wait p50/p90/p99  tpot p50   slo miss (served/shed)"]

        def fm(v, spec="{:.0f}"):
            return "-" if v is None else spec.format(v)

        for name, c in self.report().items():
            rows.append(
                f"{name:<9} {c['n']:>3}  {c['served']:>6}  {c['shed']:>4}  "
                f"{fm(c['goodput'], '{:.0%}'):>7}  "
                f"{fm(c['ttft_p50'])}/{fm(c['ttft_p90'])}/"
                f"{fm(c['ttft_p99']):<10} "
                f"{fm(c['wait_p50'])}/{fm(c['wait_p90'])}/"
                f"{fm(c['wait_p99']):<10} "
                f"{fm(c['tpot_p50'], '{:.2f}'):>8}   "
                f"{c['slo_missed_served']}/{c['slo_missed_shed']}")
        return "\n".join(rows)

    def starved(self) -> List[int]:
        """Requests that neither retired nor were shed — submitted work the
        run abandoned.  Non-empty at drain means starvation."""
        return sorted(rid for rid, e in self._rec.items()
                      if e["retire"] is None and e["shed_reason"] is None)


# ---------------------------------------------------------------------------
# N-replica fleet behind a least-loaded router
# ---------------------------------------------------------------------------

class ReplicaRouter:
    """An in-process N-replica fleet on one host.  ``submit`` routes each
    request to the least-loaded replica (outstanding requests, then live
    tokens, then replica index — deterministic, so a routed run is
    replayable); ``step`` advances every replica one engine step in
    lockstep."""

    def __init__(self, engines: Sequence[ServingEngine]):
        if not engines:
            raise ValueError("router needs at least one replica")
        self.engines = list(engines)

    def _load(self, eng: ServingEngine):
        outstanding = (len(eng.queue) + len(eng._swapped)
                       + sum(r is not None for r in eng.active))
        live_tokens = sum(int(eng.pos[s])
                          for s in range(eng.max_slots)
                          if eng.active[s] is not None)
        return (outstanding, live_tokens)

    def route(self, req: Request) -> ServingEngine:
        return min(enumerate(self.engines),
                   key=lambda ie: self._load(ie[1]) + (ie[0],))[1]

    def submit(self, req: Request) -> str:
        return self.route(req).submit(req)

    def step(self) -> int:
        return sum(eng.step() for eng in self.engines)

    @property
    def step_count(self) -> int:
        return self.engines[0].step_count

    @property
    def drained(self) -> bool:
        return all(eng.drained for eng in self.engines)

    @property
    def recorder(self):
        return self.engines[0].recorder

    @recorder.setter
    def recorder(self, rec) -> None:
        for eng in self.engines:
            eng.recorder = rec

    def stats(self) -> dict:
        """Fleet-wide census: the sum of every replica's SchedulerStats."""
        total: Dict[str, int] = {}
        for eng in self.engines:
            for f in dataclasses.fields(eng.fabric_stats):
                total[f.name] = (total.get(f.name, 0)
                                 + getattr(eng.fabric_stats, f.name))
        return total

    def pending_census(self) -> str:
        return " | ".join(f"replica{i}: {eng.pending_census()}"
                          for i, eng in enumerate(self.engines))


# ---------------------------------------------------------------------------
# trace replay
# ---------------------------------------------------------------------------

def drive(target: Union[ServingEngine, ReplicaRouter],
          trace: Sequence[TraceRecord],
          recorder: Optional[MetricsRecorder] = None,
          max_steps: int = 10_000) -> MetricsRecorder:
    """Replay a trace against one engine or a router fleet: submit each
    record at its arrival step, step until every request retired or was
    shed.  Raises with the pending census when ``max_steps`` runs out with
    work stranded (the starvation signal the tests assert on)."""
    recorder = recorder if recorder is not None else MetricsRecorder()
    target.recorder = recorder
    recorder.requests = {}             # rid → the Request objects submitted
    pend = sorted(trace, key=lambda t: (t.arrival_step, t.rid))
    i = 0
    for _ in range(max_steps):
        step = target.step_count
        while i < len(pend) and pend[i].arrival_step <= step:
            req = pend[i].to_request()
            recorder.requests[req.rid] = req
            recorder.record_submit(req, step)
            target.submit(req)
            i += 1
        if target.step() == 0 and i == len(pend) and target.drained:
            return recorder
    raise RuntimeError(
        f"drive: {max_steps} steps exhausted with "
        f"{len(recorder.starved())} submitted requests stranded "
        f"(rids {recorder.starved()[:8]}...) and {len(pend) - i} not yet "
        f"arrived — {target.pending_census()}")


# ---------------------------------------------------------------------------
# fault soak
# ---------------------------------------------------------------------------

def fault_soak(make_engine, trace: Sequence[TraceRecord], injector,
               max_steps: int = 10_000):
    """Run the same seeded trace twice — fault-free, then under
    ``injector`` — and assert graceful degradation:

    * every request served in both runs committed **bit-identical**
      tokens (faults reschedule, they never corrupt);
    * requests without deadlines reach the same terminal outcome in both
      runs — served, or shed for the same reason (a fault may delay a
      *deadlined* request past its SLO — that flips served→shed and is
      exactly what the split census counts);
    * **zero page leaks** at drain: ``PagePool.check()`` clean, no pages
      in use, swap space empty — on both runs.

    ``make_engine(fault_injector=...)`` must build a fresh engine (or
    :class:`ReplicaRouter`) per run.  Returns ``(ref_recorder,
    soak_recorder, soak_target)``.
    """
    # request objects are fresh per run; token streams are compared through
    # the rid → Request map drive() captures at submit time
    def run_and_capture(inj):
        target = make_engine(fault_injector=inj)
        rec = drive(target, trace, max_steps=max_steps)
        engines = (target.engines if isinstance(target, ReplicaRouter)
                   else [target])
        for eng in engines:
            if eng.kv.paged:
                eng.kv.pool.check()
                assert eng.kv.pool.pages_in_use == 0, \
                    f"page leak at drain: {eng.kv.pool.pages_in_use} in use"
            assert eng._swap_pages_used == 0 and not eng._swapped, \
                "swap space not drained"
        return target, rec, rec.requests

    _, ref_rec, ref_reqs = run_and_capture(None)
    soak_target, soak_rec, soak_reqs = run_and_capture(injector)
    for t in trace:
        a, b = ref_reqs[t.rid], soak_reqs[t.rid]
        if a.shed_reason is None and b.shed_reason is None:
            assert a.generated == b.generated, (
                f"request {t.rid}: fault-soak tokens diverged from the "
                f"fault-free run ({a.generated[:6]}... vs "
                f"{b.generated[:6]}...)")
        elif t.deadline is None and a.shed_reason != b.shed_reason:
            # the same outcome in both runs (a no-deadline request shed at a
            # full bounded queue in both) is convergence; the reference
            # raises here whenever such a request was shed at all
            raise AssertionError(
                f"request {t.rid} (no deadline) shed in one run only: "
                f"ref={a.shed_reason} soak={b.shed_reason} — shedding "
                f"without a deadline must be schedule-independent")
    return ref_rec, soak_rec, soak_target
