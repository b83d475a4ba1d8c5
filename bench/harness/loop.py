"""The closed loop that drives the program's serving engine, and its records.

Set-up: weights from the seed (:mod:`bench.harness.weights`), the
program's engine at the traffic file's sizes, one request per client
submitted, and the engine's first step, which admits that wave (its
prefills and install burst) and so loads every kernel the window runs.
The window then starts: the loop calls ``ServingEngine.step()`` until
``seconds`` have passed.  After each step returns (the step ends in a read
of its argmax on the host) the harness stamps each request's new tokens
with the host clock, and a client whose request retired sends its next one
at once, so the next step admits it.

Memory: the peak over set-up and the window's first ``peak_steps`` steps
(the traffic file's), a fixed amount of work.  What a step runs depends
on the step count alone, never on the clock (a client sends its next
request when its last one retires), so that peak is the same in every run
whatever its speed.  A run whose window closes before that step steps on,
outside the window and its records, until it gets there.

Kept per step: its host span, how many requests it admitted, the prompt
lengths it prefilled, and the cached positions each decoded token read.
Kept per request: when it was sent, each token's time, and the engine's
logits row of one decode step drawn from the seed (the probe the
correctness check compares).  With ``trace`` the first ``trace_seconds``
of the window run under ``torch.profiler`` (:mod:`bench.harness.trace`),
and every launch of kernels 1-2 is recorded through the program's own hook
(``repro_torch.kernels.launch.listening``), its live frames counted on the
device (no host sync in the window).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from bench.harness import traffic as traffic_mod
from bench.harness import weights as weights_mod
from bench.yardstick import kernel_cost


@dataclasses.dataclass
class Step:
    k: int
    start: float
    end: float
    admitted: int = 0
    tokens: int = 0
    prefills: List[int] = dataclasses.field(default_factory=list)
    cached: List[int] = dataclasses.field(default_factory=list)
    profiled: bool = False


@dataclasses.dataclass(eq=False)
class Req:
    spec: traffic_mod.Spec
    engine_req: object
    sent: float
    probe_at: Optional[int]
    times: List[float] = dataclasses.field(default_factory=list)
    done: Optional[float] = None
    probe: Optional[torch.Tensor] = None

    @property
    def prompt_len(self) -> int:
        return int(self.spec.prompt.shape[0])

    @property
    def served(self) -> List[int]:
        return list(self.engine_req.generated)


@dataclasses.dataclass
class Launch:
    name: str
    frame_bytes: int
    idx_bytes: int
    out_bytes: int
    live: torch.Tensor          # device count of live frames
    profiled: bool

    def bytes(self) -> int:
        return kernel_cost.launch_bytes(self.name, int(self.live),
                                        self.frame_bytes, self.idx_bytes,
                                        self.out_bytes)


class Launches:
    """A census for ``repro_torch.kernels.launch.listening``: every launch
    of kernels 1-2 with its operands' sizes."""

    def __init__(self):
        self.items: List[Launch] = []
        self.profiled = False

    def kernel(self, name, ops):
        if name == kernel_cost.GATHER:
            pool, out = ops["lines"], ops["out"]
        elif name == kernel_cost.SCATTER:
            pool, out = ops["into"], None
        else:
            return
        idx = ops["idx"]
        frame = pool[0].numel() * pool.element_size() if pool.shape[0] else 0
        live = ((idx >= 0) & (idx < pool.shape[0])).sum()
        self.items.append(Launch(
            name, frame, idx.numel() * idx.element_size(),
            0 if out is None else out.numel() * out.element_size(), live,
            self.profiled))

    def collective(self, kind, operands, results):
        pass


@dataclasses.dataclass
class Record:
    """What a run saw: the readers of ``bench/metrics`` take this."""
    setup_s: float
    window_s: float
    steps: List[Step]               # the window's steps
    requests: List[Req]             # every request sent
    attempted: int
    failed: int
    memory_peak_bytes: int          # the whole run's, to the last step
    work_peak_bytes: int = 0        # set-up and the first peak_steps steps
    peak_steps: int = 0             # the step the work's peak was read at
    paused_s: float = 0.0           # the window's time stopping a profiler
    launches: Optional[List[Launch]] = None
    trace: object = None            # bench.harness.trace.TraceData
    widths: object = None           # bench.yardstick.model_cost.Widths
    peaks: Optional[dict] = None

    @property
    def tokens(self) -> int:
        return sum(s.tokens for s in self.steps)

    @property
    def working_s(self) -> float:
        """The window's length less the time it spent stopping the
        profiler (a traced run's); the whole window otherwise."""
        return self.window_s - self.paused_s

    @property
    def window_start(self) -> float:
        return self.steps[0].start if self.steps else 0.0


def port_config(cfg: dict):
    """The program's model configuration from the file's ``port`` group."""
    from repro_torch.configs.base import ModelConfig
    return ModelConfig(**cfg["port"])


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _peak(device) -> int:
    if torch.device(device).type != "cuda":
        return 0
    return torch.cuda.max_memory_allocated(device)


def _stop(prof, device) -> float:
    """Stop the profiler at the end of the traced slice; returns the
    seconds the stop took, which the window spent on no step."""
    t = time.perf_counter()
    _sync(device)
    prof.__exit__(None, None, None)
    return time.perf_counter() - t


def drive(cell, seed: int, seconds: float, trace: bool, device,
          t_start: float):
    """Set up, run the window, and return ``(record, weights, prof)``:
    the program's engine is dropped before returning, the weights are the
    benchmark's own (the reference reads them), ``prof`` the finished
    profiler of a traced run (or None)."""
    from repro_torch.kernels import launch as kl
    from repro_torch.models import lm
    from repro_torch.serving.engine import Request, ServingEngine

    cfg, mix = cell.config, cell.traffic
    port = port_config(cfg)
    weights = weights_mod.make(cfg, seed, device)
    params = weights_mod.program_params(lm, port, weights)
    sizes = mix["engine"]
    engine = ServingEngine(port, params, max_slots=sizes["max_slots"],
                           t_max=sizes["t_max"],
                           page_size=sizes["page_size"])
    requests = traffic_mod.stream(mix, cfg["vocab_size"], seed)
    probe_rng = np.random.default_rng([int(seed) % (1 << 64), 3])
    inflight: List[Req] = []
    sent: List[Req] = []
    failed = 0

    def send(now):
        nonlocal failed
        spec = next(requests)
        er = Request(rid=spec.index, prompt=spec.prompt,
                     max_new_tokens=spec.max_new_tokens)
        probe = (int(probe_rng.integers(1, spec.max_new_tokens - 1))
                 if spec.max_new_tokens >= 3 else None)
        r = Req(spec, er, now, probe)
        sent.append(r)
        if engine.submit(er) == "queued":
            inflight.append(r)
        else:
            failed += 1

    def bookkeeping(step: Step):
        for r in list(inflight):
            g = len(r.engine_req.generated)
            have = len(r.times)
            if g > have:
                if have == 0:
                    step.admitted += 1
                    step.prefills.append(r.prompt_len)
                step.cached.extend(r.prompt_len + j - 1
                                   for j in range(max(1, have), g))
                step.tokens += g - have
                r.times.extend([step.end] * (g - have))
                if r.probe_at is not None and g == r.probe_at + 1:
                    slot = next(s for s, a in enumerate(engine.active)
                                if a is r.engine_req)
                    r.probe = engine.last_logits[slot].detach().clone()
            if r.engine_req.done:
                r.done = step.end
                inflight.remove(r)
                send(time.perf_counter())

    for _ in range(mix["clients"]):
        send(time.perf_counter())
    first = Step(-1, time.perf_counter(), 0.0)
    engine.step()
    first.end = time.perf_counter()
    bookkeeping(first)
    _sync(device)

    census = Launches() if trace else None
    prof = None
    steps: List[Step] = []
    peak_steps = int(mix["peak_steps"])
    work_peak = 0
    listen = kl.listening(census) if trace else contextlib.nullcontext()
    with listen:
        if trace:               # the profiler starts up before the window
            from torch.profiler import ProfilerActivity, profile
            prof = profile(activities=[ProfilerActivity.CUDA])
            prof.__enter__()
            census.profiled = True
        t0 = time.perf_counter()
        setup_s = t0 - t_start
        paused_s = 0.0
        k = 0
        while time.perf_counter() - t0 < seconds:
            step = Step(k, time.perf_counter(), 0.0,
                        profiled=census is not None and census.profiled)
            if step.profiled:           # the step's mark on the device
                torch.cuda._sleep(1)
            engine.step()
            step.end = time.perf_counter()
            steps.append(step)
            bookkeeping(step)
            k += 1
            if k == peak_steps:
                work_peak = _peak(device)
            if census is not None and census.profiled and \
                    time.perf_counter() - t0 >= mix["trace_seconds"]:
                paused_s = _stop(prof, device)
                census.profiled = False
        if census is not None and census.profiled:
            paused_s = _stop(prof, device)
            census.profiled = False
    _sync(device)
    window_s = steps[-1].end - t0 if steps else 0.0
    while k < peak_steps:       # past the window, to the work's fixed end
        step = Step(k, time.perf_counter(), 0.0)
        engine.step()
        step.end = time.perf_counter()
        bookkeeping(step)
        k += 1
        if k == peak_steps:
            work_peak = _peak(device)
    attempted = sum(1 for r in sent if r.sent <= t0 + window_s)
    record = Record(setup_s=setup_s, window_s=window_s, steps=steps,
                    requests=sent, attempted=attempted, failed=failed,
                    memory_peak_bytes=_peak(device),
                    work_peak_bytes=work_peak, peak_steps=peak_steps,
                    paused_s=paused_s,
                    launches=census.items if census else None)
    del engine, params
    return record, weights, prof
