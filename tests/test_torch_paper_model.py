"""The port's paper models against the reference's: the cycle-level burst
simulator (``core/burst.py``) and the resource model (``core/analysis.py``).

* ``MedusaReadSim`` — the five scenarios of ``tests/test_burst.py`` (the
  constant N-cycle latency of one line, FIFO order per port, interference
  freedom, a mid-stream join, overflow backpressure) and the simulator case
  of ``tests/test_cross_validation.py`` run through both simulators: every
  pop is equal bit for bit (float32), every completion latency is equal,
  the overflow raises the same error at the same push, and the final state
  (buffers, valid bits, pointers, completion and arrival times) is equal.
* The resource model — every function and constant equal to the
  reference's over a sweep of port counts, accelerator widths and burst
  depths, the paper's design point and Table II included.
"""

import dataclasses
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import analysis as janalysis  # noqa: E402
from repro.core.burst import MedusaReadSim as JSim  # noqa: E402
from repro_torch import core  # noqa: E402
from repro_torch.core import analysis  # noqa: E402
from repro_torch.core.burst import MedusaReadSim  # noqa: E402


def _single_line(make, log):
    n = 8
    sim = make(n, depth=4)
    line = np.random.RandomState(0).randn(n)
    sim.push_line(3, line)
    sim.run(n)
    log(sim, 3, 0)
    return sim


def _fifo_order(make, log):
    n = 4
    sim = make(n, depth=8)
    rng = np.random.RandomState(1)
    for line in [rng.randn(n) for _ in range(3)]:
        sim.push_line(2, line)
        sim.step()
    sim.run(3 * n)
    for i in range(3):
        log(sim, 2, i)
    return sim


def _interference_alone(make, log):
    n = 4
    rng = np.random.RandomState(2)
    sim = make(n, depth=8)
    sim.push_line(1, rng.randn(n))
    sim.run(2 * n)
    log(sim, 1, 0)
    return sim


def _interference_busy(make, log):
    n = 4
    rng = np.random.RandomState(2)
    line_a = rng.randn(n)
    sim = make(n, depth=8)
    for p in (0, 2, 3):
        for _ in range(4):
            sim.push_line(p, rng.randn(n))
    sim.push_line(1, line_a)
    sim.run(8 * n)
    for p in range(n):
        for slot in range(4 if p != 1 else 1):
            log(sim, p, slot)
    return sim


def _mid_stream_join(make, log):
    n = 4
    rng = np.random.RandomState(3)
    sim = make(n, depth=8)
    sim.push_line(0, rng.randn(n))
    sim.step()
    sim.step()
    sim.push_line(3, rng.randn(n))
    sim.run(3 * n)
    log(sim, 0, 0)
    log(sim, 3, 0)
    return sim


def _overflow(make, log):
    n, d = 4, 2
    sim = make(n, depth=d)
    line = np.zeros(n)
    sim.push_line(0, line)
    sim.push_line(0, line)
    try:
        sim.push_line(0, line)
    except RuntimeError as e:
        log.errors.append(str(e))
    return sim


def _unit_group(n):
    def scenario(make, log):
        lines = np.random.RandomState(n).randn(n, n)
        sim = make(n, depth=4)
        for p in range(n):
            sim.push_line(p, lines[p])
        sim.run(2 * n)
        for p in range(n):
            log(sim, p, 0)
        return sim
    return scenario


SCENARIOS = {
    "single_line_constant_latency": _single_line,
    "fifo_order_per_port": _fifo_order,
    "interference_alone": _interference_alone,
    "interference_busy": _interference_busy,
    "mid_stream_join": _mid_stream_join,
    "overflow_backpressure": _overflow,
    **{f"burst_sim_agrees_with_unit[{n}]": _unit_group(n) for n in (2, 4, 8)},
}


class Log:
    """Pops (as float32 bits) and completion latencies, in call order."""

    def __init__(self):
        self.pops, self.latencies, self.errors = [], [], []

    def __call__(self, sim, port, slot):
        pop = sim.pop_line(port, slot)
        pop = pop.cpu().numpy() if isinstance(pop, torch.Tensor) \
            else np.asarray(pop)
        assert pop.dtype == np.float32
        self.pops.append(pop.view(np.uint32).tolist())
        self.latencies.append(sim.completion_latency(port, slot))


def _state(sim) -> dict:
    def arr(x):
        return x.cpu().numpy() if isinstance(x, torch.Tensor) \
            else np.asarray(x)
    out = {name: arr(getattr(sim, name)).tolist() for name in (
        "in_valid", "head", "tail", "words_done", "out_time",
        "arrival_time")}
    for name in ("in_buf", "out_buf"):
        out[name] = arr(getattr(sim, name)).view(np.uint32).tolist()
    out["cycle"] = sim.cycle
    return out


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_read_sim_matches_reference(name):
    jlog, tlog = Log(), Log()
    jsim = SCENARIOS[name](JSim, jlog)
    tsim = SCENARIOS[name](
        lambda *a, **kw: MedusaReadSim(*a, device="cpu", **kw), tlog)
    assert tlog.pops == jlog.pops
    assert tlog.latencies == jlog.latencies
    assert tlog.errors == jlog.errors
    assert _state(tsim) == _state(jsim)
    if name == "overflow_backpressure":
        assert tlog.errors and "backpressure" in tlog.errors[0]
    elif name not in ("fifo_order_per_port", "interference_busy"):
        # paper §III-E: a line with no queueing delay behind earlier lines
        # of its port takes the constant N cycles
        assert set(tlog.latencies) == {tsim.n_ports}


def test_read_sim_needs_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MedusaReadSim(4, depth=2)
    assert core.MedusaReadSim(4, depth=2, device="cpu").device.type == "cpu"


# ---------------------------------------------------------------------------
# the resource model
# ---------------------------------------------------------------------------

def _configs():
    for n, w_acc, burst in itertools.product((2, 4, 8, 16, 32, 64),
                                             (8, 16, 32), (8, 32, 64)):
        for write_ports in (n, 2 * n):
            yield dict(w_line=n * w_acc, w_acc=w_acc, n_read_ports=n,
                       n_write_ports=write_ports, max_burst=burst)


def test_resource_model_matches_reference_over_a_sweep():
    count = 0
    for kw in _configs():
        jc, tc = janalysis.InterconnectConfig(**kw), \
            analysis.InterconnectConfig(**kw)
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
        assert (tc.n, tc.latency_cycles) == (jc.n, jc.latency_cycles)
        for fn in ("baseline_resources", "medusa_resources"):
            t, j = getattr(analysis, fn)(tc), getattr(janalysis, fn)(jc)
            assert dataclasses.asdict(t) == dataclasses.asdict(j), (fn, kw)
            assert t.mux_bits_total == j.mux_bits_total
        assert analysis.baseline_bram_mapped(tc) == \
            janalysis.baseline_bram_mapped(jc)
        assert analysis.complexity_summary(tc) == \
            janalysis.complexity_summary(jc)
        count += 1
    assert count == 108


def test_paper_design_point_and_table():
    tc, jc = analysis.paper_design_point(), janalysis.paper_design_point()
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    summary = analysis.complexity_summary(tc)
    assert summary == janalysis.complexity_summary(jc)
    # §IV-C: 960 BRAMs if the baseline's FIFOs were BRAM-mapped, 64 banks
    assert summary["baseline_bram_if_mapped"] == 960
    assert summary["medusa_bram"] == 64
    assert analysis.PAPER_TABLE2 == janalysis.PAPER_TABLE2
    lut, ff = analysis.paper_reported_reductions()
    assert (lut, ff) == janalysis.paper_reported_reductions()
    assert round(lut, 2) == 4.73 and round(ff, 2) == 6.02
    assert core.PAPER_TABLE2 is analysis.PAPER_TABLE2


def test_unsplit_line_is_refused_alike():
    kw = dict(w_line=512, w_acc=16, n_read_ports=16)
    with pytest.raises(AssertionError, match="evenly split"):
        janalysis.InterconnectConfig(**kw).n
    with pytest.raises(AssertionError, match="evenly split"):
        analysis.InterconnectConfig(**kw).n
