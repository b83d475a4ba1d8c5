"""hbm_share (%, program_counter): the least HBM bytes the window's work
needs (bench/yardstick/model_cost.py: weights once per prefill and per
decode step, every cached K/V byte a step advances read once, new K/V
written once) over the window's length (less a traced run's stop of the
profiler) times the card's HBM bandwidth."""

from bench.yardstick import model_cost as mc


def read(run):
    if run.working_s <= 0 or not run.steps:
        return None
    w = run.widths
    need = sum(mc.prefill_bytes(w, p) for s in run.steps for p in s.prefills)
    need += sum(mc.decode_step_bytes(w, s.cached) for s in run.steps)
    return 100.0 * need / (run.working_s * run.peaks["hbm_bytes_per_s"])
