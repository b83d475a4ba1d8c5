"""mfu (%, program_counter): the model operations of the window's work
(bench/yardstick/model_cost.py: every prompt prefilled and every token
decoded in the window's steps) over the window's length (less a traced
run's stop of the profiler) times the card's bf16 peak."""

from bench.yardstick import model_cost as mc


def read(run):
    if run.working_s <= 0 or not run.steps:
        return None
    w = run.widths
    flops = sum(mc.prefill_flops(w, p) for s in run.steps for p in s.prefills)
    flops += sum(mc.decode_flops(w, c + 1) for s in run.steps
                 for c in s.cached)
    return 100.0 * flops / (run.working_s * run.peaks["bf16_flops"])
