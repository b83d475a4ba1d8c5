"""fabric_bytes_per_tok (B/token, program_counter): bytes the fabric's
kernels 1-2 moved in the window, each launch priced by the frozen cost
(bench/yardstick/kernel_cost.py) from the operands the program reported,
over the tokens served in the window."""


def read(run):
    if not run.launches or not run.tokens:
        return None
    return sum(x.bytes() for x in run.launches) / run.tokens
