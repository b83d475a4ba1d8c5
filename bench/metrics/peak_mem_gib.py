"""peak_mem_gib (GiB, host clock): torch.cuda.max_memory_allocated(),
after a reset at process start, read once the window's first
``peak_steps`` steps (the traffic file's) have run: the peak over set-up
and a fixed amount of work, the same steps in every run whatever its
speed.  A run whose window closes sooner steps on, outside the window,
until it gets there."""


def read(run):
    if not run.work_peak_bytes:
        return None
    return run.work_peak_bytes / 2 ** 30
