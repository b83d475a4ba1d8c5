"""setup_s (s, host clock): from the process's start to the window's:
imports, weights made from the seed, the engine, the first wave admitted
and its first step (which loads, or on a checkout's first run builds, the
kernels)."""


def read(run):
    return run.setup_s
