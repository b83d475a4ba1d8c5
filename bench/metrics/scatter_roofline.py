"""scatter_roofline (%, device_trace): kernel 2's least time (its
launches' frozen-cost bytes over the HBM bandwidth) over its device time
in the profiled slice, by the kernel's name in the trace."""

from bench.yardstick.kernel_cost import SCATTER

KERNEL = "scatter_burst_kernel"


def read(run):
    if run.trace is None or not run.launches:
        return None
    mine = [x for x in run.launches if x.profiled and x.name == SCATTER]
    n, seconds = run.trace.kernel_time(KERNEL)
    if not mine or n != len(mine) or seconds <= 0:
        return None
    bound = sum(x.bytes() for x in mine) / run.peaks["hbm_bytes_per_s"]
    return 100.0 * bound / seconds
