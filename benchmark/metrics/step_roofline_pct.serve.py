"""The step kernel's share of its least time: the frozen count over the live
pairs of the program's state in the window at the published peaks, over
the mean device time of a step launch in the daemon's trace. The served
bucket grid's step is the live-tile step (the default on a scene with lane
chunks)."""

from psbench import trace

STEP_KERNELS = ("bucket_step_kernel_tiles<true>",)


def read(run):
    tr, least = run.get("trace"), run.get("step_least")
    ms = None if not tr else trace.kernel_mean_ms(tr, STEP_KERNELS)
    return None if not ms or not least else 100.0 * least["bound_ms"] / ms
