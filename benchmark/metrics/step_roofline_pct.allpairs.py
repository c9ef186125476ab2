"""The all-pairs step kernel's share of its least time: the frozen count over
the live pairs of the program's state in the window (every live receiver
times every other live particle) at the published peaks, over the mean
device time of a step launch in the daemon's trace. The served CompactArray
scene's step is the all-pairs kernel (table row 4)."""

from psbench import trace

STEP_KERNELS = ("allpairs_step_kernel",)


def read(run):
    tr, least = run.get("trace"), run.get("step_least")
    ms = None if not tr else trace.kernel_mean_ms(tr, STEP_KERNELS)
    return None if not ms or not least else 100.0 * least["bound_ms"] / ms
