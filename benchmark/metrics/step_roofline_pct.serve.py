"""The step kernel's share of its least time: the frozen count over the live
pairs of the program's state in the window at the published peaks, over
the mean device time of a step launch in the daemon's trace."""

from psbench import trace


def read(run):
    tr, least = run.get("trace"), run.get("step_least")
    ms = None if not tr else trace.kernel_mean_ms(tr, "bucket_step_kernel")
    return None if not ms or not least else 100.0 * least["bound_ms"] / ms
