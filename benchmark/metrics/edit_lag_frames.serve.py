"""The median count of frames that arrived between an edit's send and its
first frame: the depth of the daemon's pipeline."""

from psbench import stats


def read(run):
    return stats.percentile(run.get("edit_lag_frames", ()), 50)
