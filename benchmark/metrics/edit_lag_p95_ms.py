"""The 95th percentile, over every edit sent in the window, of the time from
its send to the arrival of the first frame computed under it or a later edit."""

from psbench import stats


def read(run):
    return stats.percentile(run.get("edit_lag_ms", ()), 95)
