"""The 95th percentile, over every edit sent in the window, of the time from
its send to the arrival of the first frame computed under it or a later edit:
what a cursor drag waits for, read per layer (its runs spread too widely to
hold a bound end to end)."""

from psbench import stats


def read(run):
    return stats.percentile(run.get("edit_lag_ms", ()), 95)
