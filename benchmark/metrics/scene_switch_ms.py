"""The mean, over every scene sent in the window, of the time from its send
to the arrival of its first stepped frame."""

from psbench import stats


def read(run):
    return stats.mean(run.get("switch_ms", ()))
