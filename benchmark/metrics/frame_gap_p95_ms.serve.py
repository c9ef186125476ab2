"""The 95th percentile of the gaps between frame arrivals at the editor,
over every frame of the window."""

from psbench import stats


def read(run):
    return stats.percentile(stats.gaps_ms(run.get("frame_times", ())), 95)
