"""Host ms a step in the ring exchange (``domain.EXCHANGE`` seconds over
steps, counted over the window), the mean over the ranks."""

from psbench import stats


def read(run):
    per = [r["exchange"]["seconds"] * 1e3 / r["exchange"]["steps"]
           for r in run.get("ranks", ()) if r.get("exchange", {}).get("steps")]
    return stats.mean(per)
