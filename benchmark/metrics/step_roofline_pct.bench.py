"""The step kernel's share of its least time (classic on one card, halo on
each card of several, over the pairs of that card's shard), the mean over
the cards. Each runner reads a step's device time from the launches its
``STEP_KERNELS`` names (``psbench/frames.py``, ``rank_child.py``)."""

from psbench import stats


def read(run):
    return stats.mean(100.0 * r["step_least"]["bound_ms"] / r["step_ms"]
                      for r in run.get("ranks", ()) if r.get("step_ms") and r.get("step_least"))
