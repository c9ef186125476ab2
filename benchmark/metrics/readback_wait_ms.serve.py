"""Host ms a ``Simulator.read_frame`` call, the mean over the calls that
started in the window (the daemon launcher's spans)."""

from psbench import stats


def read(run):
    return stats.span_ms(run, "read_frame")
