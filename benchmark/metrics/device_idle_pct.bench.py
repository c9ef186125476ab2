"""The share of the traced window (host clock, start to stop) in which the
card ran no kernel and no copy, the mean over the cards."""

def read(run):
    tr = run.get("trace")
    return None if not tr else tr["idle_pct"]
