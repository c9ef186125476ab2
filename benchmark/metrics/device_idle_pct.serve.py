"""The share of the traced window (host clock, start to stop) in which the
daemon's card ran no kernel and no copy."""

def read(run):
    tr = run.get("trace")
    return None if not tr else tr["idle_pct"]
