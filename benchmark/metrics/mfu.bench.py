"""The frames' share of the card's peak: the least time of every step
of the window (the frozen count over the live pairs of the final state, at
the published peaks), over the window's seconds. It bounds every kernel's
roofline, so a kernel taken off the path cannot leave a gain unseen."""


def read(run):
    ranks = run.get("ranks") or ()
    if len(ranks) != 1 or not ranks[0].get("step_least"):
        return None
    work_s = ranks[0]["step_least"]["bound_ms"] / 1e3 * run["steps"] * run["frames"]
    return 100.0 * work_s / run["window_s"]
