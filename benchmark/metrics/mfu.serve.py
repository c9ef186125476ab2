"""The served frames' share of the card's peak: the least time of every
step of the frames the editor received in the window (the frozen count
over the live pairs of the program's state in the window, at the published
peaks), over the window's seconds. It bounds every kernel's roofline, so a
kernel taken off the path cannot leave a gain unseen."""


def read(run):
    least = run.get("step_least")
    if not least or not run.get("frame_times"):
        return None
    work_s = least["bound_ms"] / 1e3 * run["steps"] * len(run["frame_times"])
    return 100.0 * work_s / run["window_s"]
