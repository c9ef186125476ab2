"""Frames of the scene the editor received in the window, a second."""


def read(run):
    if "frame_times" not in run:
        return None
    return len(run["frame_times"]) / run["window_s"]
