"""Live particles times the steps completed in the window, over the window's
seconds; the window ends at a device synchronise."""

def read(run):
    if "particle_steps" not in run:
        return None
    return run["particle_steps"] / run["window_s"]
