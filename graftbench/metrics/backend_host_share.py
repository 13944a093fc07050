"""Share of the window's host time inside the backend's engine calls."""


def read(run):
    if not run.spans or run.traced_s <= 0:
        return None
    return 100.0 * run.spans["backend_s"] / run.traced_s
