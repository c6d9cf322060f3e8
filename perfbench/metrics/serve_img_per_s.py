"""Images answered in the window over the window's seconds (closed loop)."""


def read(run):
    w = run.window
    return w["images"] / w["window_s"] if w.get("window_s") else None
