"""Training images over the window: steps x batch over its seconds, the
window ending in ``torch.cuda.synchronize()``."""


def read(run):
    w = run.window
    return w["images"] / w["window_s"] if w.get("window_s") else None
