"""The whole training step's share of the card's peak: three times the
forward FLOPs (forward, and the backward's two products) per image, times
the images trained per second in the window, over the peak of the
configuration's stated precision."""


def read(run):
    w = run.window
    if not w.get("window_s"):
        return None
    rate = w["images"] / w["window_s"]
    return 100.0 * 3 * run.family.flops_per_image(run.cfg) * rate / run.peak(run.cfg["peak"])
