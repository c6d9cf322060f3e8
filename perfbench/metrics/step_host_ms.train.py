"""Host milliseconds of one training step (``make_step_body``'s body:
augmentation, forward, backward, clip, AdamW's update), the mean
``train.step`` span in the device-only traced slice."""

from perfbench import spans


def read(run):
    return spans.mean_ms(run, "train.step")
