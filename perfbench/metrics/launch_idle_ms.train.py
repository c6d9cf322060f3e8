"""Milliseconds per training step that the device sat idle while the host
was inside the step: the traced slice's idle gaps whose middle lies inside
a ``train.step`` span, over the steps. The rest of ``idle_share.train``
falls between steps."""

from perfbench import spans


def read(run):
    return spans.idle_inside_ms(run, "train.step")
