"""Host milliseconds of the engine's device step (``_step``: the HtoD
staging copy and the model's launches), the mean ``engine.step`` span in
the traced slice."""

from perfbench import spans


def read(run):
    return spans.mean_ms(run, "engine.step")
