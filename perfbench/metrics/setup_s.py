"""Set-up: from the start of the process to the opening of the window
(imports, kernel builds or loads, inputs, weights, warm-up)."""


def read(run):
    return run.setup_s
