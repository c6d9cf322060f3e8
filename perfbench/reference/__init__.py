"""Plain float32 PyTorch references of what the benchmark's cells run.

Nothing here imports the program or JAX. Every convolution and matrix
product goes through :class:`precision.Precision`, so the same code runs
in float32 with TF32 off (the reference) or rounded to a lower precision
(the control that the comparison must reject).
"""

import math

import torch


def seeded_params(init: dict, gen: torch.Generator, device) -> dict[str, torch.Tensor]:
    """float32 parameters for ``init`` (name -> (shape, init)), drawn on
    ``device`` in one call: U(-1/sqrt(fan_in), 1/sqrt(fan_in)), ones or
    zeros."""
    sizes = [math.prod(shape) for shape, _ in init.values()]
    flat = torch.rand(sum(sizes), generator=gen, device=device) * 2.0 - 1.0
    out = {}
    for (name, (shape, kind)), part in zip(init.items(), flat.split(sizes)):
        if kind[0] == "uniform":
            out[name] = (part / math.sqrt(kind[1])).reshape(shape)
        else:
            fill = torch.ones if kind[0] == "ones" else torch.zeros
            out[name] = fill(shape, device=device)
    return out
