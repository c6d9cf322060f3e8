"""The closed loop of ``drivers/serve.py`` for a configuration whose
weights are drawn from the seed (``families/restormer.py``): the family
reads them from ``cfg["weights_seed"]``, a stream of ``--seed`` that this
driver sets before the model is built, so the served model and the
reference get the same weights and every seed other ones. The traffic
parameters are ``drivers/serve.py``'s."""

from __future__ import annotations

from . import serve


def run(run) -> dict:
    run.cfg = dict(run.cfg, weights_seed=run.subseed("weights"))
    return serve.run(run)
