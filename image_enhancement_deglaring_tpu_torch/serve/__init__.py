"""Serving: the batched engine, tiled full-resolution inference, the HTTP
API and its PIL-free host image path.

Re-exports are lazy (PEP 562), as in the JAX package: importing one
module of the package loads no other.
"""

_EXPORTS = {
    "InferenceEngine": ".engine",
    "TiledInference": ".tiling",
    "DeglareServer": ".http_server",
    "create_server": ".http_server",
}

__all__ = list(_EXPORTS)


def __getattr__(name: str):
    target = _EXPORTS.get(name)
    if target is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    from importlib import import_module

    return getattr(import_module(target, __name__), name)
