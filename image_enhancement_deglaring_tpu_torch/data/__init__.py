"""The port's data pipeline: PNG codec, SD1 decode, augmentation, loaders.

Re-exports are lazy (PEP 562), as ``serve/__init__`` makes them: an HTTP
worker process imports ``data.png`` through ``serve.imaging`` and must not
load ``dataset``, which imports torch.
"""

_EXPORTS = {
    "heavy_augment": ".augment",
    "optimized_augment": ".augment",
    "DevicePrefetcher": ".dataset",
    "GlareRemovalDataset": ".dataset",
    "make_dataloaders": ".dataset",
    "make_eval_loader": ".dataset",
    "decode_inference_image": ".pipeline",
    "decode_triptych": ".pipeline",
    "list_image_paths": ".pipeline",
    "seeded_split": ".pipeline",
    "decode_png": ".png",
    "encode_png": ".png",
    "read_png": ".png",
    "write_png": ".png",
    "generate_synthetic_sd1": ".synthetic",
    "make_triptych": ".synthetic",
}

__all__ = list(_EXPORTS)


def __getattr__(name: str):
    target = _EXPORTS.get(name)
    if target is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    from importlib import import_module

    return getattr(import_module(target, __name__), name)
