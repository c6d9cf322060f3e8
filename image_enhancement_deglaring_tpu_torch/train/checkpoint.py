"""Checkpoints with exact resume.

Counterpart of ``image_enhancement_deglaring_tpu.train.checkpoint``. A
checkpoint is a directory:

- ``params.npz``: the parameters under the JAX package's flat names
  ("enc1/conv1", ``export_jax_params`` + ``flatten_tree``);
- ``opt_state.npz``: the optimizer state under optax's leaf names
  (the mapping in ``modelio.params_import``), when there is one;
- ``model_state.npz``: the model's mutable collections under their JAX
  names ("batch_stats/enc1/bn1/mean", EnhancedUNet's BatchNorm running
  statistics), when it has any;
- ``train_meta.json``: ``epoch``, ``val_loss``, ``model_arch`` and the
  caller's extras (LR-controller state, step, generator state, early-stop
  counter, mid-epoch position), the JAX package's keys.

npz holds no pickled objects, so reading a checkpoint runs no code.

Over several processes rank 0 alone writes (``save_checkpoint`` returns
the path on every rank and writes nothing elsewhere), and
:func:`restore_checkpoint_all_hosts` reads on rank 0 and broadcasts.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile

import numpy as np

from ..modelio.params_import import arch_from_param_keys
from ..utils.pytree import flatten_tree, unflatten_tree


def save_checkpoint(path: str, *, params: dict, opt_state: dict | None = None,
                    model_state: dict | None = None, epoch: int = 0,
                    val_loss: float | None = None, extra: dict | None = None) -> str:
    """Write a checkpoint directory at ``path``, replacing any there.
    ``params``: the JAX-named tree of arrays; ``opt_state``: optax's flat
    leaves (``export_jax_opt_state``); ``model_state``: the mutable
    collections ({"batch_stats": tree}), written when not empty. The directory is written beside
    ``path`` and renamed into place, so a reader never sees half of it. In a
    process group only rank 0 writes."""
    from ..parallel.distributed import process_index

    path = os.path.abspath(path)
    if process_index() != 0:
        return path
    parent = os.path.dirname(path)
    os.makedirs(parent, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=".ckpt-", dir=parent)
    try:
        np.savez(os.path.join(tmp, "params.npz"),
                 **{k: np.asarray(v) for k, v in flatten_tree(params).items()})
        if opt_state is not None:
            np.savez(os.path.join(tmp, "opt_state.npz"),
                     **{k: np.asarray(v) for k, v in opt_state.items()})
        if model_state:
            np.savez(os.path.join(tmp, "model_state.npz"),
                     **{k: np.asarray(v) for k, v in flatten_tree(model_state).items()})
        meta = {"epoch": epoch, "val_loss": val_loss,
                "model_arch": arch_from_param_keys(params.keys()), **(extra or {})}
        with open(os.path.join(tmp, "train_meta.json"), "w") as f:
            json.dump(meta, f)
        if os.path.isdir(path):
            shutil.rmtree(path)
        os.replace(tmp, path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return path


def restore_checkpoint(path: str):
    """Returns (item, meta): item["params"] the JAX-named tree of numpy
    arrays, item["opt_state"] optax's flat leaves and item["model_state"]
    the mutable collections' tree when saved."""
    path = os.path.abspath(path)
    with np.load(os.path.join(path, "params.npz")) as f:
        item = {"params": unflatten_tree({k: f[k] for k in f.files})}
    opt_path = os.path.join(path, "opt_state.npz")
    if os.path.exists(opt_path):
        with np.load(opt_path) as f:
            item["opt_state"] = {k: f[k] for k in f.files}
    state_path = os.path.join(path, "model_state.npz")
    if os.path.exists(state_path):
        with np.load(state_path) as f:
            item["model_state"] = unflatten_tree({k: f[k] for k in f.files})
    meta = {}
    meta_path = os.path.join(path, "train_meta.json")
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    return item, meta


def restore_checkpoint_all_hosts(path: str, *, params_template: dict,
                                 opt_state_template: dict | None = None,
                                 model_state_template: dict | None = None, mesh=None):
    """``(item, meta)`` as :func:`restore_checkpoint` gives them, read by
    rank 0 alone and broadcast, so every rank starts from the same state
    even where ``path`` is a rank's local disk or missing elsewhere.

    The templates (the current model's JAX-named trees and flat optimizer
    leaves) fix the leaves each rank receives. A read failure on rank 0,
    or a checkpoint whose trees do not match them, raises the same
    RuntimeError on every rank instead of leaving the others waiting in
    the next collective. One process: :func:`restore_checkpoint`."""
    from ..parallel.distributed import process_count
    from ..parallel.mesh import broadcast_arrays, broadcast_bytes, make_mesh

    if process_count() == 1:
        return restore_checkpoint(path)

    mesh = mesh or make_mesh()
    templates = {"params": flatten_tree(params_template)}
    if opt_state_template is not None:
        templates["opt_state"] = dict(opt_state_template)
    if model_state_template:
        templates["model_state"] = flatten_tree(model_state_template)
    flat, meta, err, present = {}, None, "", []
    if mesh.rank == 0:
        try:
            item, meta = restore_checkpoint(path)
            for key, tmpl in templates.items():
                if key not in item:
                    if key == "model_state":
                        continue  # the loop keeps the model's own statistics
                    raise KeyError(f"checkpoint has no '{key}' tree")
                got = item[key] if key == "opt_state" else flatten_tree(item[key])
                if {k: np.shape(v) for k, v in got.items()} != {
                        k: np.shape(v) for k, v in tmpl.items()}:
                    raise ValueError(f"checkpoint '{key}' does not match the current model/"
                                     f"optimizer ({len(got)} leaves vs {len(tmpl)} expected — "
                                     "resumed with a different --model?)")
                flat[key] = got
                present.append(key)
        except Exception as e:  # broadcast the failure, raise on every rank
            err = f"{type(e).__name__}: {e}"
    payload = json.dumps({"err": err} if err else {"meta": meta, "present": present})
    decoded = json.loads(broadcast_bytes(payload.encode() if mesh.rank == 0 else None, mesh))
    if "err" in decoded:
        raise RuntimeError(f"multi-process resume: rank 0 could not restore {path}: "
                           f"{decoded['err']}")
    item = {}
    for key in decoded["present"]:
        names = sorted(templates[key])
        leaves = broadcast_arrays([flat[key][k] for k in names] if mesh.rank == 0 else None,
                                  [templates[key][k] for k in names], mesh)
        tree = dict(zip(names, leaves))
        item[key] = tree if key == "opt_state" else unflatten_tree(tree)
    return item, decoded["meta"]


def restore_params(path: str) -> dict:
    """Params-only restore (for eval and serving)."""
    return restore_checkpoint(path)[0]["params"]
