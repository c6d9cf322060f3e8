"""Tiled full-resolution inference on one CUDA device, or over the local
cards.

PyTorch counterpart of ``image_enhancement_deglaring_tpu.serve.tiling``
with the same public surface (``TiledInference``: ``__call__``,
``num_tiles``, ``compiled_bucket_count``, ``reload_params``). The device
only sees batches of tiles ``(B, tile, tile, 1)`` with B drawn from the
power-of-two ladder {1, 2, ..., max_tiles_per_batch}, so any stream of
input resolutions runs a bounded set of shapes (and of cuDNN plans).
Tile extraction and the feathered overlap-stitch are numpy on the host,
in float32 and in the JAX module's order; the U-Net forward runs on the
device, uint8 in.

Launches go to the device's current stream, the one ``InferenceEngine``
uses, so tile batches and engine batches run in launch order and share
the GroupNorm kernel's per-stream workspace under its lock. The forward
runs under ``torch.inference_mode()``: the kernel wrappers refuse to run
on the card while grad mode could record them.
"""

from __future__ import annotations


import numpy as np
import torch

from ..parallel.mesh import replica_devices
from .engine import on_device, reloaded, replicate_model


def _grid_starts(size: int, tile: int, stride: int) -> list[int]:
    """Start offsets covering [0, size) with ``tile`` windows."""
    if size <= tile:
        return [0]
    starts = list(range(0, size - tile, stride))
    starts.append(size - tile)
    return starts


def _blend_window(tile: int, overlap: int) -> np.ndarray:
    """2-D feathering window: linear ramps on the overlapping margins."""
    if overlap <= 0:
        return np.ones((tile, tile), np.float32)
    ramp = np.ones(tile, np.float32)
    edge = np.linspace(1.0 / (overlap + 1), 1.0, overlap, dtype=np.float32)
    ramp[:overlap] = edge
    ramp[-overlap:] = edge[::-1]
    return ramp[:, None] * ramp[None, :]


class TiledInference:
    """Full-resolution tiled forward of a model that maps NHWC float
    (B, T, T, 1) to (B, T, T, 1)."""

    def __init__(self, model: torch.nn.Module, *, tile: int = 512, overlap: int = 32,
                 compute_dtype: torch.dtype = torch.bfloat16, mesh=None,
                 max_tiles_per_batch: int = 8, pipeline_depth: int = 4, device=None):
        """``model`` is moved to ``device`` and put in eval mode (an
        engine's model can be shared). ``max_tiles_per_batch`` caps the
        tiles per device call; larger images run in several chunks,
        launched asynchronously, at most ``pipeline_depth`` in flight.
        ``device`` defaults to CUDA and raises without a card unless "cpu"
        is passed. ``mesh``: a ``parallel.mesh.LocalMesh``, one replica per
        device (the model itself on the first)."""
        if not 0 <= overlap < tile:
            # overlap == tile -> stride 0 (range() crash per request);
            # overlap > tile -> negative stride silently leaves uncovered
            # (black) bands in the stitched output
            raise ValueError(
                f"tile overlap must be in [0, tile): got overlap={overlap} "
                f"with tile={tile}")
        devices = replica_devices(device, mesh)
        self.mesh = mesh
        self.device = devices[0]
        self._replicas = replicate_model(model, devices)
        self.tile = tile
        self.overlap = overlap
        self.compute_dtype = compute_dtype
        self.max_tiles_per_batch = max_tiles_per_batch
        self.pipeline_depth = max(1, pipeline_depth)
        self._window = _blend_window(tile, overlap)
        self._buckets_seen: set[int] = set()

    @property
    def model(self) -> torch.nn.Module:
        """The first replica (the model the tiler was given)."""
        return self._replicas[0]

    def reload_params(self, params) -> None:
        """Weight swap from the JAX package's parameter tree: the new
        weights go into copies of the replicas that replace the old ones in
        one attribute rebind, so an image in flight finishes on the
        weights it started with."""
        self._replicas = reloaded(self._replicas, params)

    @property
    def compiled_bucket_count(self) -> int:
        """Distinct tile-batch shapes run so far (one per bucket),
        independent of how many input resolutions were served."""
        return len(self._buckets_seen)

    def _bucket_for(self, n: int) -> int:
        b = 1
        while b < n:
            b *= 2
        b = min(b, self.max_tiles_per_batch)
        if self.mesh is not None:
            d = self.mesh.size
            b = max(d, -(-b // d) * d)
        return b

    def _forward(self, replicas: tuple, tiles_u8: np.ndarray) -> list:
        """uint8 (B, T, T, 1) -> float32 (B / n, T, T) per replica on its
        device, launched asynchronously: normalize + U-Net."""
        rows = tiles_u8.shape[0] // len(replicas)
        outs = []
        for i, model in enumerate(replicas):
            dev = next(model.parameters()).device
            with on_device(dev):
                x = torch.from_numpy(tiles_u8[i * rows:(i + 1) * rows]).to(dev, non_blocking=True)
                outs.append(model(x.to(self.compute_dtype) / 255.0).float()[..., 0])
        return outs

    def _run_tiles(self, tiles_u8: np.ndarray) -> np.ndarray:
        """uint8 (N, T, T) -> float32 (N, T, T), chunked into bucket-shaped
        device batches."""
        n = tiles_u8.shape[0]
        out = np.empty(tiles_u8.shape, np.float32)
        step = self.max_tiles_per_batch
        # one set of replicas for the whole image: a concurrent
        # reload_params() must not stitch one image from two checkpoints
        replicas = self._replicas
        pending: list = []

        def drain_one():
            c0_, b_, res = pending.pop(0)
            out[c0_ : c0_ + b_] = np.concatenate([r.cpu().numpy() for r in res])[:b_]

        with torch.inference_mode():
            for c0 in range(0, n, step):
                chunk = tiles_u8[c0 : c0 + step]
                b = chunk.shape[0]
                bucket = self._bucket_for(b)
                self._buckets_seen.add(bucket)
                if bucket > b:
                    chunk = np.concatenate(
                        [chunk, np.zeros((bucket - b,) + chunk.shape[1:], np.uint8)])
                pending.append((c0, b, self._forward(replicas,
                                                     np.ascontiguousarray(chunk[..., None]))))
                # bounded window: a huge image must not keep every chunk's
                # buffers alive on the device at once
                if len(pending) >= self.pipeline_depth:
                    drain_one()
            while pending:
                drain_one()
        return out

    def __call__(self, img_u8: np.ndarray) -> np.ndarray:
        """uint8 (H, W) grayscale -> de-glared uint8 (H, W)."""
        h, w = img_u8.shape
        tile, stride = self.tile, self.tile - self.overlap
        ph, pw = max(tile, h), max(tile, w)
        if (ph, pw) != (h, w):
            img_u8 = np.pad(img_u8, ((0, ph - h), (0, pw - w)), mode="edge")
        ys = _grid_starts(ph, tile, stride)
        xs = _grid_starts(pw, tile, stride)

        tiles = np.stack([img_u8[y0 : y0 + tile, x0 : x0 + tile]
                          for y0 in ys for x0 in xs])
        out_tiles = self._run_tiles(tiles)

        # feathered overlap blend, then clip -> trunc-to-uint8, the
        # reference's post-processing (reference: api/app.py:190-194)
        acc = np.zeros((ph, pw), np.float32)
        wacc = np.zeros((ph, pw), np.float32)
        win = self._window
        k = 0
        for y0 in ys:
            for x0 in xs:
                acc[y0 : y0 + tile, x0 : x0 + tile] += out_tiles[k] * win
                wacc[y0 : y0 + tile, x0 : x0 + tile] += win
                k += 1
        stitched = acc / np.maximum(wacc, 1e-8)
        out = np.floor(np.clip(stitched, 0.0, 1.0) * 255.0).astype(np.uint8)
        return out[:h, :w]

    def num_tiles(self, h: int, w: int) -> int:
        stride = self.tile - self.overlap
        return len(_grid_starts(max(h, self.tile), self.tile, stride)) * len(
            _grid_starts(max(w, self.tile), self.tile, stride)
        )
