"""EnhancedUNet: a 5-level residual U-Net with attention gates on the
skips, a dilated bottleneck and a sigmoid head.

PyTorch counterpart of ``image_enhancement_deglaring_tpu.models.
enhanced_unet``, with its parameter names and layouts. Its BatchNorm
follows ``flax.linen.BatchNorm(momentum=0.9, epsilon=1e-5)``, not
``torch.nn.BatchNorm2d``:

- training normalizes with the batch's mean and its biased variance,
  E[x^2] - E[x]^2 in float32 clipped at 0, and moves the running
  statistics to ``0.9 * old + 0.1 * batch`` with that same biased variance
  (``BatchNorm2d`` folds the unbiased variance into ``running_var``);
- the output is float32 whatever the input dtype (flax promotes the input
  with its float32 scale and bias), so in a bfloat16 model everything after
  the first BatchNorm computes in float32, as in the JAX model.

The running statistics are the buffers ``<module>.mean`` and
``<module>.var``: the JAX ``batch_stats`` collection under the same names.
Inside ``synced_batch_stats(mesh)`` (the train step over several ranks)
the batch statistics are those of the global batch, as JAX's step over
its global mesh takes them: each rank's per-channel sums are added over
the ranks (a differentiable all-reduce), so the running statistics move
alike on every rank.

Each BatchNorm call takes the activation after it as its epilogue (ReLU,
or ReLU of the sum with a second tensor: a residual block's shortcut, an
attention gate's other branch). A training-mode call on the card with
autograd on runs the port's BatchNorm training pair
(``ops.fused_kernels.bn_act_train``), which under ``synced_batch_stats``
adds its sums over the ranks between its launches; every other call (eval
mode, the CPU, a ``torch.func`` transform) runs the float32 composition.
Dropout(0.2) sits after the first BatchNorm of each residual block and of
the bottleneck; it draws from the generator the caller passes, so a
training run is a function of its seed.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch
from torch import nn

from ..ops import fused_kernels as fk
from ..ops.conv_blocks import conv2d, highest_precision, max_pool_2x2, stat_mean
from .unet import UpConv2x, _uniform


_SYNC_MESH: contextvars.ContextVar = contextvars.ContextVar("synced_batch_stats", default=None)


@contextlib.contextmanager
def synced_batch_stats(mesh):
    """Training-mode BatchNorm inside takes its statistics over the global
    batch of ``mesh`` (``parallel.mesh.DataMesh``); None or a one-rank mesh
    changes nothing."""
    token = _SYNC_MESH.set(mesh if mesh is not None and mesh.world > 1 else None)
    try:
        yield
    finally:
        _SYNC_MESH.reset(token)


def _batch_moments(xf: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-channel E[x] and E[x^2] of NHWC float32 ``xf`` over the batch,
    or over the global batch inside :func:`synced_batch_stats`."""
    mesh = _SYNC_MESH.get()
    if mesh is None:
        return (stat_mean(xf, (0, 1, 2)).reshape(-1),
                stat_mean(xf.square(), (0, 1, 2)).reshape(-1))
    from ..parallel.mesh import all_reduce_sum_autograd

    # float64 sums on the CPU, as stat_mean accumulates there
    acc = torch.float64 if xf.device.type == "cpu" else torch.float32
    c = xf.shape[-1]
    sums = torch.cat([xf.sum(dim=(0, 1, 2), dtype=acc), xf.square().sum(dim=(0, 1, 2), dtype=acc)])
    total = all_reduce_sum_autograd(sums, mesh) / (xf.numel() // c * mesh.world)
    return total[:c].float(), total[c:].float()


def _sums_hook():
    """The training pair's ``sums_hook`` inside :func:`synced_batch_stats`:
    per-channel sums added over the ranks, and the number of ranks."""
    mesh = _SYNC_MESH.get()
    if mesh is None:
        return None
    from ..parallel.mesh import all_reduce_sum

    return lambda sums: (all_reduce_sum(sums.clone(), mesh), mesh.world)


class BatchNorm(nn.Module):
    """flax's BatchNorm over the channel axis of NHWC input (see the module
    docstring); ``train`` uses the batch statistics and updates the running
    ones in place. ``act="relu"`` applies ReLU to the output, after adding
    ``residual`` where it is given."""

    def __init__(self, features: int, *, momentum: float = 0.9, eps: float = 1e-5, device=None):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.scale = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("mean", torch.zeros(features, device=device))
        self.register_buffer("var", torch.ones(features, device=device))

    def forward(self, x: torch.Tensor, train: bool = False, *, act: str | None = None,
                residual: torch.Tensor | None = None) -> torch.Tensor:
        if act not in (None, "relu") or (residual is not None and act != "relu"):
            raise ValueError(f"BatchNorm epilogue act={act!r} with residual "
                             f"{residual is not None}: want None, 'relu', or 'relu' with it")
        if train and fk.bn_route(x, self.scale, self.bias, residual) == "kernels":
            return fk.bn_act_train(x, self.scale, self.bias, act=act, residual=residual,
                                   eps=self.eps, momentum=self.momentum,
                                   running=(self.mean, self.var), sums_hook=_sums_hook())
        xf = x.float()
        if train:
            mean, mean2 = _batch_moments(xf)
            var = torch.clamp(mean2 - mean.square(), min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1 - m) * mean)
                self.var.copy_(m * self.var + (1 - m) * var)
        else:
            mean, var = self.mean, self.var
        y = (xf - mean) * (torch.rsqrt(var + self.eps) * self.scale) + self.bias
        if residual is not None:
            y = y + residual
        return y if act is None else torch.relu(y)


def dropout(x: torch.Tensor, rate: float, train: bool, generator) -> torch.Tensor:
    """flax's Dropout: keep each element with probability 1 - rate and scale
    the kept ones by 1 / (1 - rate); the identity outside training."""
    if not train or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in training needs a generator")
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


class ResidualBlock(nn.Module):
    """Conv3x3-BN-ReLU-Dropout-Conv3x3-BN plus a shortcut (a 1x1 conv and BN
    where the width changes), then ReLU."""

    def __init__(self, in_features: int, features: int, *, dropout_rate: float = 0.2,
                 generator=None, device=None):
        super().__init__()
        f = features
        self.dropout_rate = dropout_rate
        self.conv1 = _uniform((3, 3, in_features, f), 9 * in_features, generator, device)
        self.bn1 = BatchNorm(f, device=device)
        self.conv2 = _uniform((3, 3, f, f), 9 * f, generator, device)
        self.bn2 = BatchNorm(f, device=device)
        if in_features != f:
            self.shortcut_conv = _uniform((1, 1, in_features, f), in_features, generator, device)
            self.shortcut_bn = BatchNorm(f, device=device)

    def forward(self, x: torch.Tensor, train: bool = False, generator=None) -> torch.Tensor:
        y = self.bn1(conv2d(x, self.conv1, padding=1), train, act="relu")
        y = dropout(y, self.dropout_rate, train, generator)
        shortcut = x
        if hasattr(self, "shortcut_conv"):
            shortcut = self.shortcut_bn(conv2d(x, self.shortcut_conv), train)
        return self.bn2(conv2d(y, self.conv2, padding=1), train, act="relu", residual=shortcut)


class AttentionGate(nn.Module):
    """Additive attention gate: x * sigmoid(BN(psi(relu(BN(W_g g) + BN(W_x x)))))."""

    def __init__(self, g_features: int, x_features: int, f_int: int, *, generator=None,
                 device=None):
        super().__init__()
        self.w_g = _uniform((1, 1, g_features, f_int), g_features, generator, device)
        self.w_g_bias = _uniform((f_int,), g_features, generator, device)
        self.w_x = _uniform((1, 1, x_features, f_int), x_features, generator, device)
        self.w_x_bias = _uniform((f_int,), x_features, generator, device)
        self.psi = _uniform((1, 1, f_int, 1), f_int, generator, device)
        self.psi_bias = _uniform((1,), f_int, generator, device)
        self.bn_g = BatchNorm(f_int, device=device)
        self.bn_x = BatchNorm(f_int, device=device)
        self.bn_psi = BatchNorm(1, device=device)

    def forward(self, g: torch.Tensor, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        g1 = self.bn_g(conv2d(g, self.w_g, self.w_g_bias), train)
        s = self.bn_x(conv2d(x, self.w_x, self.w_x_bias), train, act="relu", residual=g1)
        psi = self.bn_psi(conv2d(s, self.psi, self.psi_bias), train)
        return x * torch.sigmoid(psi)


class EnhancedUNet(nn.Module):
    """EnhancedUNet (``init_features`` 16 is the published width: 5 levels
    of 16..256 channels and a 512-channel bottleneck). Input is NHWC with
    sides divisible by 32; output float32 in [0, 1].

    ``forward(x, train=False, generator=None)``: ``train=True`` normalizes
    with batch statistics, updates the running ones and applies dropout
    from ``generator``. ``dropout_rate`` is the published 0.2."""

    def __init__(self, in_channels: int = 1, out_channels: int = 1, init_features: int = 16,
                 dtype: torch.dtype = torch.float32, *, dropout_rate: float = 0.2,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        self.dtype = dtype
        self.dropout_rate = dropout_rate
        f = init_features
        kw = dict(generator=generator, device=device)
        block = dict(dropout_rate=dropout_rate, **kw)
        widths = [f, f * 2, f * 4, f * 8, f * 16]
        cin = in_channels
        for i, w in enumerate(widths, start=1):
            setattr(self, f"enc{i}", ResidualBlock(cin, w, **block))
            cin = w
        self.bottleneck_conv1 = _uniform((3, 3, f * 16, f * 32), 9 * f * 16, generator, device)
        self.bottleneck_bn1 = BatchNorm(f * 32, device=device)
        self.bottleneck_conv2 = _uniform((3, 3, f * 32, f * 32), 9 * f * 32, generator, device)
        self.bottleneck_bn2 = BatchNorm(f * 32, device=device)
        below = f * 32
        for i, w in zip((5, 4, 3, 2, 1), reversed(widths)):
            setattr(self, f"upconv{i}", UpConv2x(below, w, **kw))
            setattr(self, f"attention{i}", AttentionGate(w, w, w // 2, **kw))
            setattr(self, f"dec{i}", ResidualBlock(2 * w, w, **block))
            below = w
        self.output_weight = _uniform((1, 1, f, out_channels), f, generator, device)
        self.output_bias = _uniform((out_channels,), f, generator, device)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        exact = self.dtype == torch.float32
        with highest_precision() if exact else contextlib.nullcontext():
            x = x.to(self.dtype)
            enc = [self.enc1(x, train, generator)]
            for i in (2, 3, 4, 5):
                enc.append(getattr(self, f"enc{i}")(max_pool_2x2(enc[-1]), train, generator))
            b = conv2d(max_pool_2x2(enc[-1]), self.bottleneck_conv1, padding=2, dilation=2)
            b = self.bottleneck_bn1(b, train, act="relu")
            b = dropout(b, self.dropout_rate, train, generator)
            b = conv2d(b, self.bottleneck_conv2, padding=2, dilation=2)
            d = self.bottleneck_bn2(b, train, act="relu")
            for i in (5, 4, 3, 2, 1):
                up = getattr(self, f"upconv{i}")(d)
                gated = getattr(self, f"attention{i}")(up, enc[i - 1], train)
                d = getattr(self, f"dec{i}")(torch.cat([up, gated], dim=-1), train, generator)
            out = torch.sigmoid(conv2d(d, self.output_weight, self.output_bias))
        return out.float()
