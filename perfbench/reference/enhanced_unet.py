"""EnhancedUNet, as the reference repository's ``src/model.py`` describes it.

A 5-level residual U-Net over NCHW float32 at ``init_features`` f (16
published): residual blocks (Conv3x3-BN-ReLU-Dropout(0.2)-Conv3x3-BN
plus a shortcut, a 1x1 conv and BN where the width changes, then ReLU)
at widths f .. 16f with MaxPool2d(2) between them; a bottleneck of two
dilated (2) 3x3 convs to 32f with BN, ReLU and dropout after the first;
five decoder levels of ConvTranspose2d(k=2, s=2), an additive attention
gate on the skip (``x * sigmoid(BN(psi(relu(BN(W_g up) + BN(W_x skip)))))``)
and a residual block over ``cat([up, gated], 1)``; a 1x1 conv and a
sigmoid.

BatchNorm is flax's (momentum 0.9, eps 1e-5): training normalizes with
the batch mean and biased variance. The running statistics feed nothing
that a training step returns, so the reference keeps none.

Parameters carry the flax model's names (``enc1.conv1``, ``enc1.bn1.scale``,
``attention3.w_g_bias`` ...) in torch layouts: convs (O, I, kh, kw),
up-convs (I, O, 2, 2). Dropout draws its keep mask from the generator
passed in, in the model's NHWC order, one ``torch.rand`` per site, in the
order the sites run.

``input_dtype`` is the dtype the model takes its input in: the input and
the two convs that read it (``enc1.conv1`` and ``enc1.shortcut_conv``)
compute in it, operands, products and results, up to the BatchNorms that
follow them, which compute in float32 as everything after them does. A
bfloat16 model does so, as the configuration states; the other convs
round as ``q`` says (float32 rounds nothing).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .precision import Precision

DROPOUT = 0.2


class _Ctx:
    def __init__(self, p, q, generator):
        self.p, self.q, self.gen = p, q, generator

    def conv(self, x, name, bias=None, dtype=None, **kw):
        b = self.p[bias] if bias else None
        if dtype is not None and dtype != torch.float32:  # in the input's dtype
            return F.conv2d(x.to(dtype), self.p[name].to(dtype), b, **kw).float()
        q = self.q
        return q.result(F.conv2d(q.operand(x), q.operand(self.p[name]), b, **kw))

    def bn(self, x, name):
        mean = x.mean(dim=(0, 2, 3), keepdim=True)
        var = (x - mean).square().mean(dim=(0, 2, 3), keepdim=True)
        scale = self.p[f"{name}.scale"][None, :, None, None]
        bias = self.p[f"{name}.bias"][None, :, None, None]
        return (x - mean) * torch.rsqrt(var + 1e-5) * scale + bias

    def dropout(self, x):
        if self.gen is None:
            return x
        n, c, h, w = x.shape
        keep = torch.rand((n, h, w, c), generator=self.gen, device=x.device) < 1.0 - DROPOUT
        return torch.where(keep.permute(0, 3, 1, 2), x / (1.0 - DROPOUT), torch.zeros_like(x))

    def residual(self, x, name, dtype=None):
        y = self.dropout(torch.relu(self.bn(self.conv(x, f"{name}.conv1", dtype=dtype,
                                                      padding=1), f"{name}.bn1")))
        y = self.bn(self.conv(y, f"{name}.conv2", padding=1), f"{name}.bn2")
        if f"{name}.shortcut_conv" in self.p:
            x = self.bn(self.conv(x, f"{name}.shortcut_conv", dtype=dtype), f"{name}.shortcut_bn")
        return torch.relu(y + x)

    def attention(self, g, x, name):
        g1 = self.bn(self.conv(g, f"{name}.w_g", f"{name}.w_g_bias"), f"{name}.bn_g")
        x1 = self.bn(self.conv(x, f"{name}.w_x", f"{name}.w_x_bias"), f"{name}.bn_x")
        psi = self.bn(self.conv(torch.relu(g1 + x1), f"{name}.psi", f"{name}.psi_bias"),
                      f"{name}.bn_psi")
        return x * torch.sigmoid(psi)


def forward(p: dict, x: torch.Tensor, q: Precision = Precision("f32"), *,
            generator: torch.Generator | None = None,
            input_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(N, 1, H, W) -> (N, 1, H, W) in [0, 1], H and W divisible by 32; in
    training mode (batch statistics, dropout) when ``generator`` is given."""
    c = _Ctx(p, q, generator)
    enc = [c.residual(x.to(input_dtype), "enc1", dtype=input_dtype)]
    for i in (2, 3, 4, 5):
        enc.append(c.residual(F.max_pool2d(enc[-1], 2), f"enc{i}"))
    b = c.conv(F.max_pool2d(enc[-1], 2), "bottleneck_conv1", padding=2, dilation=2)
    b = c.dropout(torch.relu(c.bn(b, "bottleneck_bn1")))
    b = c.conv(b, "bottleneck_conv2", padding=2, dilation=2)
    d = torch.relu(c.bn(b, "bottleneck_bn2"))
    for i in (5, 4, 3, 2, 1):
        up = q.result(F.conv_transpose2d(q.operand(d), q.operand(p[f"upconv{i}.weight"]),
                                         p[f"upconv{i}.bias"], stride=2))
        gated = c.attention(up, enc[i - 1], f"attention{i}")
        d = c.residual(torch.cat([up, gated], 1), f"dec{i}")
    return torch.sigmoid(c.conv(d, "output_weight", "output_bias"))


def parameter_init(features: int = 16) -> dict[str, tuple]:
    """name -> (shape, init) for every parameter, ``init`` one of
    ("uniform", fan_in), ("ones",), ("zeros",): torch's default conv init
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)) and BatchNorm's ones and zeros."""
    out: dict[str, tuple] = {}

    def conv(name, cout, cin, k):
        out[name] = ((cout, cin, k, k), ("uniform", cin * k * k))

    def bn(name, ch):
        out[f"{name}.scale"] = ((ch,), ("ones",))
        out[f"{name}.bias"] = ((ch,), ("zeros",))

    def residual(name, cin, ch):
        conv(f"{name}.conv1", ch, cin, 3)
        bn(f"{name}.bn1", ch)
        conv(f"{name}.conv2", ch, ch, 3)
        bn(f"{name}.bn2", ch)
        if cin != ch:
            conv(f"{name}.shortcut_conv", ch, cin, 1)
            bn(f"{name}.shortcut_bn", ch)

    widths = [features * 2 ** i for i in range(5)]
    cin = 1
    for i, w in enumerate(widths, start=1):
        residual(f"enc{i}", cin, w)
        cin = w
    conv("bottleneck_conv1", 32 * features, 16 * features, 3)
    bn("bottleneck_bn1", 32 * features)
    conv("bottleneck_conv2", 32 * features, 32 * features, 3)
    bn("bottleneck_bn2", 32 * features)
    below = 32 * features
    for i, w in zip((5, 4, 3, 2, 1), reversed(widths)):
        out[f"upconv{i}.weight"] = ((below, w, 2, 2), ("uniform", 4 * w))
        out[f"upconv{i}.bias"] = ((w,), ("uniform", 4 * w))
        a = f"attention{i}"
        for part, cin_a, cout in (("w_g", w, w // 2), ("w_x", w, w // 2), ("psi", w // 2, 1)):
            conv(f"{a}.{part}", cout, cin_a, 1)
            out[f"{a}.{part}_bias"] = ((cout,), ("uniform", cin_a))
        for part, ch in (("bn_g", w // 2), ("bn_x", w // 2), ("bn_psi", 1)):
            bn(f"{a}.{part}", ch)
        residual(f"dec{i}", 2 * w, w)
        below = w
    conv("output_weight", 1, features, 1)
    out["output_bias"] = ((1,), ("uniform", features))
    return out
