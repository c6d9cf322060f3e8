"""Training augmentation on the device, batched.

Counterpart of ``image_enhancement_deglaring_tpu.ops.augment_device``: the
distributions of ``data.augment.optimized_augment``, per sample, on NHWC
tensors where they lie, so the host input path only decodes. Horizontal
flip (p = .5) on image and target together, then OneOf (p = .5) on the
image only: brightness/contrast (weight .8; alpha = 1 + U(-.2, .2),
beta = U(-.2, .2), clipped to [0, 1]) or Gaussian noise (weight .2;
variance U(10, 50) / 255^2, clipped to [0, 1]). The arithmetic is float32,
the result in the input dtype.

Every draw comes from the generator the caller passes, on the tensors'
device: a training run is a function of its seed. The bits differ from
JAX's stream by construction; the distributions are the same.
"""

from __future__ import annotations

import torch


def device_augment_batch(generator: torch.Generator, images: torch.Tensor,
                         targets: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Augment one (B, H, W, C) batch of values in [0, 1]; returns (images,
    targets) in their dtypes."""
    b, dev = images.shape[0], images.device

    def draw(*shape, normal: bool = False):
        fn = torch.randn if normal else torch.rand
        return fn(*shape, generator=generator, device=dev, dtype=torch.float32)

    def per_sample(v):
        return v[:, None, None, None]

    flip = per_sample(draw(b) < 0.5)
    do_pixel = per_sample(draw(b) < 0.5)
    pick_bc = per_sample(draw(b) < 0.8)
    alpha = per_sample(1.0 + (draw(b) * 0.4 - 0.2))
    beta = per_sample(draw(b) * 0.4 - 0.2)
    var = per_sample((10.0 + 40.0 * draw(b)) / (255.0 ** 2))
    noise = draw(*images.shape, normal=True) * torch.sqrt(var)

    images = torch.where(flip, images.flip(2), images)
    targets = torch.where(flip, targets.flip(2), targets)
    xf = images.float()
    bc = torch.clamp(xf * alpha + beta, 0.0, 1.0)
    gn = torch.clamp(xf + noise, 0.0, 1.0)
    aug = torch.where(pick_bc, bc, gn).to(images.dtype)
    return torch.where(do_pixel, aug, images), targets
