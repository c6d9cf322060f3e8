"""Image-quality metrics on tensors.

Counterpart of ``image_enhancement_deglaring_tpu.ops.metrics``, with the
same values (scikit-image's defaults, ``data_range=1.0``):

- L1: mean |pred - target| in float32;
- PSNR: 10*log10(data_range^2 / mse);
- SSIM: 7x7 uniform window, K1=0.01, K2=0.03, sample covariance
  (NP/(NP-1)), averaged over the VALID window positions, which are the
  positions scikit-image keeps after cropping the window radius.
"""

from __future__ import annotations

import torch


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean absolute error in float32."""
    return torch.mean(torch.abs(pred.float() - target.float()))


def psnr(pred: torch.Tensor, target: torch.Tensor, *, data_range: float = 1.0) -> torch.Tensor:
    """Peak signal-to-noise ratio in dB over the whole tensor."""
    mse = torch.mean(torch.square(pred.float() - target.float()))
    return 10.0 * torch.log10((data_range * data_range) / mse)


def _uniform_filter_valid(x: torch.Tensor, win: int) -> torch.Tensor:
    """Mean over win x win windows, VALID, on (..., H, W): a sum over the
    rows' windows, then over the columns' windows."""
    y = x.unfold(-2, win, 1).sum(-1)
    y = y.unfold(-1, win, 1).sum(-1)
    return y * (1.0 / (win * win))


def _ssim_map(pred: torch.Tensor, target: torch.Tensor, *, data_range: float, win_size: int,
              k1: float, k2: float) -> torch.Tensor:
    if pred.shape[-2] < win_size or pred.shape[-1] < win_size:
        # an image smaller than the window has no VALID position: its mean
        # would be a silent NaN
        raise ValueError(f"ssim win_size={win_size} exceeds image extent "
                         f"{pred.shape[-2]}x{pred.shape[-1]}")
    x, y = pred.float(), target.float()
    np_ = win_size * win_size
    cov_norm = np_ / (np_ - 1.0)
    ux = _uniform_filter_valid(x, win_size)
    uy = _uniform_filter_valid(y, win_size)
    uxx = _uniform_filter_valid(x * x, win_size)
    uyy = _uniform_filter_valid(y * y, win_size)
    uxy = _uniform_filter_valid(x * y, win_size)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    a1 = 2.0 * ux * uy + c1
    a2 = 2.0 * vxy + c2
    b1 = ux * ux + uy * uy + c1
    b2 = vx + vy + c2
    return (a1 * a2) / (b1 * b2)


def ssim(pred: torch.Tensor, target: torch.Tensor, *, data_range: float = 1.0,
         win_size: int = 7, k1: float = 0.01, k2: float = 0.03) -> torch.Tensor:
    """Structural similarity of one 2-D image pair (H, W). Raises
    ValueError for an image smaller than the window, as scikit-image does."""
    return _ssim_map(pred, target, data_range=data_range, win_size=win_size, k1=k1,
                     k2=k2).mean()


def _single_channel(pred: torch.Tensor, target: torch.Tensor):
    p, t = pred.float(), target.float()
    if p.dim() == 4:
        if p.shape[-1] == 1:      # NHW1
            p, t = p[..., 0], t[..., 0]
        elif p.shape[1] == 1:     # N1HW
            p, t = p[:, 0], t[:, 0]
        else:
            raise ValueError(f"batched_psnr_ssim expects single-channel images (NHW1, "
                             f"N1HW, or NHW); got shape {tuple(pred.shape)}")
    return p, t


def batched_psnr_ssim(pred: torch.Tensor, target: torch.Tensor, *, data_range: float = 1.0,
                      clip_pred: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-image PSNR and SSIM over a batch of single-channel images (NHW1,
    N1HW or NHW), each of shape (N,). The prediction is clipped to [0, 1]
    first (``clip_pred``), as the reference's evaluator clips before the
    metrics but not before L1."""
    p, t = _single_channel(pred, target)
    if clip_pred:
        p = torch.clamp(p, 0.0, 1.0)
    mse = torch.mean(torch.square(p - t), dim=(-2, -1))
    psnrs = 10.0 * torch.log10((data_range * data_range) / mse)
    ssims = _ssim_map(p, t, data_range=data_range, win_size=7, k1=0.01,
                      k2=0.03).mean(dim=(-2, -1))
    return psnrs, ssims
