"""Synthetic glared document pages, drawn in bulk on the device.

The distributions of the port's SD1 generator (``data/synthetic.py``):
a light page (235 plus N(0, 3) noise) with 15 to 29 lines of broken dark
"words" (rows 2 to 4 pixels thick, ink U(20, 80)), plus one to three
additive Gaussian glare blobs of amplitude U(120, 220). The ground truth
is the page, the input the page with glare, both clipped to [0, 255] and
truncated to uint8 as the triptych PNGs store them.

Every draw comes from one ``torch.Generator`` on the device, in a few
calls over the whole chunk, so a run's set-up stays short and one seed
gives the same pages on the same device.
"""

from __future__ import annotations

import torch

MAX_LINES = 30
MAX_BLOBS = 3


def _uniform(gen, shape, lo, hi, device):
    return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device)


def _integers(gen, shape, lo, hi, device):
    """Integers in [lo, hi), as numpy's ``Generator.integers``."""
    return torch.randint(int(lo), int(hi), shape, generator=gen, device=device)


def _pages(gen: torch.Generator, n: int, size: int, device) -> torch.Tensor:
    """(n, size, size) float32 pages with text-like strokes, in [0, 255]."""
    s, lines = size, MAX_LINES
    page = 235.0 + 3.0 * torch.randn((n, s, s), generator=gen, device=device)
    n_lines = _integers(gen, (n, 1), 15, 30, device)
    active = torch.arange(lines, device=device)[None, :] < n_lines  # (n, L)
    y = _integers(gen, (n, lines), 10, s - 16, device)
    x0 = _integers(gen, (n, lines), 5, s // 3, device)
    x1 = _integers(gen, (n, lines), s // 2, s - 5, device)
    thick = _integers(gen, (n, lines), 2, 5, device)
    words = s // 12 + 1  # enough (segment + gap >= 12) to cross any line
    seg = _integers(gen, (n, lines, words), 8, 40, device)
    gap = _integers(gen, (n, lines, words), 4, 15, device)
    ink = _uniform(gen, (n, lines, words), 20.0, 80.0, device)
    starts = x0[..., None] + torch.cumsum(seg + gap, -1) - (seg + gap)  # (n, L, W)
    cols = torch.arange(s, device=device)
    # the word that holds each column of each line: the last start <= col
    k = torch.searchsorted(starts.reshape(-1, words).contiguous(),
                           cols.expand(n * lines, s).contiguous(), right=True) - 1
    k = k.reshape(n, lines, s)
    kc = k.clamp(min=0)
    start_k = torch.gather(starts, 2, kc)
    in_word = ((k >= 0) & (cols < start_k + torch.gather(seg, 2, kc))
               & (cols < x1[..., None]) & active[..., None])
    value = torch.gather(ink, 2, kc)
    rows = torch.arange(s, device=device)
    in_row = (rows >= y[..., None]) & (rows < (y + thick)[..., None]) & active[..., None]
    for line in range(lines):  # later lines overwrite earlier ones
        mask = in_row[:, line, :, None] & in_word[:, line, None, :]
        page = torch.where(mask, value[:, line, None, :], page)
    return page.clamp(0.0, 255.0)


def _glare(gen: torch.Generator, n: int, size: int, device) -> torch.Tensor:
    """(n, size, size) float32 additive glare of one to three blobs."""
    s = float(size)
    blobs = _integers(gen, (n, 1), 1, MAX_BLOBS + 1, device)
    on = (torch.arange(MAX_BLOBS, device=device)[None, :] < blobs).float()
    cy, cx = _uniform(gen, (2, n, MAX_BLOBS), 0.1 * s, 0.9 * s, device)
    sy, sx = _uniform(gen, (2, n, MAX_BLOBS), 0.08 * s, 0.25 * s, device)
    amp = _uniform(gen, (n, MAX_BLOBS), 120.0, 220.0, device) * on
    grid = torch.arange(size, device=device, dtype=torch.float32)
    gy = ((grid[None, None, :] - cy[..., None]) / sy[..., None]).square()  # (n, B, S)
    gx = ((grid[None, None, :] - cx[..., None]) / sx[..., None]).square()
    glare = torch.zeros((n, size, size), device=device)
    for b in range(MAX_BLOBS):
        glare += amp[:, b, None, None] * torch.exp(-(gy[:, b, :, None] + gx[:, b, None, :]))
    return glare.clamp(0.0, 255.0)


def glared_pages(gen: torch.Generator, n: int, size: int, device, *,
                 chunk: int = 128) -> tuple[torch.Tensor, torch.Tensor]:
    """(glared, ground truth): two (n, size, size) uint8 tensors on
    ``device``, drawn in chunks of ``chunk`` pages."""
    glared = torch.empty((n, size, size), dtype=torch.uint8, device=device)
    truth = torch.empty_like(glared)
    for lo in range(0, n, chunk):
        m = min(chunk, n - lo)
        page = _pages(gen, m, size, device)
        glare = _glare(gen, m, size, device)
        truth[lo:lo + m] = page.to(torch.uint8)
        glared[lo:lo + m] = (page + glare).clamp(0.0, 255.0).to(torch.uint8)
    return glared, truth
