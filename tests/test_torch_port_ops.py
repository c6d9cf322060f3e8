"""The PyTorch port's NHWC building blocks against the JAX package's ops on
the same numpy inputs, in float32 at 1e-5."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from image_enhancement_deglaring_tpu.ops import conv_blocks as jops
from image_enhancement_deglaring_tpu_torch.ops import conv_blocks as tops

TOL = dict(rtol=1e-5, atol=1e-5)


def _both(a: np.ndarray):
    return jnp.asarray(a), torch.from_numpy(a.copy())


def _close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("features,groups", [(8, 8), (12, 8), (7, 4), (3, 8), (1, 8)])
def test_resolve_group_count_matches(features, groups):
    assert tops.resolve_group_count(features, groups) == jops.resolve_group_count(features, groups)


def test_silu_matches(rng):
    j, t = _both(rng.standard_normal((2, 5, 5, 3)).astype(np.float32) * 4)
    _close(tops.silu(t), jops.silu(j))


@pytest.mark.parametrize("kernel,padding,bias", [(3, 1, False), (3, 0, True), (1, 0, True)])
def test_conv2d_matches(rng, kernel, padding, bias):
    xj, xt = _both(rng.standard_normal((2, 9, 7, 6)).astype(np.float32))
    wj, wt = _both(rng.standard_normal((kernel, kernel, 6, 5)).astype(np.float32) * 0.2)
    bj, bt = _both(rng.standard_normal(5).astype(np.float32)) if bias else (None, None)
    _close(tops.conv2d(xt, wt, bt, padding=padding), jops.conv2d(xj, wj, bj, padding=padding))


@pytest.mark.parametrize("shape,groups", [((2, 6, 6, 8), 8), ((1, 5, 7, 16), 4)])
def test_group_norm_matches(rng, shape, groups):
    xj, xt = _both(rng.standard_normal(shape).astype(np.float32) * 3 + 1)
    sj, st = _both(rng.standard_normal(shape[-1]).astype(np.float32))
    bj, bt = _both(rng.standard_normal(shape[-1]).astype(np.float32))
    _close(tops.group_norm(xt, st, bt, num_groups=groups),
           jops.group_norm(xj, sj, bj, num_groups=groups))


def _block_params(rng, cin, f):
    p = {
        "conv1": rng.standard_normal((3, 3, cin, f)).astype(np.float32) * 0.2,
        "gn1_scale": rng.standard_normal(f).astype(np.float32),
        "gn1_bias": rng.standard_normal(f).astype(np.float32),
        "conv2": rng.standard_normal((3, 3, f, f)).astype(np.float32) * 0.2,
        "gn2_scale": rng.standard_normal(f).astype(np.float32),
        "gn2_bias": rng.standard_normal(f).astype(np.float32),
    }
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.from_numpy(v.copy()) for k, v in p.items()})


@pytest.mark.parametrize("kernels", [False, True])
def test_conv_block_matches(rng, kernels):
    """The encoder block, with its sites' kernels on (on a CPU tensor the
    composition, as JAX's off the TPU) or off, against JAX's."""
    xj, xt = _both(rng.standard_normal((2, 8, 16, 4)).astype(np.float32))
    pj, pt = _block_params(rng, 4, 8)
    _close(tops.conv_block(xt, pt, num_groups=4, kernels=kernels),
           jops.conv_block(xj, pj, num_groups=4))


@pytest.mark.parametrize("kernels", [False, True])
def test_conv_block_dual_matches(rng, kernels):
    """The concat-free decoder block, with its sites' kernels on (on a CPU
    tensor: the composition) or off, against the JAX composition."""
    uj, ut = _both(rng.standard_normal((2, 8, 16, 8)).astype(np.float32))
    sj, st = _both(rng.standard_normal((2, 8, 16, 8)).astype(np.float32))
    pj, pt = _block_params(rng, 16, 8)
    _close(tops.conv_block_dual(ut, st, pt, num_groups=8, kernels=kernels),
           jops.conv_block_dual(uj, sj, pj, num_groups=8))


@pytest.mark.parametrize("shape", [(2, 8, 8, 3), (1, 7, 5, 2)])
def test_avg_pool_2x2_matches(rng, shape):
    xj, xt = _both(rng.standard_normal(shape).astype(np.float32))
    _close(tops.avg_pool_2x2(xt), jops.avg_pool_2x2(xj))


def test_avg_pool_2x2_bf16_keeps_dtype(rng):
    x = torch.from_numpy(rng.standard_normal((1, 4, 4, 2)).astype(np.float32)).bfloat16()
    y = tops.avg_pool_2x2(x)
    assert y.dtype == torch.bfloat16 and y.shape == (1, 2, 2, 2)


@pytest.mark.parametrize("bias", [False, True])
def test_upsample2x_matmul_matches(rng, bias):
    xj, xt = _both(rng.standard_normal((2, 3, 4, 6)).astype(np.float32))
    wj, wt = _both(rng.standard_normal((6, 5, 2, 2)).astype(np.float32))
    bj, bt = _both(rng.standard_normal(5).astype(np.float32)) if bias else (None, None)
    _close(tops.upsample2x_matmul(xt, wt, bt), jops.upsample2x_matmul(xj, wj, bj))


def test_highest_precision_restores_flags():
    before = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    with tops.highest_precision():
        assert not torch.backends.cudnn.allow_tf32
        assert not torch.backends.cuda.matmul.allow_tf32
    assert (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) == before


def test_highest_precision_overlapping_threads_share_one_span():
    """Two threads inside highest_precision(): the first to exit leaves
    TF32 off for the other, the last to exit restores the old flags."""
    import threading

    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    entered, release = threading.Event(), threading.Event()

    def other():
        with tops.highest_precision():
            entered.set()
            release.wait(timeout=30)

    try:
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
        t = threading.Thread(target=other)
        with tops.highest_precision():
            t.start()
            assert entered.wait(timeout=30)
        assert not torch.backends.cudnn.allow_tf32  # the other thread is still inside
        assert not torch.backends.cuda.matmul.allow_tf32
        release.set()
        t.join(timeout=30)
        assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
    finally:
        release.set()
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
