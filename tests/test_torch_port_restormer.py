"""The port's Restormer (``models/restormer.py``) against the plain
reference ``reference/restormer.py`` (float32, NCHW, upstream's module
written as functions) on seeded weights at a toy width, its NHWC ops, its
names through ``modelio``, and its entry points on the CPU.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from image_enhancement_deglaring_tpu_torch.eval.harness import load_model_for_eval
from image_enhancement_deglaring_tpu_torch.modelio import (
    detect_model_arch,
    export_jax_params,
    load_jax_params,
    restormer_params_from_state_dict,
)
from image_enhancement_deglaring_tpu_torch.models import Restormer
from image_enhancement_deglaring_tpu_torch.models.restormer import GRAY_CONFIG, config_from_params
from image_enhancement_deglaring_tpu_torch.ops import conv_blocks as cb
from image_enhancement_deglaring_tpu_torch.serve.engine import InferenceEngine
from image_enhancement_deglaring_tpu_torch.serve.tiling import TiledInference
from image_enhancement_deglaring_tpu_torch.utils.pytree import flatten_tree
from reference import restormer as ref

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOY = {"dim": 8, "num_blocks": [1, 1, 1, 1], "num_refinement_blocks": 1, "heads": [1, 2, 4, 8],
       "ffn_expansion_factor": 2.66, "bias": False, "layernorm_type": "BiasFree",
       "in_channels": 1, "out_channels": 1}
SHAPES = [(32, 32), (40, 24)]


def _seeded(cfg: dict, seed: int = 0) -> dict[str, torch.Tensor]:
    """Reference-named float32 weights: torch's default bounds for the
    convs, LayerNorm weights and temperatures drawn around 1 (and biases
    around 0) so that every parameter moves the output."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for name, (shape, kind) in ref.parameter_init(cfg).items():
        u = torch.rand(shape, generator=g)
        if kind[0] == "uniform":
            out[name] = (2 * u - 1) / math.sqrt(kind[1])
        elif kind[0] == "ones":
            out[name] = 0.7 + 0.6 * u
        else:
            out[name] = 0.2 * u - 0.1
    return out


def _port(cfg: dict, params: dict, dtype=torch.float32) -> Restormer:
    model = Restormer(**cfg, dtype=dtype)
    mine = dict(model.named_parameters())
    assert set(mine) == set(params)
    with torch.no_grad():
        for k, v in params.items():
            mine[k].copy_(v.permute(2, 3, 1, 0) if v.dim() == 4 else v)
    return model


def _upstream_state_dict(model: Restormer) -> dict[str, torch.Tensor]:
    return {k: (v.detach().permute(3, 2, 0, 1) if v.dim() == 4 else v.detach()).contiguous()
            for k, v in model.named_parameters()}


@pytest.mark.parametrize("hw", SHAPES)
@pytest.mark.parametrize("layernorm_type,bias", [("BiasFree", False), ("WithBias", True)])
def test_forward_float32_matches_the_reference(hw, layernorm_type, bias):
    cfg = dict(TOY, layernorm_type=layernorm_type, bias=bias)
    p = _seeded(cfg)
    x = torch.rand(2, *hw, 1, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        got = _port(cfg, p)(x).permute(0, 3, 1, 2)
        want = ref.forward(p, x.permute(0, 3, 1, 2), cfg)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert ((got - want).abs().max() / want.abs().max()).item() < 1e-5
    # the body is not the identity: the global residual alone would pass
    assert (want - x.permute(0, 3, 1, 2)).std().item() > 0.05


@pytest.mark.parametrize("hw", SHAPES)
def test_l1_loss_and_every_gradient_match_the_reference(hw):
    p = _seeded(TOY, 2)
    gen = torch.Generator().manual_seed(3)
    x, y = torch.rand(2, *hw, 1, generator=gen), torch.rand(2, *hw, 1, generator=gen)
    model = _port(TOY, p)
    loss = (model(x) - y).abs().mean()
    loss.backward()
    want_loss, want = ref.l1_loss_and_grads(p, x.permute(0, 3, 1, 2), y.permute(0, 3, 1, 2), TOY)
    assert abs(loss.item() - want_loss.item()) < 1e-4
    for name, t in model.named_parameters():
        g = want[name].permute(2, 3, 1, 0) if want[name].dim() == 4 else want[name]
        assert (t.grad - g).abs().max().item() < 1e-4, name


def test_bf16_forward_stays_near_the_float32_reference():
    """bf16 keeps 8 significant bits, so each rounded conv, product or
    activation is off by up to 2^-9 of its size. Float32 LayerNorm, norms
    and softmax keep the errors from compounding through the toy's eleven
    blocks: on seeds 4-9 the output (values about 1) is off by at most
    0.0032-0.0040 (about 2^-8), 0.0007-0.0010 on average. The bounds are
    five and three times those; a wrong equation is off by tenths."""
    p = _seeded(TOY, 4)
    x = torch.rand(2, 32, 32, 1, generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        got = _port(TOY, p, torch.bfloat16)(x).permute(0, 3, 1, 2)
        want = ref.forward(p, x.permute(0, 3, 1, 2), TOY)
    err = (got - want).abs()
    assert err.max().item() < 0.02 and err.mean().item() < 0.003, (err.max(), err.mean())
    assert (got - want).abs().max().item() > 0  # it did run in bf16


def test_biasfree_layer_norm_does_not_centre():
    g = torch.Generator().manual_seed(6)
    x = torch.randn(2, 5, 7, 16, generator=g) + 3.0  # a mean far from 0
    w = torch.rand(16, generator=g) + 0.5
    biasfree = cb.channel_layer_norm(x, w)
    centred = cb.channel_layer_norm(x, w, torch.zeros(16))
    var = x.var(-1, keepdim=True, unbiased=False)
    assert torch.allclose(biasfree, x / torch.sqrt(var + 1e-5) * w, rtol=1e-5, atol=1e-5)
    assert torch.allclose(centred, F.layer_norm(x, (16,), w, None, eps=1e-5), atol=1e-5)
    assert (biasfree - centred).abs().min().item() > 1.0
    p = {"n.body.weight": w}
    nchw = ref.layer_norm(x.permute(0, 3, 1, 2), p, "n", "BiasFree").permute(0, 2, 3, 1)
    assert torch.allclose(biasfree, nchw, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("c,r", [(3, 2), (8, 2), (5, 4)])
def test_pixel_shuffles_equal_torch_through_nhwc(c, r):
    x = torch.randn(2, 8, 16, c, generator=torch.Generator().manual_seed(c))
    down = cb.pixel_unshuffle(x, r)
    want = torch.nn.PixelUnshuffle(r)(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert torch.equal(down, want)
    up = cb.pixel_shuffle(down, r)
    assert torch.equal(up, torch.nn.PixelShuffle(r)(want.permute(0, 3, 1, 2)).permute(0, 2, 3, 1))
    assert torch.equal(up, x)


@pytest.mark.parametrize("heads", [1, 2, 4, 8])
def test_transposed_attention_equals_a_loop_over_heads(heads):
    g = torch.Generator().manual_seed(heads)
    n, h, w, c = 2, 6, 10, 16
    qkv = torch.randn(n, h, w, 3 * c, generator=g)
    q, k, v = qkv.chunk(3, dim=-1)
    temp = torch.rand(heads, 1, 1, generator=g) + 0.5
    got = cb.transposed_attention(q, k, v, temp, heads)
    ch = c // heads
    want = torch.empty(n, h * w, c, dtype=torch.float64)
    for b in range(n):
        for i in range(heads):
            cols = slice(i * ch, (i + 1) * ch)
            qi, ki, vi = (t[b].reshape(h * w, c)[:, cols].double().T for t in (q, k, v))
            qi, ki = F.normalize(qi, dim=-1, eps=1e-12), F.normalize(ki, dim=-1, eps=1e-12)
            attn = torch.softmax(qi @ ki.T * temp[i].double(), dim=-1)
            want[b, :, cols] = (attn @ vi).T
    assert torch.allclose(got.reshape(n, h * w, c).double(), want, atol=1e-5)


def test_parameter_count_at_the_published_widths():
    init = ref.parameter_init(GRAY_CONFIG)
    model = Restormer()
    assert sum(p.numel() for p in model.parameters()) == sum(
        math.prod(shape) for shape, _ in init.values()) == 26_109_076
    assert {n: tuple(p.shape) for n, p in model.named_parameters()} == {
        k: (tuple(s[2:]) + (s[1], s[0]) if len(s) == 4 else tuple(s)) for k, (s, _) in init.items()}
    assert config_from_params(export_jax_params(model)) == GRAY_CONFIG


def test_upstream_state_dict_round_trips_through_modelio(tmp_path):
    cfg = dict(TOY, bias=True, layernorm_type="WithBias")
    model = _port(cfg, _seeded(cfg, 7))
    sd = _upstream_state_dict(model)
    path = str(tmp_path / "restormer.pth")
    torch.save(sd, path)
    assert detect_model_arch(path) == "restormer"
    tree = restormer_params_from_state_dict({k: v.numpy() for k, v in sd.items()})
    assert config_from_params(tree) == cfg
    fresh = Restormer(**cfg)
    load_jax_params(fresh, tree)
    assert all(torch.equal(a, b) for a, b in zip(fresh.parameters(), model.parameters()))
    loaded, params = load_model_for_eval(path, device="cpu")
    assert isinstance(loaded, Restormer) and loaded.config == cfg
    assert _upstream_state_dict(loaded).keys() == sd.keys()
    assert all(torch.equal(_upstream_state_dict(loaded)[k], v) for k, v in sd.items())
    flat = str(tmp_path / "w.npz")
    np.savez(flat, **flatten_tree(export_jax_params(model)))
    assert detect_model_arch(flat) == "restormer"
    x = torch.rand(1, 16, 16, 1)
    with torch.no_grad():
        assert torch.equal(load_model_for_eval(flat, device="cpu")[0](x), model(x))
    with pytest.raises(ValueError, match="ONNX"):
        load_model_for_eval(str(tmp_path / "r.onnx"), model_arch="restormer", device="cpu")


def _conv2d_before(x, w, b=None, *, stride=1, padding=0, dilation=1):
    """``ops.conv_blocks.conv2d`` as it was before it took ``groups``."""
    if w.shape[0] == 1 and w.shape[1] == 1 and stride == 1 and padding == 0:
        y = torch.matmul(x, w[0, 0].to(x.dtype))
    else:
        y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1).to(x.dtype),
                     stride=stride, padding=padding, dilation=dilation)
        y = y.permute(0, 2, 3, 1)
    if b is not None:
        y = y + b.to(y.dtype)
    return y


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,kw", [(1, {}), (3, {"padding": 1}), (3, {"padding": 2, "dilation": 2}),
                                  (3, {"stride": 2, "padding": 1}), (1, {"padding": 1})])
def test_conv2d_with_one_group_is_bit_for_bit_what_it_was(dtype, k, kw):
    g = torch.Generator().manual_seed(k)
    x = torch.randn(2, 12, 10, 6, generator=g).to(dtype)
    w, b = torch.randn(k, k, 6, 5, generator=g), torch.randn(5, generator=g)
    assert torch.equal(cb.conv2d(x, w, b, **kw), _conv2d_before(x, w, b, **kw))
    assert torch.equal(cb.conv2d(x, w, **kw, groups=1), _conv2d_before(x, w, **kw))


def test_depthwise_conv2d_equals_torch():
    g = torch.Generator().manual_seed(8)
    x = torch.randn(2, 9, 7, 6, generator=g)
    w = torch.randn(6, 1, 3, 3, generator=g)
    got = cb.conv2d(x, w.permute(2, 3, 1, 0), padding=1, groups=6)
    want = F.conv2d(x.permute(0, 3, 1, 2), w, padding=1, groups=6).permute(0, 2, 3, 1)
    assert torch.allclose(got, want, atol=1e-6)


def test_sides_not_divisible_by_8_are_refused():
    with pytest.raises(ValueError, match="divisible by 8"):
        Restormer(**TOY)(torch.rand(1, 20, 16, 1))


# ------------------------------------------------------------ entry points
def _synthetic(root: str) -> str:
    from image_enhancement_deglaring_tpu_torch.data import generate_synthetic_sd1

    generate_synthetic_sd1(root, n_train=10, n_val=2, size=32)
    return root


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """``cli.train --model restormer`` for two steps (one per epoch) on the
    CPU, in a subprocess as a user runs it."""
    base = tmp_path_factory.mktemp("restormer_train")
    data = _synthetic(str(base / "d"))
    out = str(base / "run")
    cmd = [sys.executable, "-m", "image_enhancement_deglaring_tpu_torch.cli.train",
           "--data_dir", data, "--output_dir", out, "--image_size", "32", "--batch_size", "8",
           "--epochs", "2", "--device", "cpu", "--model", "restormer", "--num_workers", "1",
           "--restormer_dim", "8", "--restormer_num_blocks", "1", "1", "1", "1",
           "--restormer_num_refinement_blocks", "1", "--val_split", "0.2"]
    run = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    return out


def test_cli_train_restormer_steps_and_the_loss_falls(trained):
    with open(os.path.join(trained, "logs", "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    losses = [r["train_loss"] for r in rows if "train_loss" in r]
    assert len(losses) == 2 and losses[1] < losses[0], rows
    meta = json.load(open(os.path.join(trained, "final_model", "train_meta.json")))
    assert meta["model_arch"] == "restormer"
    assert detect_model_arch(os.path.join(trained, "model_weights.npz")) == "restormer"


def test_a_trained_checkpoint_serves_through_the_engine_and_the_tiler(trained):
    model, _ = load_model_for_eval(os.path.join(trained, "final_model"), device="cpu")
    assert isinstance(model, Restormer) and model.config["dim"] == 8
    imgs = (np.random.default_rng(0).random((3, 32, 32)) * 255).astype(np.uint8)
    with torch.no_grad():
        want = model(torch.from_numpy(imgs)[..., None].float() / 255.0)
    want = torch.floor(want.clamp(0, 1) * 255).to(torch.uint8)[..., 0].numpy()
    eng = InferenceEngine(model, image_size=32, max_batch_size=4, compute_dtype=torch.float32,
                          device="cpu")
    try:
        assert np.array_equal(eng.infer_batch(imgs), want)
        futures = [eng.submit(img) for img in imgs]
        assert all(np.array_equal(f.result(timeout=60), w) for f, w in zip(futures, want))
    finally:
        eng.stop()
    tiler = TiledInference(model, tile=32, overlap=8, compute_dtype=torch.float32, device="cpu")
    odd = (np.random.default_rng(1).random((45, 37)) * 255).astype(np.uint8)
    assert tiler(odd).shape == (45, 37)


def test_cli_export_onnx_names_the_missing_ops(trained):
    from image_enhancement_deglaring_tpu_torch.cli import export_onnx

    for argv in (["--model", "restormer"], []):
        with pytest.raises(ValueError, match="Conv with group > 1.*Erf"):
            export_onnx.main(["--model_path", os.path.join(trained, "final_model"),
                              "--output", os.path.join(trained, "r.onnx"), *argv])
