"""Restormer's channel LayerNorm kernel K6 (``fused_kernels.channel_layer_norm``).

On the CPU: its plain version against the model's float32 composition
(``conv_blocks.channel_layer_norm``) for both LayerNorm types, the channel
counts of Restormer's sites, float32 and bf16, on inputs whose mean lies far
from 0; the centred variance against float64 where E[x^2] - mean^2 would
lose digits; how ``layer_norm_site`` routes a call (a CPU tensor and a grad
call take the composition, an unsupported shape takes it and is counted);
the wrapper's refusals; its ctypes signature against the C prototype; the
88 sites of the published configuration.

Tests marked ``card`` hold the kernel against the plain version at the
bucket-16 shapes of the sites and skip without a card. The file imports no
JAX, so they run on the card with
``python3 -m pytest tests/test_torch_port_layer_norm.py -m card --noconftest``.
"""

import re

import pytest
import torch

from image_enhancement_deglaring_tpu_torch.models import Restormer
from image_enhancement_deglaring_tpu_torch.models import restormer as rm
from image_enhancement_deglaring_tpu_torch.ops import _build
from image_enhancement_deglaring_tpu_torch.ops import conv_blocks as cb
from image_enhancement_deglaring_tpu_torch.ops import fused_kernels as fk

CHANNELS = [8, 48, 96, 192, 384]
TYPES = ["BiasFree", "WithBias"]
DTYPES = [torch.float32, torch.bfloat16]
# the kernel and the composition round the same float32 function once from
# statistics summed in another order: bf16 outputs at most 1 ulp apart at
# their size, sizes under 2^-6 (WithBias outputs near 0, where the centred
# terms cancel) measured at its ulp; float32 ones by the statistics' rounding
BF16_ULPS, ULP_FLOOR = 1.0, 2.0 ** -6
F32_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the tests are small, and the suite runs in workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here")
    return torch.device("cuda")


def _inputs(shape, kind, dtype=torch.float32, seed=0, device="cpu", mean=40.0, std=2.0):
    """x with a mean far from 0 (a BiasFree input's), w around 1, b or None."""
    g = torch.Generator().manual_seed(seed)
    c = shape[-1]
    x = (torch.randn(shape, generator=g) * std + mean).to(dtype)
    w = torch.rand(c, generator=g) + 0.5
    b = torch.randn(c, generator=g) * 0.5 if kind == "WithBias" else None
    return [None if t is None else t.to(device) for t in (x, w, b)]


def bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> float:
    """The largest |a - b| in bf16 ulps of the larger of |a|, |b| and
    ``ULP_FLOOR`` (8 significant bits: an ulp is 2^(floor(log2 v) - 7))."""
    a, b = a.float(), b.float()
    ulp = torch.exp2(torch.floor(torch.log2(torch.maximum(a.abs(), b.abs()).clamp_min(
        ULP_FLOOR))) - 7)
    return float(((a - b).abs() / ulp).max())


def _close(got, want):
    if got.dtype == torch.bfloat16:
        assert bf16_ulps(got, want) <= BF16_ULPS
    else:
        torch.testing.assert_close(got, want, **F32_TOL)


# ------------------------------------------------------------ plain version


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("c", CHANNELS)
@pytest.mark.parametrize("kind", TYPES)
def test_plain_matches_the_composition(kind, c, dtype):
    x, w, b = _inputs((2, 5, 7, c), kind, dtype, seed=c)
    got = fk.channel_layer_norm_plain(x, w, b)
    want = cb.channel_layer_norm(x, w, b)
    assert got.dtype == dtype and got.shape == x.shape
    _close(got, want)
    if kind == "BiasFree":  # x not centred: every output keeps x's sign and size
        assert (got.float() > 5).all()


def test_the_centred_variance_keeps_its_digits_where_the_shortcut_does_not():
    """Mean 1000, deviation 1: the plain version's variance about the mean is
    float64's to 1e-5, where float32's E[x^2] - mean^2 is off by far more."""
    x, w, _ = _inputs((4, 8, 8, 96), "BiasFree", mean=1000.0, std=1.0, seed=3)
    truth = cb.channel_layer_norm(x.double(), w.double()).float()
    torch.testing.assert_close(fk.channel_layer_norm_plain(x, w), truth, rtol=1e-5, atol=1e-3)
    mean = x.mean(-1, keepdim=True)
    shortcut = x * torch.rsqrt((x * x).mean(-1, keepdim=True) - mean * mean + 1e-5) * w
    assert (shortcut - truth).abs().max() > 100 * (fk.channel_layer_norm_plain(x, w)
                                                   - truth).abs().max()


def test_the_wrapper_on_a_cpu_tensor_is_the_plain_version():
    x, w, b = _inputs((2, 4, 4, 48), "WithBias", torch.bfloat16, seed=1)
    fk.reset_launch_counts()
    assert torch.equal(fk.channel_layer_norm(x, w, b), fk.channel_layer_norm_plain(x, w, b))
    assert fk.LAUNCHES["channel_layer_norm"] == 0


# --------------------------------------------------------------- routing


@pytest.fixture
def calls(monkeypatch):
    """Records each call that reached the kernel's wrapper."""
    seen = []
    kernel = fk.channel_layer_norm
    monkeypatch.setattr(fk, "channel_layer_norm",
                        lambda *a, **k: seen.append("K6") or kernel(*a, **k))
    fk.reset_launch_counts()
    return seen


@pytest.mark.parametrize("kind", TYPES)
def test_cpu_tensors_take_the_composition_bit_for_bit(calls, kind):
    x, w, b = _inputs((2, 4, 4, 48), kind, torch.bfloat16, seed=2)
    with torch.no_grad():
        assert torch.equal(fk.layer_norm_site(x, w, b), cb.channel_layer_norm(x, w, b))
    assert calls == [] and fk.LAYER_NORM_FALLBACKS == {"transform": 0, "shape": 0}


@pytest.mark.parametrize("kind", TYPES)
def test_a_device_call_outside_grad_takes_the_kernel(monkeypatch, calls, kind):
    """``_routes_to_kernels`` patched, a CPU tensor stands for a device one
    (the wrapper then computes the plain version): under no_grad, under
    inference_mode, and in grad mode with nothing that requires grad."""
    monkeypatch.setattr(fk, "_routes_to_kernels", lambda x: True)
    x, w, b = _inputs((2, 4, 4, 96), kind, seed=4)
    with torch.no_grad():
        got = fk.layer_norm_site(x, w.requires_grad_(), b)
    with torch.inference_mode():
        fk.layer_norm_site(x, w, b)
    fk.layer_norm_site(x, w.detach(), b)
    assert calls == ["K6"] * 3 and fk.LAYER_NORM_FALLBACKS == {"transform": 0, "shape": 0}
    assert torch.equal(got, fk.channel_layer_norm_plain(x, w, b))


@pytest.mark.parametrize("grad", ["x", "weight", "bias"])
def test_a_grad_call_takes_the_composition_uncounted(monkeypatch, calls, grad):
    """Restormer's training: K6 has no backward, so any argument that
    requires grad keeps the composition, and the gradient reaches it."""
    monkeypatch.setattr(fk, "_routes_to_kernels", lambda x: True)
    x, w, b = _inputs((2, 4, 4, 48), "WithBias", seed=5)
    leaf = {"x": x, "weight": w, "bias": b}[grad].requires_grad_()
    y = fk.layer_norm_site(x, w, b)
    y.square().sum().backward()
    assert leaf.grad is not None and leaf.grad.abs().sum() > 0
    assert calls == [] and fk.LAYER_NORM_FALLBACKS == {"transform": 0, "shape": 0}
    torch.testing.assert_close(y.detach(), cb.channel_layer_norm(x, w, b).detach())


@pytest.mark.parametrize("shape,dtype", [((1, 2, 2, 12), torch.float32),
                                         ((1, 2, 2, 2048), torch.bfloat16),
                                         ((1, 2, 2, 48), torch.float64)],
                         ids=["c12", "c2048", "f64"])
def test_unsupported_shapes_take_the_composition_and_count(monkeypatch, calls, shape, dtype):
    monkeypatch.setattr(fk, "_routes_to_kernels", lambda x: True)
    x, w, _ = _inputs(shape, "BiasFree", dtype, seed=6)
    with torch.no_grad():
        got = fk.layer_norm_site(x, w)
    assert torch.equal(got, cb.channel_layer_norm(x, w))
    assert calls == [] and fk.LAYER_NORM_FALLBACKS == {"transform": 0, "shape": 1}


def test_an_unaligned_input_takes_the_composition_and_counts(monkeypatch, calls):
    monkeypatch.setattr(fk, "_routes_to_kernels", lambda x: True)
    x, w, _ = _inputs((1, 2, 2, 48), "BiasFree", torch.bfloat16, seed=7)
    flat = torch.empty(x.numel() + 1, dtype=x.dtype)
    shifted = flat[1:].view(x.shape)  # contiguous, 2 bytes past a 16-byte boundary
    shifted.copy_(x)
    with torch.no_grad():
        got = fk.layer_norm_site(shifted, w)
    assert torch.equal(got, cb.channel_layer_norm(x, w))
    assert calls == [] and fk.LAYER_NORM_FALLBACKS == {"transform": 0, "shape": 1}


def test_a_non_contiguous_input_is_made_contiguous_for_the_kernel(monkeypatch, calls):
    monkeypatch.setattr(fk, "_routes_to_kernels", lambda x: True)
    x, w, b = _inputs((2, 4, 6, 48), "WithBias", seed=8)
    view = x.transpose(1, 2)
    with torch.no_grad():
        got = fk.layer_norm_site(view, w, b)
    assert calls == ["K6"]
    assert torch.equal(got, fk.channel_layer_norm_plain(view.contiguous(), w, b))


def test_vmap_takes_the_composition_and_counts(monkeypatch, calls):
    monkeypatch.setattr(fk, "_routes_to_kernels", lambda x: True)
    x, w, b = _inputs((3, 2, 4, 4, 48), "WithBias", seed=9)
    with torch.no_grad():
        got = torch.func.vmap(lambda t: fk.layer_norm_site(t, w, b))(x)
    torch.testing.assert_close(got, cb.channel_layer_norm(x, w, b))
    assert calls == [] and fk.LAYER_NORM_FALLBACKS == {"transform": 1, "shape": 0}


# --------------------------------------------------------------- wrapper


def test_the_wrapper_refuses_autograd():
    x = torch.empty(1, 2, 2, 48, device="meta")
    w = torch.ones(48, requires_grad=True)
    with pytest.raises(RuntimeError, match="forward-only"):
        fk.channel_layer_norm(x, w)


@pytest.mark.parametrize("c", [12, 2048])
def test_the_wrapper_refuses_channels_it_does_not_take(c):
    with pytest.raises(ValueError, match="multiples of 8 up to 1024"):
        fk.channel_layer_norm(torch.empty(1, 2, 2, c, device="meta"), torch.ones(c))


def test_the_wrapper_refuses_devices_other_than_cpu_and_cuda():
    with pytest.raises(ValueError, match="meta"):
        fk.channel_layer_norm(torch.empty(1, 2, 2, 48, device="meta"), torch.ones(48))


def test_the_build_signature_matches_the_c_prototype():
    """``_build``'s ctypes argument types against ``csrc/layer_norm.cu``'s
    extern "C" prototype, parsed as ``test_torch_port_conv_plan`` parses
    every library's."""
    types = {"const void*": _build.ctypes.c_void_p, "void*": _build.ctypes.c_void_p,
             "int": _build.ctypes.c_int, "float": _build.ctypes.c_float,
             "long long": _build.ctypes.c_longlong}
    text = (_build.CSRC / "layer_norm.cu").read_text()
    text = text[text.index('extern "C" {'):]
    found = {name: [types[" ".join(p.split()).rsplit(" ", 1)[0].replace(" *", "*")]
                    for p in params.split(",")]
             for name, params in re.findall(r"^int (\w+)\(([^)]*)\)", text, flags=re.M)}
    assert "layer_norm" in _build.SOURCES
    assert found == _build.SIGNATURES["layer_norm"] == {
        "channel_layer_norm": [_build.ctypes.c_void_p] * 4 + [
            _build.ctypes.c_longlong, _build.ctypes.c_int, _build.ctypes.c_float,
            _build.ctypes.c_int, _build.ctypes.c_int, _build.ctypes.c_void_p]}


# ----------------------------------------------------------------- model


TOY = {"dim": 8, "num_blocks": [1, 1, 1, 1], "num_refinement_blocks": 1, "heads": [1, 2, 4, 8],
       "ffn_expansion_factor": 2.66, "bias": False, "in_channels": 1, "out_channels": 1}


def test_the_published_configuration_has_88_layer_norm_sites():
    model = Restormer(**rm.GRAY_CONFIG, device="meta")
    assert sum(isinstance(m, rm.LayerNorm) for m in model.modules()) == 88


@pytest.mark.parametrize("kind", TYPES)
def test_a_restormer_forward_takes_the_kernel_at_every_site(monkeypatch, calls, kind):
    """Two sites a block; under no_grad each reaches the kernel (here its
    plain version), and the forward stays at the composition's; a training
    forward reaches it nowhere."""
    model = Restormer(**TOY, layernorm_type=kind, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, rm.LayerNorm):
                m.body.weight.uniform_(0.5, 1.5)
    x = torch.rand(2, 16, 16, 1, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = model(x)
    monkeypatch.setattr(fk, "_routes_to_kernels", lambda x: True)
    with torch.no_grad():
        got = model(x)
    assert calls == ["K6"] * 16
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    model(x).mean().backward()
    assert calls == ["K6"] * 16 and fk.LAYER_NORM_FALLBACKS == {"transform": 0, "shape": 0}


# ------------------------------------------------------------------ card


@pytest.mark.card
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(16, 512, 512, 48), (16, 512, 512, 96), (16, 256, 256, 96),
                                   (16, 128, 128, 192), (16, 64, 64, 384)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("kind", TYPES)
def test_the_kernel_matches_plain_and_the_composition_at_the_sites(card, kind, shape, dtype):
    x, w, b = _inputs(shape, kind, dtype, seed=shape[-1], device=card, mean=3.0)
    with torch.inference_mode():
        got, again = fk.channel_layer_norm(x, w, b), fk.channel_layer_norm(x, w, b)
        assert torch.equal(got, again)
        _close(got, fk.channel_layer_norm_plain(x, w, b))
        _close(got, cb.channel_layer_norm(x, w, b))
