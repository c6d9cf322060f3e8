"""Minimal ONNX writer (numpy, protobuf wire format).

The port's copy of ``image_enhancement_deglaring_tpu.modelio.onnx_writer``
(numpy only, so that the port imports nothing of the JAX package), writing
the same bytes for the same parameters. It exports the three model
families' JAX-named parameter trees (``export_jax_params`` /
``export_jax_batch_stats``) to opset-11 ONNX with dynamic
batch/height/width axes, input 'input' [batch_size, 1, height, width] and
output 'output' (reference: scripts/export_to_onnx.py:134-161), with the
GroupNorm lowering torch uses at opset 11 (Reshape -> InstanceNormalization
-> Reshape(Shape) -> Mul(scale) -> Add(bias)), so the artifact is
interchangeable with the reference's best_model.onnx for any ONNX runtime.
``export_model`` takes one of the port's modules instead of a tree.

Layout: the NHWC/HWIO parameters are written back in ONNX's NCHW/OIHW.
"""

from __future__ import annotations

import struct

import numpy as np

from ..ops.conv_blocks import resolve_group_count

# -------------------------------------------------------- protobuf encoding


def _varint(v: int) -> bytes:
    if v < 0:
        # protobuf stores negative int64 (e.g. axis=-1 attributes) as
        # two's-complement 10-byte varints; Python's arithmetic shift would
        # otherwise loop forever on a negative value
        v &= (1 << 64) - 1
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _len_field(field: int, payload: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(payload)) + payload


def _int_field(field: int, v: int) -> bytes:
    return _tag(field, 0) + _varint(v)


def _str_field(field: int, s: str) -> bytes:
    return _len_field(field, s.encode("utf-8"))


# ------------------------------------------------------------ ONNX messages

_ATTR_FLOAT, _ATTR_INT, _ATTR_STRING, _ATTR_TENSOR, _ATTR_INTS = 1, 2, 3, 4, 7


def _attribute(name: str, value) -> bytes:
    msg = _str_field(1, name)
    if isinstance(value, bool) or isinstance(value, (int, np.integer)):
        msg += _tag(3, 0) + _varint(int(value)) + _int_field(20, _ATTR_INT)
    elif isinstance(value, float):
        msg += _tag(2, 5) + struct.pack("<f", value) + _int_field(20, _ATTR_FLOAT)
    elif isinstance(value, (list, tuple)):
        # AttributeProto.ints is field 8 (field 7 is floats — onnx.proto3)
        for v in value:
            msg += _tag(8, 0) + _varint(int(v))
        msg += _int_field(20, _ATTR_INTS)
    elif isinstance(value, np.ndarray):
        msg += _len_field(5, _tensor(None, value)) + _int_field(20, _ATTR_TENSOR)
    elif isinstance(value, (str, bytes)):
        raw = value.encode() if isinstance(value, str) else value
        msg += _len_field(4, raw) + _int_field(20, _ATTR_STRING)
    else:
        raise TypeError(f"unsupported attribute {name}={value!r}")
    return msg


_DTYPE_CODES = {np.dtype(np.float32): 1, np.dtype(np.int64): 7, np.dtype(np.int32): 6}


def _tensor(name: str | None, arr: np.ndarray) -> bytes:
    arr = np.ascontiguousarray(arr)
    msg = b""
    for d in arr.shape:
        msg += _tag(1, 0) + _varint(d)
    msg += _int_field(2, _DTYPE_CODES[arr.dtype])
    if name:
        msg += _str_field(8, name)
    msg += _len_field(9, arr.tobytes())
    return msg


def _node(op_type: str, inputs: list[str], outputs: list[str],
          name: str = "", **attrs) -> bytes:
    msg = b""
    for i in inputs:
        msg += _str_field(1, i)
    for o in outputs:
        msg += _str_field(2, o)
    if name:
        msg += _str_field(3, name)
    msg += _str_field(4, op_type)
    for k, v in attrs.items():
        msg += _len_field(5, _attribute(k, v))
    return msg


def _value_info(name: str, dims: list) -> bytes:
    shape_msg = b""
    for d in dims:
        if isinstance(d, str):
            dim = _str_field(2, d)  # dim_param
        else:
            dim = _tag(1, 0) + _varint(d)  # dim_value
        shape_msg += _len_field(1, dim)
    tensor_type = _int_field(1, 1) + _len_field(2, shape_msg)  # elem FLOAT
    type_msg = _len_field(1, tensor_type)
    return _str_field(1, name) + _len_field(2, type_msg)


class OnnxGraphBuilder:
    def __init__(self, name: str = "deglare_unet"):
        self.name = name
        self.nodes: list[bytes] = []
        self.initializers: list[bytes] = []
        self.inputs: list[bytes] = []
        self.outputs: list[bytes] = []
        self._uid = 0

    def uid(self, base: str) -> str:
        self._uid += 1
        return f"{base}_{self._uid}"

    def init_tensor(self, name: str, arr: np.ndarray) -> str:
        self.initializers.append(_tensor(name, np.asarray(arr)))
        return name

    def add(self, op_type: str, inputs: list[str], n_out: int = 1, **attrs) -> list[str]:
        outs = [self.uid(f"{op_type}_out") for _ in range(n_out)]
        self.nodes.append(_node(op_type, inputs, outs, name=self.uid(op_type), **attrs))
        return outs

    def add_named(self, op_type: str, inputs: list[str], outputs: list[str], **attrs):
        self.nodes.append(_node(op_type, inputs, outputs, name=self.uid(op_type), **attrs))
        return outputs

    def graph_bytes(self) -> bytes:
        msg = b""
        for n in self.nodes:
            msg += _len_field(1, n)
        msg += _str_field(2, self.name)
        for t in self.initializers:
            msg += _len_field(5, t)
        for i in self.inputs:
            msg += _len_field(11, i)
        for o in self.outputs:
            msg += _len_field(12, o)
        return msg

    def model_bytes(self, opset: int = 11) -> bytes:
        opset_msg = _str_field(1, "") + _int_field(2, opset)
        return (
            _int_field(1, 7)  # ir_version
            + _str_field(2, "image-enhancement-deglaring-tpu")
            + _str_field(3, "0.1.0")
            + _len_field(7, self.graph_bytes())
            + _len_field(8, opset_msg)
        )


# --------------------------------------------------------------- UNet export


def _conv_oihw(w_hwio: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(np.asarray(w_hwio), (3, 2, 0, 1))).astype(np.float32)


def _emit_gn(g: OnnxGraphBuilder, x: str, groups: int,
             scale: np.ndarray, bias: np.ndarray,
             scale_name: str, bias_name: str) -> str:
    """GroupNorm via the torch opset-11 lowering: Reshape [0, G, -1] ->
    InstanceNorm -> Reshape(Shape(x)) -> Mul(scale) -> Add(bias)."""
    c = int(np.asarray(scale).shape[0])
    shape_i = g.init_tensor(g.uid("gnshape"), np.asarray([0, groups, -1], np.int64))
    (r,) = g.add("Reshape", [x, shape_i])
    ones = g.init_tensor(g.uid("gn_ones"), np.ones(groups, np.float32))
    zeros = g.init_tensor(g.uid("gn_zeros"), np.zeros(groups, np.float32))
    (inorm,) = g.add("InstanceNormalization", [r, ones, zeros], epsilon=1e-5)
    (shp,) = g.add("Shape", [x])
    (x,) = g.add("Reshape", [inorm, shp])
    # named like the torch state dict, so that the importers (and
    # cli.extract_weights) read them straight back
    s = g.init_tensor(scale_name, np.asarray(scale, np.float32).reshape(c, 1, 1))
    b = g.init_tensor(bias_name, np.asarray(bias, np.float32).reshape(c, 1, 1))
    (x,) = g.add("Mul", [x, s])
    (x,) = g.add("Add", [x, b])
    return x


def _emit_silu(g: OnnxGraphBuilder, x: str) -> str:
    (sig,) = g.add("Sigmoid", [x])
    (x,) = g.add("Mul", [x, sig])
    return x


def _emit_conv(g: OnnxGraphBuilder, x: str, w_name: str, w_hwio,
               bias_name: str | None = None, bias=None, *,
               kernel: int = 3, pad: int = 1, dilation: int = 1) -> str:
    w = g.init_tensor(w_name, _conv_oihw(w_hwio))
    inputs = [x, w]
    if bias is not None:
        inputs.append(g.init_tensor(bias_name, np.asarray(bias, np.float32)))
    (x,) = g.add("Conv", inputs, dilations=[dilation, dilation], group=1,
                 kernel_shape=[kernel, kernel],
                 pads=[pad, pad, pad, pad], strides=[1, 1])
    return x


def _emit_block(g: OnnxGraphBuilder, x: str, blk: str, p: dict, groups: int = 8) -> str:
    """[Conv3x3 -> GN(opset-11 lowering) -> SiLU] x 2."""
    for conv_key, gn_s, gn_b, idx in (
        ("conv1", "gn1_scale", "gn1_bias", 0),
        ("conv2", "gn2_scale", "gn2_bias", 3),
    ):
        x = _emit_conv(g, x, f"{blk}.{idx}.weight", p[conv_key])
        x = _emit_gn(g, x, groups, p[gn_s], p[gn_b],
                     f"{blk}.{idx + 1}.weight", f"{blk}.{idx + 1}.bias")
        x = _emit_silu(g, x)
    return x


def export_lightweight_unet(params: dict, path: str, *, groups: int = 8) -> str:
    """Write LightweightUNet params as an opset-11 .onnx file."""
    g = OnnxGraphBuilder()
    g.inputs.append(_value_info("input", ["batch_size", 1, "height", "width"]))
    g.outputs.append(_value_info("output", ["batch_size", 1, "height", "width"]))

    def block_groups(blk: str) -> int:
        # the model resolves the group count PER BLOCK (largest divisor of
        # that block's width <= num_groups, models/unet.py ConvBlock);
        # a uniform count would silently mis-normalize narrow models: the
        # Reshape [0, groups, -1] still succeeds whenever groups divides
        # C*H*W, computing statistics across the wrong boundaries
        f = int(np.asarray(params[blk]["gn1_scale"]).shape[0])
        return resolve_group_count(f, groups)

    x = "input"
    skips = {}
    for blk in ("enc1", "enc2", "enc3", "enc4"):
        x = _emit_block(g, x, blk, params[blk], block_groups(blk))
        skips[blk] = x
        (x,) = g.add("AveragePool", [x], kernel_shape=[2, 2], strides=[2, 2])
    x = _emit_block(g, x, "bottleneck", params["bottleneck"],
                    block_groups("bottleneck"))

    for up, dec, skip in (("upconv4", "dec4", "enc4"), ("upconv3", "dec3", "enc3"),
                          ("upconv2", "dec2", "enc2"), ("upconv1", "dec1", "enc1")):
        w = g.init_tensor(f"{up}.weight", np.asarray(params[up]["weight"], np.float32))
        b = g.init_tensor(f"{up}.bias", np.asarray(params[up]["bias"], np.float32))
        (x,) = g.add("ConvTranspose", [x, w, b], kernel_shape=[2, 2], strides=[2, 2])
        (x,) = g.add("Concat", [x, skips[skip]], axis=1)
        x = _emit_block(g, x, dec, params[dec], block_groups(dec))

    wout = g.init_tensor("output_conv.weight", _conv_oihw(params["output_conv_weight"]))
    bout = g.init_tensor("output_conv.bias",
                         np.asarray(params["output_conv_bias"], np.float32))
    g.add_named("Conv", [x, wout, bout], ["output"], dilations=[1, 1], group=1,
                kernel_shape=[1, 1], pads=[0, 0, 0, 0], strides=[1, 1])

    with open(path, "wb") as f:
        f.write(g.model_bytes(opset=11))
    return path


def export_optimized_unet(params: dict, path: str) -> str:
    """Write OptimizedUNet params as an opset-11 .onnx file.

    Same capability as running the reference exporter on its OptimizedUNet
    (reference: scripts/export_to_onnx.py:41 with src/optimized_model.py:6):
    nearest-2x decoder upsampling becomes Resize(nearest/asymmetric/floor)
    — torch's own lowering of Upsample — and the squeeze-excite gates
    become GlobalAveragePool + 1x1 Convs. Initializers carry torch-style
    names (``enc1.0.weight``, ``attention4.fc.0.weight``, ...).
    """
    g = OnnxGraphBuilder("deglare_optimized_unet")
    g.inputs.append(_value_info("input", ["batch_size", 1, "height", "width"]))
    g.outputs.append(_value_info("output", ["batch_size", 1, "height", "width"]))

    def block_groups(blk: str) -> int:
        f = int(np.asarray(params[blk]["gn1_scale"]).shape[0])
        return resolve_group_count(f, 1 if blk == "enc1" else
                                   8 if blk == "bottleneck" else 4)

    def se_gate(x: str, att: str) -> str:
        p = params[att]
        (avg,) = g.add("GlobalAveragePool", [x])
        h = _emit_conv(g, avg, f"{att}.fc.0.weight", p["fc1"], kernel=1, pad=0)
        h = _emit_silu(g, h)
        gate = _emit_conv(g, h, f"{att}.fc.2.weight", p["fc2"], kernel=1, pad=0)
        (gate,) = g.add("Sigmoid", [gate])
        (y,) = g.add("Mul", [x, gate])
        return y

    x = "input"
    skips = {}
    for blk in ("enc1", "enc2", "enc3", "enc4"):
        x = _emit_block(g, x, blk, params[blk], block_groups(blk))
        skips[blk] = x
        (x,) = g.add("AveragePool", [x], kernel_shape=[2, 2], strides=[2, 2])
    x = _emit_block(g, x, "bottleneck", params["bottleneck"],
                    block_groups("bottleneck"))

    for up, dec, skip, att in (
        ("upconv4", "dec4", "enc4", "attention4"),
        ("upconv3", "dec3", "enc3", "attention3"),
        ("upconv2", "dec2", "enc2", "attention2"),
        ("upconv1", "dec1", "enc1", "attention1"),
    ):
        p = params[up]
        roi = g.init_tensor(g.uid("resize_roi"), np.zeros(0, np.float32))
        scales = g.init_tensor(g.uid("resize_scales"),
                               np.asarray([1, 1, 2, 2], np.float32))
        (x,) = g.add("Resize", [x, roi, scales], mode="nearest",
                     coordinate_transformation_mode="asymmetric",
                     nearest_mode="floor")
        x = _emit_conv(g, x, f"{up}.1.weight", p["conv"])
        x = _emit_gn(g, x, 4, p["gn_scale"], p["gn_bias"],
                     f"{up}.2.weight", f"{up}.2.bias")
        x = _emit_silu(g, x)
        a = se_gate(skips[skip], att)
        (x,) = g.add("Concat", [x, a], axis=1)
        x = _emit_block(g, x, dec, params[dec], block_groups(dec))

    wout = g.init_tensor("output.weight", _conv_oihw(params["output_weight"]))
    bout = g.init_tensor("output.bias", np.asarray(params["output_bias"], np.float32))
    g.add_named("Conv", [x, wout, bout], ["output"], dilations=[1, 1], group=1,
                kernel_shape=[1, 1], pads=[0, 0, 0, 0], strides=[1, 1])

    with open(path, "wb") as f:
        f.write(g.model_bytes(opset=11))
    return path


def export_enhanced_unet(params: dict, batch_stats: dict, path: str) -> str:
    """Write EnhancedUNet params (+ BatchNorm running stats) as opset-11 ONNX.

    Inference-mode graph (Dropout omitted, BatchNormalization uses the
    running statistics), mirroring what the reference exporter produces for
    its EnhancedUNet (reference: scripts/export_to_onnx.py:41 with
    src/model.py:240-313). Initializer names match the torch state dict
    (``enc1.conv_block.0.weight``, ``attention5.W_g.1.running_mean``, ...)
    so ``enhanced_unet_params_from_onnx`` round-trips them.
    """
    g = OnnxGraphBuilder("deglare_enhanced_unet")
    g.inputs.append(_value_info("input", ["batch_size", 1, "height", "width"]))
    g.outputs.append(_value_info("output", ["batch_size", 1, "height", "width"]))

    def bn(x: str, prefix: str, p: dict, s: dict) -> str:
        names = [
            g.init_tensor(f"{prefix}.weight", np.asarray(p["scale"], np.float32)),
            g.init_tensor(f"{prefix}.bias", np.asarray(p["bias"], np.float32)),
            g.init_tensor(f"{prefix}.running_mean", np.asarray(s["mean"], np.float32)),
            g.init_tensor(f"{prefix}.running_var", np.asarray(s["var"], np.float32)),
        ]
        (x,) = g.add("BatchNormalization", [x, *names], epsilon=1e-5)
        return x

    def residual(x: str, blk: str) -> str:
        p, s = params[blk], batch_stats[blk]
        y = _emit_conv(g, x, f"{blk}.conv_block.0.weight", p["conv1"])
        y = bn(y, f"{blk}.conv_block.1", p["bn1"], s["bn1"])
        (y,) = g.add("Relu", [y])
        y = _emit_conv(g, y, f"{blk}.conv_block.4.weight", p["conv2"])
        y = bn(y, f"{blk}.conv_block.5", p["bn2"], s["bn2"])
        if "shortcut_conv" in p:
            sc = _emit_conv(g, x, f"{blk}.shortcut.0.weight",
                            p["shortcut_conv"], kernel=1, pad=0)
            sc = bn(sc, f"{blk}.shortcut.1", p["shortcut_bn"], s["shortcut_bn"])
        else:
            sc = x
        (y,) = g.add("Add", [y, sc])
        (y,) = g.add("Relu", [y])
        return y

    def attention(gate: str, x: str, att: str) -> str:
        p, s = params[att], batch_stats[att]
        g1 = _emit_conv(g, gate, f"{att}.W_g.0.weight", p["w_g"],
                        f"{att}.W_g.0.bias", p["w_g_bias"], kernel=1, pad=0)
        g1 = bn(g1, f"{att}.W_g.1", p["bn_g"], s["bn_g"])
        x1 = _emit_conv(g, x, f"{att}.W_x.0.weight", p["w_x"],
                        f"{att}.W_x.0.bias", p["w_x_bias"], kernel=1, pad=0)
        x1 = bn(x1, f"{att}.W_x.1", p["bn_x"], s["bn_x"])
        (psi,) = g.add("Add", [g1, x1])
        (psi,) = g.add("Relu", [psi])
        psi = _emit_conv(g, psi, f"{att}.psi.0.weight", p["psi"],
                         f"{att}.psi.0.bias", p["psi_bias"], kernel=1, pad=0)
        psi = bn(psi, f"{att}.psi.1", p["bn_psi"], s["bn_psi"])
        (psi,) = g.add("Sigmoid", [psi])
        (y,) = g.add("Mul", [x, psi])
        return y

    x = "input"
    encs: dict[str, str] = {}
    for blk in ("enc1", "enc2", "enc3", "enc4", "enc5"):
        if blk != "enc1":
            (x,) = g.add("MaxPool", [x], kernel_shape=[2, 2], strides=[2, 2])
        x = residual(x, blk)
        encs[blk] = x

    # dilated bottleneck
    (x,) = g.add("MaxPool", [x], kernel_shape=[2, 2], strides=[2, 2])
    x = _emit_conv(g, x, "bottleneck.0.weight", params["bottleneck_conv1"],
                   pad=2, dilation=2)
    x = bn(x, "bottleneck.1", params["bottleneck_bn1"], batch_stats["bottleneck_bn1"])
    (x,) = g.add("Relu", [x])
    x = _emit_conv(g, x, "bottleneck.4.weight", params["bottleneck_conv2"],
                   pad=2, dilation=2)
    x = bn(x, "bottleneck.5", params["bottleneck_bn2"], batch_stats["bottleneck_bn2"])
    (x,) = g.add("Relu", [x])

    for k in (5, 4, 3, 2, 1):
        up = params[f"upconv{k}"]
        w = g.init_tensor(f"upconv{k}.weight", np.asarray(up["weight"], np.float32))
        b = g.init_tensor(f"upconv{k}.bias", np.asarray(up["bias"], np.float32))
        (x,) = g.add("ConvTranspose", [x, w, b], kernel_shape=[2, 2], strides=[2, 2])
        a = attention(x, encs[f"enc{k}"], f"attention{k}")
        (x,) = g.add("Concat", [x, a], axis=1)
        x = residual(x, f"dec{k}")

    x = _emit_conv(g, x, "output.0.weight", params["output_weight"],
                   "output.0.bias", params["output_bias"], kernel=1, pad=0)
    g.add_named("Sigmoid", [x], ["output"])

    with open(path, "wb") as f:
        f.write(g.model_bytes(opset=11))
    return path


def export_model(model, path: str) -> str:
    """Write one of the port's models (``LightweightUNet``, ``OptimizedUNet``
    or ``EnhancedUNet``, with its BatchNorm running statistics) as an
    opset-11 .onnx file, through its JAX-named parameter tree."""
    from ..models import EnhancedUNet, LightweightUNet, OptimizedUNet
    from .params_import import export_jax_batch_stats, export_jax_params

    params = export_jax_params(model)
    if isinstance(model, EnhancedUNet):
        return export_enhanced_unet(params, export_jax_batch_stats(model), path)
    if isinstance(model, OptimizedUNet):
        return export_optimized_unet(params, path)
    if isinstance(model, LightweightUNet):
        return export_lightweight_unet(params, path, groups=model.num_groups)
    raise TypeError(f"no ONNX export for {type(model).__name__}")
