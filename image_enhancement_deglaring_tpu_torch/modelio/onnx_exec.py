"""Pure-numpy ONNX graph executor.

The port's copy of ``image_enhancement_deglaring_tpu.modelio.onnx_exec``
(numpy only, over the port's own ``onnx_reader``). The reference verifies
its exported models by running them through ONNX Runtime (reference:
evaluate.py:73-140, api/app.py:74-100); the port depends on no ONNX
Runtime, so this module executes the (small) op vocabulary the exporters emit, and
that torch.onnx emits for these architectures, directly in numpy. It is a
*verification oracle* on the host, not a serving path: serving runs the
model on the card.

Supported ops: Conv, ConvTranspose, AveragePool, MaxPool,
GlobalAveragePool, InstanceNormalization, BatchNormalization, Reshape,
Shape, Concat, Mul, Add, Relu, Sigmoid, Resize (nearest/asymmetric),
Constant, Cast, Unsqueeze, Flatten, MatMul, Gemm.

Everything computes in float32 on NCHW tensors (the ONNX convention).
"""

from __future__ import annotations

import numpy as np

from .onnx_reader import OnnxGraph, OnnxNode, load_onnx


def _attr(node: OnnxNode, name: str, default=None):
    v = node.attributes.get(name, default)
    if isinstance(v, bytes):
        return v.decode()
    return v


def _conv(x, w, b, *, pads, strides, dilations, group):
    n, _c, h, wd = x.shape
    o, cg, kh, kw = w.shape
    pt, pl, pb, pr = pads
    sh, sw = strides
    dh, dw = dilations
    xp = np.pad(x, ((0, 0), (0, 0), (pt, pb), (pl, pr)))
    ho = (h + pt + pb - (dh * (kh - 1) + 1)) // sh + 1
    wo = (wd + pl + pr - (dw * (kw - 1) + 1)) // sw + 1
    og = o // group
    out = np.empty((n, o, ho, wo), np.float32)
    for gi in range(group):
        xg = xp[:, gi * cg : (gi + 1) * cg]
        wg = w[gi * og : (gi + 1) * og]
        acc = np.zeros((n, og, ho, wo), np.float32)
        for i in range(kh):
            for j in range(kw):
                patch = xg[:, :, i * dh : i * dh + ho * sh : sh,
                           j * dw : j * dw + wo * sw : sw]
                acc += np.einsum("nchw,oc->nohw", patch, wg[:, :, i, j],
                                 optimize=True)
        out[:, gi * og : (gi + 1) * og] = acc
    if b is not None:
        out += b.reshape(1, -1, 1, 1)
    return out


def _conv_transpose(x, w, b, *, pads, strides):
    n, _c, h, wd = x.shape
    _ci, o, kh, kw = w.shape
    sh, sw = strides
    pt, pl, pb, pr = pads
    full = np.zeros((n, o, (h - 1) * sh + kh, (wd - 1) * sw + kw), np.float32)
    y = np.einsum("nchw,coij->nohwij", x, w, optimize=True)
    for i in range(kh):
        for j in range(kw):
            full[:, :, i : i + h * sh : sh, j : j + wd * sw : sw] += y[..., i, j]
    ho = (h - 1) * sh + kh - pt - pb
    wo = (wd - 1) * sw + kw - pl - pr
    out = full[:, :, pt : pt + ho, pl : pl + wo]
    if b is not None:
        out = out + b.reshape(1, -1, 1, 1)
    return out


def _pool(x, *, kernel, strides, mode, pads=(0, 0, 0, 0),
          count_include_pad=0):
    kh, kw = kernel
    sh, sw = strides
    pt, pl, pb, pr = pads
    if any(pads):
        # max ignores padding entirely; avg excludes it unless
        # count_include_pad=1 (the ONNX default is exclude)
        fill = -np.inf if mode == "max" else 0.0
        xp = np.pad(x, ((0, 0), (0, 0), (pt, pb), (pl, pr)),
                    constant_values=fill)
    else:
        xp = x
    h, w = xp.shape[2:]
    ho = (h - kh) // sh + 1
    wo = (w - kw) // sw + 1

    def windows(a):
        return np.stack([
            a[..., i : i + ho * sh : sh, j : j + wo * sw : sw]
            for i in range(kh)
            for j in range(kw)
        ])

    arr = windows(xp)
    if mode == "max":
        return arr.max(0)
    if any(pads) and not count_include_pad:
        ones = np.pad(np.ones(x.shape[2:], np.float32),
                      ((pt, pb), (pl, pr)))
        return arr.sum(0) / windows(ones).sum(0)
    return arr.mean(0)


def _resize_nearest(x, scales):
    # asymmetric + floor: exact repetition for integral scales
    out = x
    for axis, s in enumerate(scales):
        if s == 1.0:
            continue
        if float(s).is_integer():
            out = np.repeat(out, int(s), axis=axis)
        else:
            size = int(np.floor(out.shape[axis] * s))
            idx = np.floor(np.arange(size) / s).astype(np.int64)
            out = np.take(out, idx, axis=axis)
    return out


def _resize_nearest_to(x, sizes):
    """Resize to EXACT requested sizes (asymmetric + floor). Round-tripping
    sizes through scales and re-flooring can land one pixel short
    (e.g. 11 -> 15: floor(11 * (15/11)) == 14), so the requested size is
    used directly as the output extent."""
    out = x
    for axis, size in enumerate(int(s) for s in sizes):
        in_sz = out.shape[axis]
        if size == in_sz:
            continue
        scale = size / in_sz
        idx = np.floor(np.arange(size) / scale).astype(np.int64)
        idx = np.clip(idx, 0, in_sz - 1)  # fp guard at the top edge
        out = np.take(out, idx, axis=axis)
    return out


def _reshape(x, shape):
    shape = [int(s) for s in shape]
    shape = [x.shape[i] if s == 0 else s for i, s in enumerate(shape)]
    return x.reshape(shape)


def run_graph(g: OnnxGraph, feeds: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """Execute ``g`` on ``feeds`` (name -> array); returns the graph outputs."""
    vals: dict[str, np.ndarray] = {}
    vals.update({k: np.asarray(v) for k, v in g.initializers.items()})
    for k, v in feeds.items():
        vals[k] = np.asarray(v, np.float32)

    # remaining-use counts: an intermediate is freed after its last consumer
    # runs, so peak memory is the live activation frontier, not the sum of
    # every layer's activations (a full-res UNet verification would
    # otherwise hold all encoder/decoder maps at once)
    remaining: dict[str, int] = {}
    for node in g.nodes:
        for name in node.inputs:
            if name:
                remaining[name] = remaining.get(name, 0) + 1
    protected = set(g.outputs) | set(g.initializers) | set(feeds)

    def inp(node, i):
        name = node.inputs[i] if i < len(node.inputs) else ""
        return vals[name] if name else None

    for node in g.nodes:
        op = node.op_type
        if op == "Conv":
            # fail-loud rule (same as the pools below): attributes this
            # oracle cannot honor must raise, not silently mis-compute
            if _attr(node, "auto_pad", "NOTSET") not in ("NOTSET", ""):
                raise NotImplementedError("Conv auto_pad")
            y = _conv(
                inp(node, 0), inp(node, 1), inp(node, 2),
                pads=_attr(node, "pads", [0, 0, 0, 0]),
                strides=_attr(node, "strides", [1, 1]),
                dilations=_attr(node, "dilations", [1, 1]),
                group=int(_attr(node, "group", 1)),
            )
        elif op == "ConvTranspose":
            if _attr(node, "auto_pad", "NOTSET") not in ("NOTSET", ""):
                raise NotImplementedError("ConvTranspose auto_pad")
            if any(int(p) for p in _attr(node, "output_padding", [0, 0])):
                raise NotImplementedError("ConvTranspose output_padding")
            if _attr(node, "output_shape") is not None:
                raise NotImplementedError("ConvTranspose output_shape")
            if int(_attr(node, "group", 1)) != 1:
                raise NotImplementedError("ConvTranspose group != 1")
            if any(int(d) != 1 for d in _attr(node, "dilations", [1, 1])):
                raise NotImplementedError("ConvTranspose dilations")
            y = _conv_transpose(
                inp(node, 0), inp(node, 1), inp(node, 2),
                pads=_attr(node, "pads", [0, 0, 0, 0]),
                strides=_attr(node, "strides", [1, 1]),
            )
        elif op in ("AveragePool", "MaxPool"):
            # attributes this oracle cannot honor must fail loudly, not
            # silently compute the wrong pool
            if _attr(node, "ceil_mode", 0):
                raise NotImplementedError(f"{op} ceil_mode")
            if _attr(node, "auto_pad", "NOTSET") not in ("NOTSET", ""):
                raise NotImplementedError(f"{op} auto_pad")
            if any(int(d) != 1 for d in _attr(node, "dilations", [1, 1])):
                raise NotImplementedError(f"{op} dilations")
            y = _pool(
                inp(node, 0),
                kernel=_attr(node, "kernel_shape"),
                # ONNX defaults: strides are 1 per axis (NOT kernel_shape)
                strides=_attr(node, "strides", [1, 1]),
                pads=_attr(node, "pads", [0, 0, 0, 0]),
                count_include_pad=int(_attr(node, "count_include_pad", 0)),
                mode="avg" if op == "AveragePool" else "max",
            )
        elif op == "GlobalAveragePool":
            y = inp(node, 0).mean(axis=(2, 3), keepdims=True)
        elif op == "InstanceNormalization":
            x = inp(node, 0)
            scale, bias = inp(node, 1), inp(node, 2)
            eps = float(_attr(node, "epsilon", 1e-5))
            ax = tuple(range(2, x.ndim))
            mu = x.mean(axis=ax, keepdims=True)
            var = x.var(axis=ax, keepdims=True)
            shp = (1, -1) + (1,) * (x.ndim - 2)
            y = (x - mu) / np.sqrt(var + eps) * scale.reshape(shp) + bias.reshape(shp)
        elif op == "BatchNormalization":
            x = inp(node, 0)
            scale, bias = inp(node, 1), inp(node, 2)
            mean, var = inp(node, 3), inp(node, 4)
            eps = float(_attr(node, "epsilon", 1e-5))
            shp = (1, -1) + (1,) * (x.ndim - 2)
            y = (x - mean.reshape(shp)) / np.sqrt(var.reshape(shp) + eps)
            y = y * scale.reshape(shp) + bias.reshape(shp)
        elif op == "Reshape":
            y = _reshape(inp(node, 0), inp(node, 1))
        elif op == "Shape":
            y = np.asarray(inp(node, 0).shape, np.int64)
        elif op == "Concat":
            y = np.concatenate(
                [vals[i] for i in node.inputs], axis=int(_attr(node, "axis", 0))
            )
        elif op == "Mul":
            y = inp(node, 0) * inp(node, 1)
        elif op == "Add":
            y = inp(node, 0) + inp(node, 1)
        elif op == "Relu":
            y = np.maximum(inp(node, 0), 0)
        elif op == "Sigmoid":
            x = inp(node, 0)
            y = np.where(x >= 0, 1.0 / (1.0 + np.exp(-np.abs(x))),
                         np.exp(-np.abs(x)) / (1.0 + np.exp(-np.abs(x))))
            y = y.astype(np.float32)
        elif op == "Resize":
            if _attr(node, "mode", "nearest") != "nearest":
                raise NotImplementedError("Resize: only nearest mode")
            x = inp(node, 0)
            scales = inp(node, 2)
            if scales is None or scales.size == 0:
                sizes = [int(s) for s in inp(node, 3)]
                # integral iff each requested extent is a multiple of the
                # input extent: coordinate/nearest modes coincide only on
                # integral UPSCALES (exact sample repetition) — an integral
                # downscale samples different pixels per mode, so it must
                # fall through to the fail-loud guard below
                integral = all(o % i == 0 for o, i in zip(sizes, x.shape))
            else:
                sizes = None
                integral = all(float(s).is_integer() and s >= 1
                               for s in scales)
            # every coordinate/nearest mode coincides on integral upscales
            # (exact sample repetition); anything else is implemented only
            # for asymmetric+floor — the fail-loud rule applies
            ct = _attr(node, "coordinate_transformation_mode", "half_pixel")
            nm = _attr(node, "nearest_mode", "round_prefer_floor")
            if not integral and (ct != "asymmetric" or nm != "floor"):
                raise NotImplementedError(
                    f"Resize {ct}/{nm} at non-integral scale")
            if sizes is not None:
                y = _resize_nearest_to(x, sizes)
            else:
                y = _resize_nearest(x, [float(s) for s in scales])
        elif op == "Constant":
            y = np.asarray(_attr(node, "value"))
        elif op == "Cast":
            to = int(_attr(node, "to", 1))
            y = inp(node, 0).astype({1: np.float32, 6: np.int32, 7: np.int64}[to])
        elif op == "Unsqueeze":
            y = inp(node, 0)
            for ax in sorted(_attr(node, "axes")):
                y = np.expand_dims(y, ax)
        elif op == "Flatten":
            x = inp(node, 0)
            ax = int(_attr(node, "axis", 1))
            y = x.reshape(int(np.prod(x.shape[:ax], initial=1)), -1)
        elif op == "MatMul":
            y = inp(node, 0) @ inp(node, 1)
        elif op == "Gemm":
            a, b = inp(node, 0), inp(node, 1)
            if int(_attr(node, "transA", 0)):
                a = a.T
            if int(_attr(node, "transB", 0)):
                b = b.T
            y = float(_attr(node, "alpha", 1.0)) * (a @ b)
            c = inp(node, 2)
            if c is not None:
                y = y + float(_attr(node, "beta", 1.0)) * c
        else:
            raise NotImplementedError(f"op {op} not supported by the numpy executor")
        if len(node.outputs) > 1:
            # every op above computes exactly one result; silently binding
            # only outputs[0] would surface later as a bare KeyError at the
            # consumer (or worse, the wrong tensor standing in)
            raise NotImplementedError(
                f"{op} with {len(node.outputs)} outputs")
        vals[node.outputs[0]] = np.asarray(y)
        for name in node.inputs:
            if name and name != node.outputs[0]:  # non-SSA guard
                remaining[name] -= 1
                if remaining[name] == 0 and name not in protected:
                    del vals[name]

    return {name: vals[name] for name in g.outputs}


def run_onnx(path: str, feeds: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """Load an .onnx file and execute it on ``feeds``."""
    return run_graph(load_onnx(path), feeds)
