"""Hand-written CUDA kernels of the port, their plain versions, dispatchers.

Counterpart of ``image_enhancement_deglaring_tpu.ops.pallas_kernels``:

========================  ===================================  ====================
wrapper                   TPU kernel it replaces               CUDA source
========================  ===================================  ====================
gn_silu_flat              _gn_silu_flat_kernel (K1)            csrc/gn_silu.cu
gn_silu_nhwc              _gn_silu_kernel (K2)                 csrc/gn_silu.cu
conv3x3_gn_silu           _conv_gn_silu_kernel (K3)            csrc/conv_gn_silu.cu
conv3x3_gn_silu_batched   _conv_gn_silu_batched_kernel (K4)    csrc/conv_gn_silu.cu
========================  ===================================  ====================

(K5, the dec1 tail of ``pallas_dec1``, is in :mod:`.dec1`.)

Every wrapper takes and returns NHWC tensors. On a CPU tensor it computes
its plain PyTorch version (``gn_silu_plain``, ``conv3x3_gn_silu_plain``);
on a CUDA tensor it launches its kernel on the current stream or raises.
Each launch adds one to ``LAUNCHES[<wrapper name>]``. The GroupNorm
wrappers make one launch under the launch plan ``_gn_plan``. In bfloat16
the conv wrappers run the tensor-core kernel under the launch plan
``_conv_plan`` (three launches); in float32 the CUDA-core one (five
launches).

The dispatchers ``fused_group_norm_silu`` and ``fused_conv3x3_gn_silu``
choose a kernel by the same shape rules as the JAX dispatchers; unless
forced, they take the composition on a CPU tensor, as the JAX ones take
XLA's off the TPU.
"""

from __future__ import annotations

import functools
import math
import threading
from dataclasses import dataclass

import torch

from . import _build
from .conv_blocks import conv2d, group_norm, highest_precision, silu

#: kernel launches per wrapper since the last reset_launch_counts()
LAUNCHES = {"gn_silu_flat": 0, "gn_silu_nhwc": 0, "conv3x3_gn_silu": 0,
            "conv3x3_gn_silu_batched": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ------------------------------------------------------------ plain versions


def gn_silu_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, *,
                  num_groups: int, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm+SiLU as K1 and K2 compute it: float32 statistics with the
    single-pass variance E[x^2] - mean^2, then y = x*a + b with
    a = rstd*gamma, b = beta - mean*a, and y * sigmoid(y)."""
    n, h, w, c = x.shape
    cg = c // num_groups
    xf = x.float().reshape(n, h * w, num_groups, cg)
    mean = xf.mean(dim=(1, 3), keepdim=True)
    ex2 = xf.square().mean(dim=(1, 3), keepdim=True)
    rstd = torch.rsqrt(ex2 - mean * mean + eps)
    a = rstd * scale.float().reshape(1, 1, num_groups, cg)
    b = bias.float().reshape(1, 1, num_groups, cg) - mean * a
    y = xf * a + b
    return (y * torch.sigmoid(y)).reshape(x.shape).to(x.dtype)


def conv3x3_gn_silu_plain(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                          bias: torch.Tensor, *, num_groups: int,
                          eps: float = 1e-5) -> torch.Tensor:
    """Conv3x3+GN+SiLU as K3 computes it: the weights rounded to the input
    dtype (as the TPU kernel and the CUDA wrapper do), the conv on both
    widened to float32 (products and sums in float32, no TF32), two-pass
    GroupNorm, affine and SiLU in float32, one rounding to the input dtype."""
    with highest_precision():
        y = conv2d(x.float(), w.to(x.dtype).float(), padding=1)
    return silu(group_norm(y, scale, bias, num_groups=num_groups, eps=eps)).to(x.dtype)


# ------------------------------------------------------------------ wrappers


def _launch_layout(p: int, c: int) -> tuple[int, int, int]:
    """(threads per block, pixels per chunk, chunks per image) of the float32
    conv's GroupNorm passes: C * rows threads, 32 pixels per thread."""
    if c > 1024:
        raise ValueError(f"GroupNorm kernels take at most 1024 channels, got {c}")
    threads = c * max(1, 256 // c)
    chunk_pix = (threads // c) * 32
    return threads, chunk_pix, -(-p // chunk_pix)


def _check_activation(name: str, x: torch.Tensor) -> None:
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: dtype {x.dtype} not supported (float32, bfloat16)")
    if x.dim() != 4 or x.numel() == 0:
        raise ValueError(f"{name}: expected a non-empty NHWC tensor, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: input must be NHWC-contiguous")


def _affine(name: str, x: torch.Tensor, t: torch.Tensor, c: int) -> torch.Tensor:
    if t.shape != (c,):
        raise ValueError(f"{name}: affine parameter of shape {tuple(t.shape)}, want ({c},)")
    return t.to(device=x.device, dtype=torch.float32).contiguous()


def _check_groups(name: str, c: int, num_groups: int) -> None:
    if num_groups < 1 or c % num_groups != 0:
        raise ValueError(f"{name}: {c} channels do not split into {num_groups} groups")


def _stream(device: torch.device) -> int:
    """The raw handle of ``device``'s current stream: the value of
    ``torch.cuda.current_stream(device).cuda_stream`` without building a
    Stream object, a host cost paid at every launch."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def _raise_on_error(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {err}")


def gn_silu_flat(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, *,
                 num_groups: int, eps: float = 1e-5) -> torch.Tensor:
    """K1: GroupNorm+SiLU over an NHWC tensor whose (H, W*C) rows the TPU
    kernel tiled (replaces ``_fused_gn_silu_flat``)."""
    if x.device.type == "cpu":
        return gn_silu_plain(x, scale, bias, num_groups=num_groups, eps=eps)
    return _gn_silu_launch("gn_silu_flat", x, scale, bias, num_groups, eps)


def gn_silu_nhwc(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, *,
                 num_groups: int, eps: float = 1e-5) -> torch.Tensor:
    """K2: GroupNorm+SiLU over NHWC blocks, for shapes K1 does not take
    (replaces ``_fused_gn_silu_pallas``)."""
    if x.device.type == "cpu":
        return gn_silu_plain(x, scale, bias, num_groups=num_groups, eps=eps)
    return _gn_silu_launch("gn_silu_nhwc", x, scale, bias, num_groups, eps)


# The bf16 conv kernel's geometry (csrc/conv_gn_silu.cu, namespace tc) and
# the H100's shared memory (CUDA's occupancy rules for sm_90).
_TILE = 8                   # output tile 8x8 pixels: the wgmma M of 64
_CO_TILE = 64               # output channels per item: the wgmma N
_MAX_KC = 8                 # 16-channel steps per weight window (128 inputs)
_MAX_BLOCKS_PER_SM = 4      # __launch_bounds__(128, 4): 128 registers a thread
_SM_SHARED = 233_472        # shared memory of one SM
_BLOCK_RESERVED = 1_024     # shared memory the runtime keeps per block
BLOCK_SHARED_MAX = 232_448  # dynamic shared memory one block may ask for


@dataclass(frozen=True)
class ConvPlan:
    """Launch plan of the bf16 conv kernel for one call.

    An item is one 8x8 output tile of one image for one 64-channel tile of
    the output. Block ``b`` of ``grid`` walks the items ``block_range(b)``
    in item order (``decode``): output-channel tile, then groups of
    ``images`` images, then tile, then the image within the group, so the
    K images of one tile come in a row. ``kc`` is the number of 16-channel
    steps per weight window and ``windows`` the windows that cover Cin (1
    up to 128 input channels: the weight slice stays resident)."""

    n: int
    images: int
    tiles: int
    co_tiles: int
    kc: int
    windows: int
    smem: int
    blocks_per_sm: int
    grid: int

    @property
    def items(self) -> int:
        return self.n * self.tiles * self.co_tiles

    def block_range(self, b: int) -> range:
        return range(b * self.items // self.grid, (b + 1) * self.items // self.grid)

    def decode(self, i):
        """(image, tile, output-channel tile) of item ``i`` (an int or an
        integer array), with the kernel's arithmetic."""
        per_ct, per_group = self.n * self.tiles, self.tiles * self.images
        r = i % per_ct
        r2 = r % per_group
        return (r // per_group) * self.images + r2 % self.images, r2 // self.images, i // per_ct


@functools.lru_cache(maxsize=256)
def _conv_plan(n: int, h: int, w: int, cin: int, cout: int, images: int,
               sms: int) -> ConvPlan:
    """The bf16 conv kernel's launch plan on a card with ``sms`` SMs: the
    dynamic shared memory (weight window, two halo buffers, epilogue
    scratch, staged output tile: ``tc::smem_bytes``), the blocks per SM it
    leaves, and the grid, ``min(items, sms * blocks per SM)`` whatever
    ``images`` is."""
    if images < 1 or n % images != 0:
        raise ValueError(f"batch {n} not divisible by images {images}")
    kc = 1
    while kc < _MAX_KC and 16 * kc < cin:
        kc *= 2
    smem = (9 * kc * _CO_TILE * 32 + 2 * (2 * kc * (_TILE + 2) ** 2 * 16) + 7 * _CO_TILE * 4
            + _TILE * _TILE * (2 * _CO_TILE + 16))
    blocks = min(_MAX_BLOCKS_PER_SM, _SM_SHARED // (smem + _BLOCK_RESERVED))
    tiles = -(-w // _TILE) * -(-h // _TILE)
    co_tiles = -(-cout // _CO_TILE)
    return ConvPlan(n=n, images=images, tiles=tiles, co_tiles=co_tiles,
                    kc=kc, windows=-(-cin // (16 * kc)), smem=smem, blocks_per_sm=blocks,
                    grid=min(n * tiles * co_tiles, sms * blocks))


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


# The GroupNorm kernel's geometry (csrc/gn_silu.cu, namespace gnk).
_GN_THREADS = 512         # gnk::kThreadTarget: threads per block, rounded to the channel units
_GN_MAX_THREADS = 1_024   # gnk::kMaxThreads
_GN_MIN_CHUNK = 16_384    # bytes: an image below this is one chunk, with no handshake
_ELEM_BYTES = {torch.float32: 4, torch.bfloat16: 2}


@dataclass(frozen=True)
class GnPlan:
    """Launch plan of the GroupNorm+SiLU kernel (``csrc/gn_silu.cu``) for one call.

    Block ``b`` of ``grid`` owns chunk ``b % chunks`` (pixels
    ``chunk_range``) of image ``b // chunks + w * images`` in wave ``w``: a
    wave holds ``images`` whole images. A chunk keeps its first
    ``resident_pix`` pixels in shared memory and reads the rest, if any,
    twice: the route for a slab larger than one wave. ``vec`` is the
    channels a thread reads at a time, 16 bytes' worth, or 1 where the
    channels, the slab or the input's address do not allow 16-byte vectors."""

    n: int
    pixels: int
    c: int
    elem: int
    vec: int
    threads: int
    chunk_pix: int
    chunks: int
    images: int
    resident_pix: int
    smem: int

    @property
    def grid(self) -> int:
        return self.images * self.chunks

    @property
    def waves(self) -> int:
        return -(-self.n // self.images)

    def chunk_range(self, chunk: int) -> tuple[int, int]:
        p0 = chunk * self.chunk_pix
        return p0, min(self.pixels, p0 + self.chunk_pix)

    def work(self, block: int) -> list[tuple[int, int, int]]:
        """(image, first pixel, end pixel) of each wave of ``block``."""
        p0, p1 = self.chunk_range(block % self.chunks)
        return [(img, p0, p1) for img in range(block // self.chunks, self.n, self.images)]

    @property
    def reread_pix(self) -> int:
        """Pixels of the largest chunk read twice (0: every chunk resident)."""
        return max(0, self.chunk_pix - self.resident_pix)

    @property
    def bytes_read(self) -> int:
        """Bytes of activation the call reads from device memory: every pixel
        once, and what a chunk holds beyond its resident pixels once more."""
        again = sum(max(0, p1 - p0 - self.resident_pix)
                    for p0, p1 in map(self.chunk_range, range(self.chunks)))
        return self.n * (self.pixels + again) * self.c * self.elem


@functools.lru_cache(maxsize=256)
def _gn_plan(n: int, h: int, w: int, c: int, dtype: torch.dtype, sms: int,
             aligned: bool = True) -> GnPlan:
    """The GroupNorm kernel's launch plan on a card with ``sms`` SMs, at
    most one block per SM. Vectors of 16 bytes where C fills them with C /
    vec dividing 32, the slab is a multiple of 16 bytes and the input's
    address is 16-byte ``aligned``; threads and shared memory as
    ``gnk::block_threads`` and ``gnk::smem_bytes`` give them. Then the
    fewest waves whose images are resident whole, the batch spread evenly
    over them and each wave's chunks over the SMs, no chunk below
    ``_GN_MIN_CHUNK`` bytes unless it is the whole image; where one image
    does not fit all the SMs' shared memory, one image per wave on every SM,
    each chunk reading what its shared memory does not hold twice. Chunks
    start on 16-byte boundaries of the slab."""
    if not 1 <= c <= _GN_MAX_THREADS:
        raise ValueError(f"GroupNorm kernel takes 1 to {_GN_MAX_THREADS} channels, got {c}")
    elem = _ELEM_BYTES[dtype]
    p, pix_bytes = h * w, c * elem
    vec = 16 // elem
    if not (aligned and c % vec == 0 and 32 % (c // vec) == 0 and p * pix_bytes % 16 == 0):
        vec = 1
    unit = c // vec
    threads = unit * max(1, _GN_THREADS // unit)
    red_bytes = 8 * (c * (threads // 32) if vec > 1 else threads)
    align = 16 // math.gcd(16, pix_bytes)  # pixels from one 16-byte boundary to the next
    cap = (BLOCK_SHARED_MAX - red_bytes) // pix_bytes // align * align  # pixels a block holds
    need = -(-p // cap)  # chunks that hold one image
    if need > sms:
        images, chunks = 1, sms
    else:
        waves = -(-n // (sms // need))
        images = -(-n // waves)
        chunks = max(need, min(sms // images, -(-p * pix_bytes // _GN_MIN_CHUNK)))
    chunk_pix = -(-p // chunks)
    chunk_pix = -(-chunk_pix // align) * align
    resident = min(chunk_pix, cap)
    return GnPlan(n=n, pixels=p, c=c, elem=elem, vec=vec, threads=threads, chunk_pix=chunk_pix,
                  chunks=-(-p // chunk_pix), images=images, resident_pix=resident,
                  smem=-(-resident * pix_bytes // 16) * 16 + red_bytes)


#: (device index, stream) -> the GroupNorm kernel's workspace on that
#: stream and its number of counter slots
_GN_WORK: dict = {}
_GN_WORK_LOCK = threading.Lock()


def _gn_workspace(device: torch.device, stream: int, n: int,
                  part_floats: int) -> tuple[torch.Tensor, int]:
    """The GroupNorm kernel's float32 workspace on ``stream``: ``slots``
    (>= n) int32 arrival counters, which every launch leaves at 0, then
    room for ``part_floats`` chunk sums. Calls on one stream share it in
    stream order; a call on another stream gets its own. Allocated zeroed,
    on the stream, when a call needs more. Call with ``_GN_WORK_LOCK``
    held, and launch before releasing it."""
    work, slots = _GN_WORK.get((device.index, stream), (None, 0))
    if work is None or slots < n or work.numel() - slots < part_floats:
        part_floats = max(part_floats, 0 if work is None else work.numel() - slots)
        slots = max(slots, -(-n // 4) * 4)  # the sums start 16-byte aligned
        work = torch.zeros(slots + part_floats, dtype=torch.float32, device=device)
        _GN_WORK[(device.index, stream)] = (work, slots)
    return work, slots


def _gn_silu_launch(name: str, x, scale, bias, num_groups: int, eps: float):
    if x.device.type != "cuda":
        raise ValueError(f"{name}: tensor on {x.device}, want cpu or cuda")
    _check_activation(name, x)
    n, h, w, c = x.shape
    _check_groups(name, c, num_groups)
    g, b = _affine(name, x, scale, c), _affine(name, x, bias, c)
    plan = _gn_plan(n, h, w, c, x.dtype, _sm_count(x.device), x.data_ptr() % 16 == 0)
    y = torch.empty_like(x)
    fn = getattr(_build.load("gn_silu"), name)
    stream = _stream(x.device)
    with _GN_WORK_LOCK, torch.cuda.device(x.device):
        work, slots = _gn_workspace(x.device, stream, n, n * plan.chunks * c * 2)
        err = fn(x.data_ptr(), g.data_ptr(), b.data_ptr(), y.data_ptr(), work.data_ptr(),
                 work.data_ptr() + 4 * slots, n, h * w, c, num_groups, plan.vec, plan.threads,
                 plan.chunk_pix, plan.chunks, plan.images, plan.resident_pix, plan.smem, eps,
                 _DTYPE_CODE[x.dtype], stream)
    _raise_on_error(name, err)
    LAUNCHES[name] += 1
    return y


def _conv_launch(name: str, x, w, scale, bias, num_groups: int, eps: float, images: int):
    """Launch conv_gn_silu.cu for K3 (``images`` 1) or K4: in bf16 the
    tensor-core kernel under ``_conv_plan``, in float32 the CUDA-core one
    with ``images`` images per conv block."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: tensor on {x.device}, want cpu or cuda")
    _check_activation(name, x)
    n, h, wd, cin = x.shape
    if w.dim() != 4 or tuple(w.shape[:3]) != (3, 3, cin):
        raise ValueError(f"{name}: weight {tuple(w.shape)} is not (3, 3, {cin}, Cout)")
    cout = w.shape[3]
    _check_groups(name, cout, num_groups)
    wk = w.to(device=x.device, dtype=x.dtype).contiguous()
    g, b = _affine(name, x, scale, cout), _affine(name, x, bias, cout)
    out = torch.empty((n, h, wd, cout), dtype=x.dtype, device=x.device)
    lib = _build.load("conv_gn_silu")
    stream = _stream(x.device)
    if x.dtype == torch.bfloat16:
        plan = _conv_plan(n, h, wd, cin, cout, images, _sm_count(x.device))
        n_part = n * plan.tiles * cout * 2
        scratch = torch.empty((n_part + n * num_groups * 2,), dtype=torch.float32,
                              device=x.device)
        with torch.cuda.device(x.device):
            err = lib.conv3x3_gn_silu_bf16(
                x.data_ptr(), wk.data_ptr(), g.data_ptr(), b.data_ptr(), out.data_ptr(),
                scratch.data_ptr(), scratch.data_ptr() + 4 * n_part, n, h, wd, cin, cout,
                num_groups, plan.kc, images, plan.grid, plan.smem, eps, stream)
    else:
        threads, chunk_pix, chunks = _launch_layout(h * wd, cout)
        tiles = -(-h // 8) * -(-wd // 8)  # the conv's 8x8 output tiles
        yscr = torch.empty((n, h, wd, cout), dtype=torch.float32, device=x.device)
        part = torch.empty((n * max(tiles, chunks) * cout * 2,), dtype=torch.float32,
                           device=x.device)
        stats = torch.empty((n, num_groups, 2), dtype=torch.float32, device=x.device)
        with torch.cuda.device(x.device):
            err = lib.conv3x3_gn_silu_f32(
                x.data_ptr(), wk.data_ptr(), g.data_ptr(), b.data_ptr(), out.data_ptr(),
                yscr.data_ptr(), part.data_ptr(), stats.data_ptr(), n, h, wd, cin, cout,
                num_groups, chunk_pix, chunks, threads, images, eps, stream)
    _raise_on_error(name, err)
    LAUNCHES[name] += 1
    return out


def conv3x3_gn_silu(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                    bias: torch.Tensor, *, num_groups: int,
                    eps: float = 1e-5) -> torch.Tensor:
    """K3: Conv3x3(same, no bias) -> GroupNorm -> SiLU (replaces
    ``_fused_conv_gn_silu_pallas``). x: (N, H, W, Cin), w: (3, 3, Cin, Cout)
    HWIO -> (N, H, W, Cout) in x's dtype."""
    if x.device.type == "cpu":
        return conv3x3_gn_silu_plain(x, w, scale, bias, num_groups=num_groups, eps=eps)
    return _conv_launch("conv3x3_gn_silu", x, w, scale, bias, num_groups, eps, 1)


def conv3x3_gn_silu_batched(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                            bias: torch.Tensor, *, num_groups: int, images: int,
                            eps: float = 1e-5) -> torch.Tensor:
    """K4: K3's function with ``images`` images per step (replaces
    ``_fused_conv_gn_silu_batched``). In bf16 the images only order each
    block's walk (the K images of one tile in a row, see ``ConvPlan``); in
    float32 one conv block owns its output tile across them. The output
    equals K3's bit for bit. Raises ValueError unless ``images`` divides
    the batch."""
    n = x.shape[0]
    if images < 1 or n % images != 0:
        raise ValueError(f"conv3x3_gn_silu_batched: batch {n} not divisible by "
                         f"images {images}")
    if x.device.type == "cpu":
        return conv3x3_gn_silu_plain(x, w, scale, bias, num_groups=num_groups, eps=eps)
    return _conv_launch("conv3x3_gn_silu_batched", x, w, scale, bias, num_groups, eps,
                        images)


# --------------------------------------------------------------- dispatchers


def _routes_to_kernels(x: torch.Tensor) -> bool:
    """Whether ``use_kernel=None`` may pick a kernel for ``x``: on a device
    tensor, as the JAX dispatchers do on the TPU; not on a CPU tensor, as
    theirs do not off the TPU."""
    return x.device.type != "cpu"


def _flat_eligible(x: torch.Tensor, num_groups: int) -> bool:
    n, h, w, c = x.shape
    return c % num_groups == 0 and (w * c) % 128 == 0 and h >= 8


def fused_group_norm_silu(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                          *, num_groups: int, eps: float = 1e-5,
                          use_kernel: bool | None = None) -> torch.Tensor:
    """GroupNorm followed by SiLU through a fused kernel.

    On a CUDA tensor, ``use_kernel=None`` or True picks K1 when the
    (H, W*C) rows are 128-lane aligned and H >= 8, else K2 when C >= 64,
    else (None only) the composition ``silu(group_norm(...))``; a forced
    True with no eligible kernel raises. ``use_kernel=False`` is the
    composition. On a CPU tensor ``None`` is the composition, as the JAX
    dispatcher's ``None`` is XLA's off the TPU, and a forced True is the
    picked kernel's plain version (JAX runs the kernel in interpret mode
    there). The shape rules are the JAX dispatcher's."""
    if use_kernel is None and not _routes_to_kernels(x):
        use_kernel = False
    if use_kernel is None or use_kernel:
        c = x.shape[-1]
        if _flat_eligible(x, num_groups):
            return gn_silu_flat(x.contiguous(), scale, bias, num_groups=num_groups, eps=eps)
        if c % num_groups == 0 and c >= 64:
            return gn_silu_nhwc(x.contiguous(), scale, bias, num_groups=num_groups, eps=eps)
        if use_kernel:
            raise ValueError(f"no fused GN+SiLU kernel for shape {tuple(x.shape)}, "
                             f"groups={num_groups}")
    return silu(group_norm(x, scale, bias, num_groups=num_groups, eps=eps))


def fused_conv3x3_gn_silu(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                          bias: torch.Tensor, *, num_groups: int, eps: float = 1e-5,
                          use_kernel: bool | None = None,
                          images_per_step: int | None = None) -> torch.Tensor:
    """Conv3x3(same, no bias) -> GroupNorm -> SiLU through K3 or K4.

    ``use_kernel=None`` picks a kernel on a CUDA tensor for ``cout %
    num_groups == 0 and cout >= 64`` and the composition elsewhere, and on
    a CPU tensor the composition, as the JAX dispatcher's ``None`` takes
    XLA off the TPU; a forced True on a CPU tensor is the kernel's plain
    version. The JAX dispatcher also required the per-image slab to fit a
    6 MB on-chip budget of the TPU; that rule has no meaning on the H100
    and is dropped. With a kernel, ``images_per_step=K > 1`` routes to K4
    (K images per conv block; the batch must divide by K, else ValueError)
    and None or <= 1 to K3."""
    cout = w.shape[-1]
    if use_kernel is None:
        use_kernel = _routes_to_kernels(x) and cout % num_groups == 0 and cout >= 64
    if not use_kernel:
        y = conv2d(x, w, padding=1)
        return silu(group_norm(y, scale, bias, num_groups=num_groups, eps=eps))
    if cout % num_groups != 0:
        # a forced call must not compute ragged pseudo-group statistics
        raise ValueError(f"fused conv+GN+SiLU needs cout % num_groups == 0 "
                         f"(got cout={cout}, num_groups={num_groups})")
    if images_per_step is not None and images_per_step > 1:
        if x.shape[0] % images_per_step != 0:
            raise ValueError(f"batch {x.shape[0]} not divisible by images_per_step "
                             f"{images_per_step}")
        return conv3x3_gn_silu_batched(x.contiguous(), w, scale, bias, num_groups=num_groups,
                                       images=images_per_step, eps=eps)
    return conv3x3_gn_silu(x.contiguous(), w, scale, bias, num_groups=num_groups, eps=eps)
