"""Baseline JPEG encoder for 8-bit gray images, on numpy.

``encode_jpeg_gray(a)`` returns the bytes that
``PIL.Image.fromarray(a, "L").save(buf, "JPEG")`` writes with PIL 12.1.0
(libjpeg-turbo 3.1.3) under its defaults: quality 75, the integer DCT, the
standard Huffman tables, no restart markers. The JAX package's
``cli.test_api`` saves a JPEG upload's answer that way; the machine with
the card has no PIL.

- Markers as libjpeg writes them: SOI, the JFIF APP0 (version 1.01, no
  density unit, density 1x1, no thumbnail), one 8-bit DQT, SOF0 with one
  component (id 1, sampling 1x1), the two DHT segments the scan uses, SOS,
  the entropy-coded data, EOI.
- Samples: the image padded to whole 8x8 blocks by repeating its last
  column and row (``jcsample.c``'s ``expand_right_edge``, ``jcprepct.c``'s
  ``expand_bottom_edge``), level-shifted by 128.
- ``jfdctint.c``'s ``jpeg_fdct_islow`` in int64, then ``jcdctmgr.c``'s
  quantization: ``(|x| + 4q) // 8q`` with the sign put back, ``q`` the
  standard luminance table scaled to quality 75 (``jcparam.c``).
- ``jchuff.c``'s sequential Huffman coding (DC differences, AC run
  lengths, ZRL, EOB), 0xFF bytes stuffed with 0x00 and the last byte
  filled with 1-bits.
"""

from __future__ import annotations

import struct

import numpy as np

from .jpeg import _NATURAL

# the luminance table of the JPEG standard (K.1), natural order
_LUMA_QUANT = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99,
], np.int64)

# the standard luminance Huffman tables (K.3): code counts by length, symbols
_DC_BITS = bytes([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0])
_DC_VALS = bytes(range(12))
_AC_BITS = bytes([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D])
_AC_VALS = bytes([
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51,
    0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xA1, 0x08, 0x23, 0x42, 0xB1, 0xC1,
    0x15, 0x52, 0xD1, 0xF0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0A, 0x16, 0x17, 0x18,
    0x19, 0x1A, 0x25, 0x26, 0x27, 0x28, 0x29, 0x2A, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39,
    0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57,
    0x58, 0x59, 0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7A, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8A, 0x92,
    0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3, 0xA4, 0xA5, 0xA6, 0xA7,
    0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6, 0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3,
    0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9, 0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8,
    0xD9, 0xDA, 0xE1, 0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF1, 0xF2,
    0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA,
])

# jfdctint.c's FIX_* at CONST_BITS 13
_CONST_BITS, _PASS1_BITS = 13, 2
_F0298, _F0390, _F0541, _F0765 = 2446, 3196, 4433, 6270
_F0899, _F1175, _F1501, _F1847 = 7373, 9633, 12299, 15137
_F1961, _F2053, _F2562, _F3072 = 16069, 16819, 20995, 25172


def quant_table() -> np.ndarray:
    """``jpeg_set_quality(75)``'s luminance table (natural order): the
    standard one scaled by 200 - 2 * 75 percent, clamped to [1, 255]."""
    return np.clip((_LUMA_QUANT * 50 + 50) // 100, 1, 255)


def _descale(x: np.ndarray, n: int) -> np.ndarray:
    return (x + (1 << (n - 1))) >> n


def _fdct_1d(d: np.ndarray, last: bool) -> np.ndarray:
    """One pass of ``jpeg_fdct_islow`` along axis 0 of d (8, ...) int64:
    the row pass (``last=False``) keeps PASS1_BITS of extra precision, the
    column pass removes it."""
    tmp0, tmp7 = d[0] + d[7], d[0] - d[7]
    tmp1, tmp6 = d[1] + d[6], d[1] - d[6]
    tmp2, tmp5 = d[2] + d[5], d[2] - d[5]
    tmp3, tmp4 = d[3] + d[4], d[3] - d[4]
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    shift = _CONST_BITS + _PASS1_BITS if last else _CONST_BITS - _PASS1_BITS
    out = [None] * 8
    if last:
        out[0] = _descale(tmp10 + tmp11, _PASS1_BITS)
        out[4] = _descale(tmp10 - tmp11, _PASS1_BITS)
    else:
        out[0] = (tmp10 + tmp11) << _PASS1_BITS
        out[4] = (tmp10 - tmp11) << _PASS1_BITS
    z1 = (tmp12 + tmp13) * _F0541
    out[2] = _descale(z1 + tmp13 * _F0765, shift)
    out[6] = _descale(z1 - tmp12 * _F1847, shift)
    z1, z2, z3, z4 = tmp4 + tmp7, tmp5 + tmp6, tmp4 + tmp6, tmp5 + tmp7
    z5 = (z3 + z4) * _F1175
    tmp4, tmp5, tmp6, tmp7 = tmp4 * _F0298, tmp5 * _F2053, tmp6 * _F3072, tmp7 * _F1501
    z1, z2 = z1 * -_F0899, z2 * -_F2562
    z3, z4 = z3 * -_F1961 + z5, z4 * -_F0390 + z5
    out[7] = _descale(tmp4 + z1 + z3, shift)
    out[5] = _descale(tmp5 + z2 + z4, shift)
    out[3] = _descale(tmp6 + z2 + z3, shift)
    out[1] = _descale(tmp7 + z1 + z4, shift)
    return np.stack(out)


def _quantized_blocks(a: np.ndarray, quant: np.ndarray) -> np.ndarray:
    """(N, 64) quantized coefficients in zigzag order, blocks in raster
    order."""
    h, w = a.shape
    ph, pw = -(-h // 8) * 8, -(-w // 8) * 8
    p = np.pad(a, ((0, ph - h), (0, pw - w)), mode="edge").astype(np.int64) - 128
    blocks = p.reshape(ph // 8, 8, pw // 8, 8).transpose(1, 3, 0, 2).reshape(8, 8, -1)
    rows = _fdct_1d(blocks.transpose(1, 0, 2), last=False)      # (u, y, N)
    coef = _fdct_1d(rows.transpose(1, 0, 2), last=True)         # (v, u, N)
    coef = coef.reshape(64, -1).T                                # natural order
    q = quant * 8
    mag = (np.abs(coef) + (q >> 1)) // q
    return (np.sign(coef) * mag)[:, _NATURAL[:64]]


def _code_table(bits: bytes, vals: bytes) -> tuple[np.ndarray, np.ndarray]:
    """(code, length) per symbol 0..255 of a Huffman table given as DHT's
    counts and symbols (the canonical codes of Annex C)."""
    codes = np.zeros(256, np.int64)
    lens = np.zeros(256, np.int64)
    code, k = 0, 0
    for n in range(1, 17):
        for _ in range(bits[n - 1]):
            codes[vals[k]], lens[vals[k]] = code, n
            code += 1
            k += 1
        code <<= 1
    return codes, lens


_DC_CODES = _code_table(_DC_BITS, _DC_VALS)
_AC_CODES = _code_table(_AC_BITS, _AC_VALS)


def _magnitude(v: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(bit count, the value's bits) of a coefficient as ``jchuff.c`` emits
    them: a negative value sends the low bits of ``v - 1``."""
    nbits = np.zeros(v.shape, np.int64)
    m = np.abs(v)
    while np.any(m):
        nbits += m > 0
        m >>= 1
    extra = np.where(v < 0, v - 1, v) & ((1 << nbits) - 1)
    return nbits, extra


def _entropy_coded(zz: np.ndarray) -> bytes:
    """The scan's bytes for (N, 64) zigzag blocks: every symbol of every
    block with its extra bits, packed MSB first, the last byte filled with
    1-bits, each 0xFF followed by 0x00."""
    n = zz.shape[0]
    dc = np.diff(zz[:, 0], prepend=0)
    # items: (block, position key, value, bit length); sorted by block then key
    dn, de = _magnitude(dc)
    keys = [np.zeros(n, np.int64)]
    blocks = [np.arange(n)]
    vals = [(_DC_CODES[0][dn] << dn) | de]
    lens = [_DC_CODES[1][dn] + dn]
    b, k = np.nonzero(zz[:, 1:])
    k = k + 1
    if b.size:
        first = np.r_[True, b[1:] != b[:-1]]
        prev = np.where(first, 0, np.r_[0, k[:-1]])
        run = k - prev - 1
        v = zz[b, k]
        an, ae = _magnitude(v)
        sym = ((run & 15) << 4) | an
        blocks.append(b)
        keys.append(k * 4 + 3)
        vals.append((_AC_CODES[0][sym] << an) | ae)
        lens.append(_AC_CODES[1][sym] + an)
        zrl = run >> 4                       # ZRL symbols before this coefficient
        zb = np.repeat(b, zrl)
        zk = np.repeat(k * 4, zrl) + (np.arange(zrl.sum()) - np.repeat(np.cumsum(zrl) - zrl, zrl))
        blocks.append(zb)
        keys.append(zk)
        vals.append(np.full(zb.size, _AC_CODES[0][0xF0]))
        lens.append(np.full(zb.size, _AC_CODES[1][0xF0]))
    eob = zz[:, 63] == 0                     # EOB after the last nonzero of a block
    blocks.append(np.nonzero(eob)[0])
    keys.append(np.full(int(eob.sum()), 64 * 4))
    vals.append(np.full(int(eob.sum()), _AC_CODES[0][0x00]))
    lens.append(np.full(int(eob.sum()), _AC_CODES[1][0x00]))
    blocks, keys = np.concatenate(blocks), np.concatenate(keys)
    order = np.lexsort((keys, blocks))
    vals, lens = np.concatenate(vals)[order], np.concatenate(lens)[order]
    # every item's bits, MSB first
    starts = np.cumsum(lens) - lens
    pos = np.arange(int(lens.sum())) - np.repeat(starts, lens)
    bits = (np.repeat(vals, lens) >> (np.repeat(lens, lens) - 1 - pos)) & 1
    bits = np.concatenate([bits, np.ones((-bits.size) % 8, np.int64)]).astype(np.uint8)
    out = np.packbits(bits)
    ff = np.nonzero(out == 0xFF)[0]
    return np.insert(out, ff + 1, 0).tobytes()


def _segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body


def encode_jpeg_gray(a: np.ndarray) -> bytes:
    """A baseline JPEG of the uint8 (H, W) image ``a`` at PIL's default
    quality, 75 (see the module docstring)."""
    a = np.asarray(a)
    if a.dtype != np.uint8 or a.ndim != 2 or 0 in a.shape:
        raise ValueError(f"encode_jpeg_gray takes a non-empty uint8 (H, W) image, got "
                         f"{a.dtype} {a.shape}")
    h, w = a.shape
    if max(h, w) > 65500:
        raise ValueError(f"Maximum supported image dimension is 65500 pixels, got {w}x{h}")
    quant = quant_table()
    zz = _quantized_blocks(a, quant)
    return b"".join([
        b"\xff\xd8",
        _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"),
        _segment(0xDB, b"\x00" + bytes(quant[_NATURAL[:64]].astype(np.uint8))),
        _segment(0xC0, struct.pack(">BHHB", 8, h, w, 1) + b"\x01\x11\x00"),
        _segment(0xC4, b"\x00" + _DC_BITS + _DC_VALS),
        _segment(0xC4, b"\x10" + _AC_BITS + _AC_VALS),
        _segment(0xDA, b"\x01\x01\x00\x00\x3f\x00"),
        _entropy_coded(zz),
        b"\xff\xd9",
    ])
