"""JPEG decoder on numpy, equal to PIL's decode bit for bit.

The JAX package opens JPEGs with PIL, which decodes them with libjpeg-turbo
(the jpeg62 API) under its defaults: fancy upsampling on and the integer
IDCT. The machine with the card has no PIL, so the port decodes here.
``decode_jpeg(data)`` returns the array ``np.asarray(PIL.Image.open(...))``
gives, in PIL's mode: "L" (H, W), "RGB" (H, W, 3) or "CMYK" (H, W, 4).

- Markers: SOI, EOI, APP0 (JFIF), APP14 (Adobe and its ``transform``),
  other APPn and COM (skipped), DQT (8- and 16-bit entries), DHT, DRI,
  RST0-7, SOF0, SOF1 and SOF2 at 8 bits, SOS; 0xFF fill bytes and byte
  stuffing.
- Entropy decoding: sequential Huffman, and the progressive DC and AC
  first and refinement scans of libjpeg's ``jdphuff.c`` (EOB runs, the
  refinement's correction bits), restart intervals in both. A symbol is
  read through a 16-bit lookup per table; a code longer than 16 bits is
  libjpeg's bad code (17 bits consumed, symbol 0). Bits past the end of
  a segment read as zeros, and after an MCU that consumed one the rest of
  the segment's MCUs are left zero, as libjpeg leaves them.
- ``jidctint.c``'s ``jpeg_idct_islow`` over a band's blocks at once in
  int64, its output through the post-IDCT ``range_limit`` table with its
  wraparound (``RANGE_MASK``).
- Upsampling as ``jdsample.c`` picks it with fancy upsampling on:
  fullsize, ``h2v1``/``h2v2`` fancy (triangle filter, alternating bias,
  edges replicated at the component's own width) where the component is
  wider than 2 samples, else the plain box routines, ``h1v2`` fancy for
  4:4:0, and ``int_upsample`` for other integral ratios (4:1:1). Whole
  MCUs are decoded, each component cropped to its own size, upsampled,
  and the result cropped to the image.
- Colour as ``jdcolor.c``: YCbCr -> RGB by ``build_ycc_rgb_table``'s
  tables, RGB (Adobe transform 0, or "RGB" component ids) copied, YCCK ->
  CMYK, CMYK copied; then PIL's raw mode "CMYK;I" inverts every CMYK
  sample.
- Memory and time on any input: a band of MCU rows (about 4096 blocks)
  is entropy-decoded and transformed at a time, and a segment's bytes are
  read through 64 KiB windows, so a single-scan file costs its samples
  and the output image and little more. A multi-scan (progressive) file
  also keeps every coefficient, 16-bit as libjpeg's JCOEF. Upsampling and
  colour run a band of rows at a time. Markers are searched for with
  numpy over windows of the file, and a scan's RST markers past its last
  restart interval build no segment.

Refused, each with a ValueError naming it: a frame of more than twice
PIL's ``Image.MAX_IMAGE_PIXELS`` (PIL's decompression bomb error, raised
before anything is allocated), arithmetic coding (SOF9-11, SOF13-15),
lossless JPEG (SOF3), hierarchical frames (SOF5-7), a precision other than
8 bits (PIL refuses those too), and component counts PIL has no mode for.

A file cut short raises ValueError("image file is truncated ...") where
PIL raises. A progressive or multi-scan file needs its EOI, as libjpeg
reads all scans before the first row. A single-scan file is complete once
every MCU is decoded, unless libjpeg's bit reader, which reads ahead of
the bits it decodes, asks for a byte past the end first: ``_pil_reads_past``
replays that reader (its fast and slow paths, and PIL's 64 KiB reads).
"""

from __future__ import annotations

import functools
import struct

import numpy as np

from .png import PngImage

# zigzag index -> natural (row-major) index, then 16 entries of 63 that
# absorb a corrupt run past the end, as libjpeg's jpeg_natural_order does
_NATURAL = [
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
] + [63] * 16

_BAD_CODE = 17         # bits a code not in the table consumes (jdhuff.c)
_PAD_BYTES = 4096      # zero bytes after a segment: the zero fill at a marker
_MIN_GET_BITS = 57     # jdhuff.h: BIT_BUF_SIZE - 7 with a 64-bit buffer
_FAST_BYTES = 512      # jdhuff.c: BUFSIZE per block for decode_mcu_fast
_PIL_READ = 65536      # ImageFile.MAXBLOCK: PIL feeds the decoder in these
_WINDOW = 65536        # a reader refills when an MCU starts this many bytes on
_REFILL_BITS = 8 * _WINDOW
_ZERO_TAIL = [0] * _PAD_BYTES
_BAND_BLOCKS = 4096    # blocks of a band of MCU rows, decoded and transformed together
_BAND_PIXELS = 1 << 17  # pixels of a band of rows, upsampled and converted together
_MAX_PIXELS = 2 * 89478485  # PIL's bomb limit: twice Image.MAX_IMAGE_PIXELS

_SOF_REFUSED = {
    0xC3: "lossless JPEG (SOF3)",
    0xC5: "hierarchical JPEG (SOF5)", 0xC6: "hierarchical JPEG (SOF6)",
    0xC7: "hierarchical JPEG (SOF7)",
    0xC9: "arithmetic-coded JPEG (SOF9)", 0xCA: "arithmetic-coded JPEG (SOF10)",
    0xCB: "arithmetic-coded JPEG (SOF11)",
    0xCD: "hierarchical arithmetic-coded JPEG (SOF13)",
    0xCE: "hierarchical arithmetic-coded JPEG (SOF14)",
    0xCF: "hierarchical arithmetic-coded JPEG (SOF15)",
}
_MODES = {1: "L", 3: "RGB", 4: "CMYK"}


def _truncated(what: str) -> ValueError:
    return ValueError(f"image file is truncated ({what})")


# -- Huffman tables ----------------------------------------------------------

def _huffman_codes(bits: bytes, vals: bytes):
    """(length, code, symbol) of a DHT table's canonical codes; a table
    whose codes overflow their length raises, as jdhuff.c does."""
    out, code, i = [], 0, 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            out.append((length, code, vals[i]))
            code += 1
            i += 1
        if code > (1 << length):
            raise ValueError("corrupt JPEG Huffman table")
        code <<= 1
    return out


def _extend(x: np.ndarray, s: np.ndarray) -> np.ndarray:
    """HUFF_EXTEND: the s-bit magnitude x as a signed value."""
    return np.where(x < (1 << np.maximum(s - 1, 0)), x - (1 << s) + 1, x)


@functools.lru_cache(maxsize=32)
def _tables(bits: bytes, vals: bytes, is_dc: bool):
    """The 16-bit lookups of one table, as lists of packed ints indexed by
    the next 16 bits of the stream.

    ``plain``: ``symbol << 5 | code length``. ``fast`` folds the extra
    bits in where code and extra bits fit in 16: for DC ``difference << 5
    | bits``; for AC ``value << 12 | run << 5 | bits``, with run 64 for an
    end of block (EOB, and EOBn) and value 0 for it and for ZRL. A fast
    entry with 0 bits means "take the plain path"."""
    codes = _huffman_codes(bits, vals)
    length = np.full(65536, _BAD_CODE, np.int64)
    sym = np.zeros(65536, np.int64)
    for n, code, v in codes:
        lo = code << (16 - n)
        length[lo:lo + (1 << (16 - n))] = n
        sym[lo:lo + (1 << (16 - n))] = v
    if is_dc and (sym > 15).any():
        raise ValueError("corrupt JPEG Huffman table (DC symbol above 15)")
    pattern = np.arange(65536, dtype=np.int64)
    s = sym if is_dc else sym & 15
    total = length + s
    fits = (total <= 16) | (s == 0)  # a bad code (17 bits) has no extra bits
    extra = (pattern >> np.maximum(16 - total, 0)) & ((1 << s) - 1)
    value = np.where(s > 0, _extend(extra, s), 0)
    plain = ((sym << 5) | length).tolist()
    if is_dc:
        fast = np.where(fits, (value << 5) | total, 0)
    else:
        run = sym >> 4
        run = np.where((s == 0) & (run != 15), 64, run)
        fast = np.where(fits, (value << 12) | (run << 5) | total, (sym << 12) | (length << 5))
    return plain, fast.tolist()


# -- scan data ---------------------------------------------------------------

def _destuff_mask(raw: np.ndarray, terminated: bool) -> np.ndarray:
    """Which bytes of an entropy-coded segment are data: "FF 00" is one FF
    data byte, and libjpeg takes "FF FF ... FF 00" as one too."""
    ff = raw == 0xFF
    keep = np.ones(raw.size, bool)
    keep[:-1] &= ~(ff[:-1] & ff[1:])
    keep[1:] &= ~((raw[1:] == 0) & ff[:-1])
    if not terminated and raw.size and raw[-1] == 0xFF:
        # a trailing FF run is the start of a marker or of a stuffed byte:
        # the reader needs the byte after it
        run = raw.size - np.flatnonzero(~ff)[-1] - 1 if (~ff).any() else raw.size
        keep[raw.size - run:] = False
    return keep


class _Segment:
    """One entropy-coded segment (a restart interval): its destuffed bytes,
    their bit count, where it starts in the file, and whether a marker ends
    it (else the file ends inside it)."""

    def __init__(self, raw: np.ndarray, start: int, terminated: bool):
        self.raw, self.raw_start, self.terminated = raw, start, terminated
        self.data = raw[_destuff_mask(raw, terminated)]
        self.nbytes = int(self.data.size)
        self.nbits = 8 * self.nbytes

    def windows(self, first: int) -> list:
        """The 32-bit big-endian windows of bytes from ``first`` on
        (``win[i]`` holds bytes first+i..first+i+3), _WINDOW + _PAD_BYTES
        of them or as many as the segment has, then _PAD_BYTES of zeros:
        bits past the segment's end read as zeros."""
        part = self.data[first:first + _WINDOW + _PAD_BYTES]
        buf = np.zeros(part.size + 3, np.uint32)
        buf[:part.size] = part
        win = ((buf[:-3] << 24) | (buf[1:-2] << 16) | (buf[2:-1] << 8) | buf[3:]).tolist()
        win += _ZERO_TAIL
        return win

    def raw_after(self) -> np.ndarray:
        """The file offset just past each destuffed byte (past its 00 if
        FF); read only for a segment that the file cuts short."""
        idx = np.flatnonzero(_destuff_mask(self.raw, self.terminated))
        return self.raw_start + idx + 1 + (self.raw[idx] == 0xFF)


class _Reader:
    """A restart interval's decoder state: the bit position ``p``, counted
    from byte ``base`` of the segment, whose windows ``win`` holds from
    there (``lim``: the segment's bits from there); the DC predictions of
    the scan's components and the EOB run. An MCU may start at any p up to
    _REFILL_BITS: it reads at most a few KiB, which the zero windows past
    the segment's bytes cover. ``advance`` moves ``base`` up to p."""

    def __init__(self, seg: _Segment, ncomp: int):
        self.seg, self.base, self.p = seg, 0, 0
        self.pred, self.eobrun = [0] * ncomp, 0
        self.win, self.lim = seg.windows(0), seg.nbits

    def advance(self, p: int) -> int:
        self.base += p >> 3
        self.p = p & 7
        self.win = self.seg.windows(self.base)
        self.lim = self.seg.nbits - 8 * self.base
        return self.p

    @property
    def pos(self) -> int:
        """The bit position in the whole segment."""
        return 8 * self.base + self.p


def _markers(data: np.ndarray, pos: int, standalone: bool = True):
    """Each marker from ``pos`` on, in order: (offset of the FF before its
    code, the code); RST0-7 and TEM, which carry no segment, left out
    unless ``standalone``. A marker is an FF (the last of a run of fill
    bytes) followed by a byte neither 00 (a stuffed FF data byte) nor FF,
    as the entropy decoder and ``next_marker`` take it. Searched in
    windows that grow from 64 bytes to _WINDOW."""
    step = 64
    while pos < data.size - 1:
        part = data[pos:pos + step + 1]
        code = part[1:]
        hit = (part[:-1] == 0xFF) & (code != 0xFF) & (code != 0)
        if not standalone:
            hit &= ((code < 0xD0) | (code > 0xD7)) & (code != 0x01)
        for i in np.flatnonzero(hit).tolist():
            yield pos + i, int(code[i])
        pos += step
        step = min(2 * step, _WINDOW)


def _without_fill(raw: np.ndarray) -> np.ndarray:
    """A terminated segment's bytes without the FF fill run before its
    marker."""
    data = np.flatnonzero(raw != 0xFF)
    return raw[:data[-1] + 1 if data.size else 0]


def _scan_segments(data: np.ndarray, pos: int, wanted: int):
    """Split the entropy-coded data from ``pos`` at RST markers into the
    first ``wanted`` segments (the scan's restart intervals; markers past
    them are passed over, as their data is never decoded). Returns the
    segments and the offset of the marker that ends the scan (``None`` if
    the file ends first)."""
    segs, start = [], pos
    for at, code in _markers(data, pos):
        segs.append(_Segment(_without_fill(data[start:at]), start, True))
        if not 0xD0 <= code <= 0xD7:
            return segs, at
        start = at + 2
        if len(segs) == wanted:
            return segs, next((at for at, _ in _markers(data, start, standalone=False)), None)
    segs.append(_Segment(data[start:], start, False))
    return segs, None


# -- the frame ---------------------------------------------------------------

class _Component:
    def __init__(self, index, cid, h, v, tq):
        self.index, self.id, self.h, self.v, self.tq = index, cid, h, v, tq
        self.quant = None  # latched at the component's first scan, as libjpeg does


class _Frame:
    def __init__(self, marker: int, body: bytes):
        if len(body) < 6:
            raise ValueError("corrupt JPEG frame header")
        precision, self.height, self.width, nf = struct.unpack(">BHHB", body[:6])
        if precision != 8:
            raise ValueError(f"{precision}-bit JPEG precision: the decoder reads "
                             "8-bit samples only (PIL refuses other precisions too)")
        if nf not in _MODES:
            raise ValueError(f"JPEG with {nf} components: PIL has no mode for it")
        pixels = max(1, self.width) * max(1, self.height)
        if pixels > _MAX_PIXELS:  # PIL's _decompression_bomb_check, before any allocation
            raise ValueError(f"Image size ({pixels} pixels) exceeds limit of {_MAX_PIXELS} "
                             "pixels, could be decompression bomb DOS attack.")
        if self.height == 0 or self.width == 0:
            raise ValueError("JPEG frame of zero size (DNL-defined heights are not read)")
        if len(body) < 6 + 3 * nf:
            raise ValueError("corrupt JPEG frame header")
        self.progressive = marker == 0xC2
        self.comps = []
        for i in range(nf):
            cid, hv, tq = body[6 + 3 * i:9 + 3 * i]
            h, v = hv >> 4, hv & 15
            if not (1 <= h <= 4 and 1 <= v <= 4) or tq > 3:
                raise ValueError("corrupt JPEG frame header (sampling factors)")
            self.comps.append(_Component(i, cid, h, v, tq))
        self.hmax = max(c.h for c in self.comps)
        self.vmax = max(c.v for c in self.comps)
        self.mcus_x = -(-self.width // (8 * self.hmax))
        self.mcus_y = -(-self.height // (8 * self.vmax))
        for c in self.comps:
            if self.hmax % c.h or self.vmax % c.v:
                raise ValueError("JPEG with fractional sampling ratios")
            c.dw = -(-self.width * c.h // self.hmax)     # downsampled_width
            c.dh = -(-self.height * c.v // self.vmax)
            c.bw, c.bh = -(-c.dw // 8), -(-c.dh // 8)     # width_in_blocks
            c.pw = max(self.mcus_x * c.h, c.bw)           # the MCU-padded grid
            c.ph = max(self.mcus_y * c.v, c.bh)
        self.store = None

    def start(self, multi_scan: bool) -> None:
        """At the first scan: each component's samples (128 where no scan
        reaches, as zero coefficients give), and for a multi-scan file its
        coefficients, 16-bit as libjpeg's JCOEF, which every scan updates."""
        for c in self.comps:
            c.plane = np.full((c.bh * 8, c.bw * 8), 128, np.uint8)
        if multi_scan:
            self.store = [np.zeros((c.ph, c.pw, 64), np.int16) for c in self.comps]

    def finish(self) -> None:
        """After the last scan of a multi-scan file: its coefficients through
        the IDCT, a band of block rows at a time."""
        for c, coef in zip(self.comps, self.store):
            rows = max(1, _BAND_BLOCKS // c.pw)
            for by0 in range(0, c.bh, rows):
                _blocks_to_plane(c, coef[by0:by0 + rows], by0)


def _band_layout(frame: _Frame, comps, interleaved: bool, rows: int, stride: int):
    """A band of ``rows`` MCU rows of a scan (block rows of its component
    when it is not interleaved), held as one flat list: each component's
    region in turn, its padded block rows of ``stride`` values per block
    (64, or 1 for the DC scans). Returns the region offsets and, per MCU in
    coding order, its blocks' offsets, with the component of each."""
    offs, ks, cols, off = [], [], [], 0
    my, mx = np.mgrid[0:rows, 0:frame.mcus_x if interleaved else comps[0].bw]
    for k, c in enumerate(comps):
        v, h = (c.v, c.h) if interleaved else (1, 1)
        offs.append(off)
        for bv in range(v):
            for bh in range(h):
                cols.append(off + ((my * v + bv) * c.pw + mx * h + bh) * stride)
                ks.append(k)
        off += rows * v * c.pw * stride
    offs.append(off)
    return offs, np.stack(cols, -1).reshape(-1, len(cols)).tolist(), ks


def _blocks_to_plane(c: _Component, blocks: np.ndarray, by0: int) -> None:
    """Block rows by0.. of component c, (rows, pw, 64) coefficients, through
    the IDCT into its samples; rows past its height in blocks are MCU
    padding."""
    n = min(blocks.shape[0], c.bh - by0)
    if n <= 0:
        return
    b = blocks[:n, :c.bw].reshape(-1, 64).astype(np.int64)
    b = ((b + 0x8000) & 0xFFFF) - 0x8000                       # JCOEF is 16-bit
    quant = c.quant if c.quant is not None else np.zeros(64, np.int64)
    pix = _idct_islow(b, quant).reshape(n, c.bw, 8, 8)
    c.plane[by0 * 8:(by0 + n) * 8] = pix.transpose(0, 2, 1, 3).reshape(n * 8, c.bw * 8)


# -- entropy decoding --------------------------------------------------------

def _decode_dc(win: list, p: int, tabs, pred: list, k: int):
    """A block's DC coefficient: the difference coded at bit p added to the
    prediction of the scan's k-th component, which it replaces (int
    overflow wraps, as in libjpeg). Returns the bit after it and the value."""
    dplain, dfast = tabs
    pk = (win[p >> 3] >> (16 - (p & 7))) & 0xFFFF
    e = dfast[pk]
    if e & 31:
        p += e & 31
        diff = e >> 5
    else:
        e = dplain[pk]
        p += e & 31
        s = e >> 5
        x = (win[p >> 3] >> (32 - (p & 7) - s)) & ((1 << s) - 1)
        p += s
        diff = x if x >> (s - 1) else x - (1 << s) + 1
    dc = pred[k] + diff
    if not -0x80000000 <= dc < 0x80000000:
        dc = (dc + 0x80000000) % 0x100000000 - 0x80000000
    pred[k] = dc
    return p, dc


def _decode_sequential(rd: _Reader, mcus, ks, dc_tabs, ac_tabs, pos: list, val: list) -> None:
    """Decode MCUs of a segment (sequential Huffman): appends each decoded
    coefficient's offset to ``pos`` and its value to ``val``. An MCU that
    starts past the segment's bits is not decoded (libjpeg's
    ``insufficient_data``)."""
    win, lim, p, pred, nat = rd.win, rd.lim, rd.p, rd.pred, _NATURAL
    pa, va = pos.append, val.append
    for mcu in mcus:
        if p > _REFILL_BITS:
            p = rd.advance(p)
            win, lim = rd.win, rd.lim
        if p > lim:
            break
        for base, k in zip(mcu, ks):
            p, dc = _decode_dc(win, p, dc_tabs[k], pred, k)
            pa(base)
            va(dc)
            afast = ac_tabs[k][1]
            i = 1
            while i < 64:
                e = afast[(win[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
                t = e & 31
                if t:
                    p += t
                    if e >> 12:
                        i += (e >> 5) & 127
                        pa(base + nat[i])
                        va(e >> 12)
                        i += 1
                    else:
                        i += ((e >> 5) & 127) + 1
                else:
                    p += (e >> 5) & 127
                    s = (e >> 12) & 15
                    i += e >> 16
                    x = (win[p >> 3] >> (32 - (p & 7) - s)) & ((1 << s) - 1)
                    p += s
                    pa(base + nat[i])
                    va(x if x >> (s - 1) else x - (1 << s) + 1)
                    i += 1
    rd.p = p


def _trace_sequential(seg: _Segment, n: int, ks, dc_tabs, ac_tabs):
    """The bit requests libjpeg's reader makes per MCU of the first n of a
    sequential segment: a code's length (``n``), or ``-s`` for s extra
    bits."""
    rd = _Reader(seg, 0)
    win, p, out = rd.win, 0, []
    for _ in range(n):
        if p > _REFILL_BITS:
            p = rd.advance(p)
            win = rd.win
        ev = []
        for k in ks:
            for tab, is_dc in ((dc_tabs[k][0], True), (ac_tabs[k][0], False)):
                i = 1
                while i < 64:
                    e = tab[(win[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
                    n_bits, sym = e & 31, e >> 5
                    p += n_bits
                    ev.append(n_bits)
                    s = sym if is_dc else sym & 15
                    if s:
                        p += s
                        ev.append(-s)
                    if is_dc:
                        break
                    if s:
                        i += (sym >> 4) + 1
                    elif sym >> 4 == 15:
                        i += 16
                    else:
                        break
        out.append(ev)
    return out


def _decode_dc_first(rd: _Reader, mcus, ks, dc_tabs, al: int, coef: list) -> None:
    """A progressive DC first scan's MCUs (``decode_mcu_DC_first``)."""
    win, lim, p, pred = rd.win, rd.lim, rd.p, rd.pred
    for mcu in mcus:
        if p > _REFILL_BITS:
            p = rd.advance(p)
            win, lim = rd.win, rd.lim
        if p > lim:
            break
        for base, k in zip(mcu, ks):
            p, dc = _decode_dc(win, p, dc_tabs[k], pred, k)
            coef[base] = dc << al
    rd.p = p


def _decode_dc_refine(rd: _Reader, mcus, al: int, coef: list) -> None:
    """A progressive DC refinement scan's MCUs: one bit per block."""
    win, lim, p, p1 = rd.win, rd.lim, rd.p, 1 << al
    for mcu in mcus:
        if p > _REFILL_BITS:
            p = rd.advance(p)
            win, lim = rd.win, rd.lim
        if p > lim:
            break
        for base in mcu:
            if (win[p >> 3] >> (31 - (p & 7))) & 1:
                coef[base] |= p1
            p += 1
    rd.p = p


def _decode_ac_first(rd: _Reader, mcus, ac_tab, ss: int, se: int, al: int,
                     coef: list) -> None:
    """A progressive AC first scan's MCUs (``decode_mcu_AC_first``): one
    component, one block per MCU, end-of-band runs across blocks."""
    win, lim, p, eobrun, nat = rd.win, rd.lim, rd.p, rd.eobrun, _NATURAL
    plain = ac_tab[0]
    for mcu in mcus:
        if p > _REFILL_BITS:
            p = rd.advance(p)
            win, lim = rd.win, rd.lim
        if p > lim:
            break
        base = mcu[0]
        if eobrun:
            eobrun -= 1
            continue
        k = ss
        while k <= se:
            e = plain[(win[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
            p += e & 31
            r, s = e >> 9, (e >> 5) & 15
            if s:
                k += r
                x = (win[p >> 3] >> (32 - (p & 7) - s)) & ((1 << s) - 1)
                p += s
                coef[base + nat[k]] = (x if x >> (s - 1) else x - (1 << s) + 1) << al
            elif r == 15:
                k += 15
            else:
                eobrun = 1 << r
                if r:
                    eobrun += (win[p >> 3] >> (32 - (p & 7) - r)) & ((1 << r) - 1)
                    p += r
                eobrun -= 1
                break
            k += 1
    rd.p, rd.eobrun = p, eobrun


def _decode_ac_refine(rd: _Reader, mcus, ac_tab, ss: int, se: int, al: int,
                      coef: list) -> None:
    """A progressive AC refinement scan's MCUs (``decode_mcu_AC_refine``):
    newly nonzero coefficients of magnitude 1 << al, and a correction bit
    for each coefficient already nonzero that the band passes over."""
    win, lim, p, eobrun, nat = rd.win, rd.lim, rd.p, rd.eobrun, _NATURAL
    plain = ac_tab[0]
    p1, m1 = 1 << al, -1 << al
    for mcu in mcus:
        if p > _REFILL_BITS:
            p = rd.advance(p)
            win, lim = rd.win, rd.lim
        if p > lim:
            break
        base = mcu[0]
        k = ss
        if not eobrun:
            while k <= se:
                e = plain[(win[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
                p += e & 31
                r, s = e >> 9, (e >> 5) & 15
                if s:
                    s = p1 if (win[p >> 3] >> (31 - (p & 7))) & 1 else m1
                    p += 1
                elif r != 15:
                    eobrun = 1 << r
                    if r:
                        eobrun += (win[p >> 3] >> (32 - (p & 7) - r)) & ((1 << r) - 1)
                        p += r
                    break
                while True:
                    i = base + nat[k]
                    c = coef[i]
                    if c:
                        if (win[p >> 3] >> (31 - (p & 7))) & 1 and not c & p1:
                            coef[i] = c + p1 if c >= 0 else c + m1
                        p += 1
                    else:
                        r -= 1
                        if r < 0:
                            break
                    k += 1
                    if k > se:
                        break
                if s:
                    coef[base + nat[k]] = s
                k += 1
        if eobrun:
            while k <= se:
                i = base + nat[k]
                c = coef[i]
                if c:
                    if (win[p >> 3] >> (31 - (p & 7))) & 1 and not c & p1:
                        coef[i] = c + p1 if c >= 0 else c + m1
                    p += 1
                k += 1
            eobrun -= 1
    rd.p, rd.eobrun = p, eobrun


def _slow_steps(e: int):
    """(bits the slow path checks for, bits it then takes) for one request:
    HUFF_DECODE checks 8; a code longer than 8 bits goes on in
    ``jpeg_huff_decode``, which checks 9 and then 1 bit at a time."""
    if e < 0:
        return ((-e, -e),)
    if e <= 8:
        return ((8, e),)
    return ((8, 0), (9, 9)) + ((1, 1),) * (e - 9)


def _pil_reads_past(seg: _Segment, events, blocks_in_mcu: int, file_len: int,
                    restarts: bool) -> bool:
    """Whether libjpeg-turbo's Huffman reader, fed by PIL, asks for a byte
    past the end of a segment that the file cuts short, although every MCU
    of it is there: PIL then raises "image file is truncated".

    The slow path (``decode_mcu_slow``) refills whenever fewer bits are
    left than a request checks for, reading bytes until it holds 57; the
    fast path (``decode_mcu_fast``: never under restarts, and only while
    512 bytes per block of the MCU remain in PIL's buffer) reads 6 bytes
    whenever 16 or fewer are left. PIL's buffer grows by 64 KiB reads; an
    MCU that runs past it is decoded again from its first bit once more is
    read. Positions are in bits of the destuffed segment."""
    avail, after = seg.nbytes, seg.raw_after()
    chunks = max(1, -(-seg.raw_start // _PIL_READ))
    loaded = used = 0
    for ev in events:
        while True:
            bufend = min(chunks * _PIL_READ, file_len)
            r, q = loaded, used
            at = after[(r >> 3) - 1] if r else seg.raw_start
            if not restarts and bufend - at >= _FAST_BYTES * blocks_in_mcu:
                for e in ev:
                    if r - q <= 16:
                        r += 48
                    q += abs(e)
                break
            suspended = False
            for e in ev:
                for need, take in _slow_steps(e):
                    if r - q < need:
                        r = 8 * -(-(q + _MIN_GET_BITS) // 8)
                        nb = r >> 3
                        if nb > avail or after[nb - 1] > bufend:
                            suspended = True
                            break
                    q += take
                if suspended:
                    break
            if not suspended:
                break
            if bufend >= file_len:
                return True
            chunks += 1
        loaded, used = r, q
    return False


# -- IDCT, upsampling, colour --------------------------------------------------

_FIX = {  # jidctint.c's FIX_* at CONST_BITS 13
    "0_298631336": 2446, "0_390180644": 3196, "0_541196100": 4433,
    "0_765366865": 6270, "0_899976223": 7373, "1_175875602": 9633,
    "1_501321110": 12299, "1_847759065": 15137, "1_961570560": 16069,
    "2_053119869": 16819, "2_562915447": 20995, "3_072711026": 25172,
}
_CONST_BITS, _PASS1_BITS = 13, 2
# the post-IDCT part of prepare_range_limit_table, indexed by x & RANGE_MASK
# for a descaled x: x + 128 on [-128, 127], 255 above, 0 below, and the
# table's wraparound for x beyond +-384
_RANGE_LIMIT = np.concatenate([np.arange(128, 256), np.full(384, 255), np.zeros(384),
                               np.arange(0, 128)]).astype(np.uint8)


def _idct_1d(x: np.ndarray, shift: int) -> np.ndarray:
    """One pass of ``jpeg_idct_islow`` along axis 0 of x (8, ...) int64,
    each output descaled by ``shift`` bits with rounding."""
    f = _FIX
    z2, z3 = x[2], x[6]
    z1 = (z2 + z3) * f["0_541196100"]
    tmp2 = z1 + z3 * -f["1_847759065"]
    tmp3 = z1 + z2 * f["0_765366865"]
    tmp0 = (x[0] + x[4]) << _CONST_BITS
    tmp1 = (x[0] - x[4]) << _CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = x[7], x[5], x[3], x[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * f["1_175875602"]
    t0 = t0 * f["0_298631336"]
    t1 = t1 * f["2_053119869"]
    t2 = t2 * f["3_072711026"]
    t3 = t3 * f["1_501321110"]
    z1 = z1 * -f["0_899976223"]
    z2 = z2 * -f["2_562915447"]
    z3 = z3 * -f["1_961570560"] + z5
    z4 = z4 * -f["0_390180644"] + z5
    t0 += z1 + z3
    t1 += z2 + z4
    t2 += z2 + z3
    t3 += z1 + z4
    half = 1 << (shift - 1)
    return np.stack([tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
                     tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3]) + half >> shift


def _idct_islow(coef: np.ndarray, quant: np.ndarray) -> np.ndarray:
    """(N, 64) coefficients in natural order and a (64,) table -> (N, 8, 8)
    uint8 samples, as ``jpeg_idct_islow`` computes them: dequantise,
    columns descaled by CONST_BITS - PASS1_BITS into the int workspace,
    rows by CONST_BITS + PASS1_BITS + 3, then the range-limit table."""
    x = (coef * quant).reshape(-1, 8, 8).transpose(1, 0, 2)     # (v, N, u)
    ws = _idct_1d(x, _CONST_BITS - _PASS1_BITS)                 # (y, N, u)
    ws = (ws + 0x80000000) % 0x100000000 - 0x80000000           # the int workspace
    out = _idct_1d(ws.transpose(2, 1, 0), _CONST_BITS + _PASS1_BITS + 3)  # (x, N, y)
    return _RANGE_LIMIT[out.transpose(1, 2, 0) & 1023]


def _edge(a: np.ndarray, axis: int, step: int) -> np.ndarray:
    """a shifted by one along axis (the neighbour before for step -1, after
    for +1), the edge sample replicated."""
    n = a.shape[axis]
    idx = np.clip(np.arange(n) + step, 0, n - 1)
    return np.take(a, idx, axis=axis)


def _interleave(even: np.ndarray, odd: np.ndarray, axis: int) -> np.ndarray:
    out = np.stack([even, odd], axis=axis + 1)
    shape = list(even.shape)
    shape[axis] *= 2
    return out.reshape(shape)


def _upsample(plane: np.ndarray, hr: int, vr: int) -> np.ndarray:
    """A component's (dh, dw) samples upsampled by (vr, hr), as
    ``jinit_upsampler`` picks the routine with fancy upsampling on."""
    if hr == 1 and vr == 1:
        return plane
    a = plane.astype(np.int32)
    dw = a.shape[1]
    if hr == 2 and vr == 1 and dw > 2:                      # h2v1_fancy_upsample
        even = (3 * a + _edge(a, 1, -1) + 1) >> 2
        odd = (3 * a + _edge(a, 1, 1) + 2) >> 2
        return _interleave(even, odd, 1).astype(np.uint8)
    if hr == 1 and vr == 2:                                  # h1v2_fancy_upsample
        even = (3 * a + _edge(a, 0, -1) + 1) >> 2
        odd = (3 * a + _edge(a, 0, 1) + 2) >> 2
        return _interleave(even, odd, 0).astype(np.uint8)
    if hr == 2 and vr == 2 and dw > 2:                      # h2v2_fancy_upsample
        rows = []
        for cs in (3 * a + _edge(a, 0, -1), 3 * a + _edge(a, 0, 1)):
            even = (3 * cs + _edge(cs, 1, -1) + 8) >> 4
            odd = (3 * cs + _edge(cs, 1, 1) + 7) >> 4
            rows.append(_interleave(even, odd, 1))
        return _interleave(rows[0], rows[1], 0).astype(np.uint8)
    # h2v1_upsample, h2v2_upsample, int_upsample: each sample replicated
    return np.repeat(np.repeat(plane, vr, axis=0), hr, axis=1)


def _ycc_tables():
    """``build_ycc_rgb_table`` (SCALEBITS 16)."""
    x = np.arange(256, dtype=np.int64) - 128

    def fix(v):
        return int(v * 65536 + 0.5)

    cr_r = (fix(1.40200) * x + 32768) >> 16
    cb_b = (fix(1.77200) * x + 32768) >> 16
    cr_g = -fix(0.71414) * x
    cb_g = -fix(0.34414) * x + 32768
    return cr_r, cb_b, cr_g, cb_g


_CR_R, _CB_B, _CR_G, _CB_G = _ycc_tables()


def _ycc_to_rgb(y, cb, cr) -> list[np.ndarray]:
    """``ycc_rgb_convert`` of uint8 planes, each sum clamped to [0, 255]."""
    y = y.astype(np.int64)
    return [np.clip(y + _CR_R[cr], 0, 255),
            np.clip(y + ((_CB_G[cb] + _CR_G[cr]) >> 16), 0, 255),
            np.clip(y + _CB_B[cb], 0, 255)]


# -- markers and the decode ----------------------------------------------------

def _next_marker(data: bytes, arr: np.ndarray, pos: int) -> tuple[int, int]:
    """The next marker that carries a segment, at or after ``pos`` (garbage,
    fill bytes, RST0-7 and TEM skipped, as ``next_marker`` and
    ``read_markers`` do), and the offset after its code."""
    if data[pos:pos + 1] == b"\xff" and pos + 1 < len(data):
        code = data[pos + 1]
        if code not in (0x00, 0x01, 0xFF) and not 0xD0 <= code <= 0xD7:
            return code, pos + 2  # the marker right here, as in a well-formed file
    for at, code in _markers(arr, pos, standalone=False):
        return code, at + 2
    raise _truncated("no EOI marker")


def _parse_dqt(body: bytes, tables: list) -> None:
    pos = 0
    while pos < len(body):
        pq, tq = body[pos] >> 4, body[pos] & 15
        size = 128 if pq else 64
        if tq > 3 or pq > 1 or pos + 1 + size > len(body):
            raise ValueError("corrupt JPEG quantization table")
        raw = np.frombuffer(body[pos + 1:pos + 1 + size], ">u2" if pq else np.uint8)
        q = np.zeros(64, np.int64)
        q[_NATURAL[:64]] = raw                      # the file stores zigzag order
        tables[tq] = q
        pos += 1 + size


def _parse_dht(body: bytes, dc: dict, ac: dict) -> None:
    pos = 0
    while pos < len(body):
        if pos + 17 > len(body):
            raise ValueError("corrupt JPEG Huffman table")
        tc, th = body[pos] >> 4, body[pos] & 15
        bits = body[pos + 1:pos + 17]
        count = sum(bits)
        if tc > 1 or th > 3 or count > 256 or pos + 17 + count > len(body):
            raise ValueError("corrupt JPEG Huffman table")
        (ac if tc else dc)[th] = (bytes(bits), body[pos + 17:pos + 17 + count])
        pos += 17 + count


def _check_progression(ss, se, ah, al, ns):
    """start_pass_phuff_decoder's ERREXIT cases."""
    bad = (se != 0) if ss == 0 else (ss > se or se > 63 or ns != 1)
    if ah and al != ah - 1:
        bad = True
    if al > 13 or bad:
        raise ValueError(f"invalid JPEG progression (Ss={ss} Se={se} Ah={ah} Al={al})")


def _scan(frame: _Frame, body: bytes, qt, dc_def, ac_def, restart, data, start):
    """Decode one scan, a band of MCU rows at a time: of a single-scan file
    straight into the components' samples, of a multi-scan file into its
    stored coefficients. Returns the offset of the marker that ends the
    scan (None if the file ends first) and, when the file cuts the last
    segment short with every MCU of it there, (segment, its MCU count, the
    component of each block of an MCU, DC tables, AC tables)."""
    ns = body[0] if body else 0
    if not 1 <= ns <= 4 or len(body) < 4 + 2 * ns:
        raise ValueError("corrupt JPEG scan header")
    by_id = {c.id: c for c in frame.comps}
    comps, tds, tas = [], [], []
    for i in range(ns):
        cid, t = body[1 + 2 * i], body[2 + 2 * i]
        if cid not in by_id:
            raise ValueError("corrupt JPEG scan header (unknown component)")
        comps.append(by_id[cid])
        tds.append(t >> 4)
        tas.append(t & 15)
    ss, se, a = body[1 + 2 * ns], body[2 + 2 * ns], body[3 + 2 * ns]
    ah, al = a >> 4, a & 15
    if frame.progressive:
        _check_progression(ss, se, ah, al, ns)
    interleaved = ns > 1
    if interleaved and sum(c.h * c.v for c in comps) > 10:
        raise ValueError("corrupt JPEG (more than 10 blocks per MCU)")
    for c in comps:
        if c.quant is None:
            if qt[c.tq] is None:
                raise ValueError(f"JPEG quantization table {c.tq} was not defined")
            c.quant = qt[c.tq].copy()

    def table(defs, t, is_dc):
        if t not in defs:
            raise ValueError(f"JPEG Huffman table {t} was not defined")
        return _tables(*defs[t], is_dc)

    kind = ("sequential" if not frame.progressive else
            ("dc_first" if ah == 0 else "dc_refine") if ss == 0 else
            ("ac_first" if ah == 0 else "ac_refine"))
    dc_tabs = [table(dc_def, t, True) for t in tds] if kind in ("sequential", "dc_first") else None
    ac_tabs = [table(ac_def, t, False) for t in tas] if kind in ("sequential", "ac_first",
                                                                  "ac_refine") else None
    if interleaved:
        mcu_rows, per_row, bpm = frame.mcus_y, frame.mcus_x, sum(c.h * c.v for c in comps)
    else:
        mcu_rows, per_row, bpm = comps[0].bh, comps[0].bw, 1
    total = mcu_rows * per_row
    per = restart or total
    n_intervals = -(-total // per)
    segs, end = _scan_segments(data, start, n_intervals)
    store = frame.store
    if end is None and store is not None:
        # libjpeg reads every scan of a multi-scan file before its first
        # row, so PIL needs the EOI
        raise _truncated("no EOI marker")
    stride = 1 if ss == 0 and frame.progressive else 64
    band = max(1, _BAND_BLOCKS // (per_row * bpm))
    layouts, rd, rd_si, cut = {}, None, -1, None
    for r0 in range(0, mcu_rows, band):
        r1 = min(r0 + band, mcu_rows)
        if r1 - r0 not in layouts:
            layouts[r1 - r0] = _band_layout(frame, comps, interleaved, r1 - r0, stride)
        offs, mcus, ks = layouts[r1 - r0]
        rows = [(c, c.v * r0, c.v * r1) if interleaved else (c, r0, r1) for c in comps]
        if kind == "sequential":
            pos, val = [], []  # every block of the band is decoded anew
        else:
            coef = []
            for c, b0, b1 in rows:
                region = store[c.index][b0:b1]
                coef += (region[..., 0] if stride == 1 else region).ravel().tolist()
        m0, m1 = r0 * per_row, r1 * per_row
        m = m0
        while m < m1:
            si = m // per
            if si >= len(segs):
                if not segs[-1].terminated:
                    raise _truncated("the scan's data ends early")
                break  # corrupt: missing restart intervals stay zero
            if si != rd_si:
                rd, rd_si = _Reader(segs[si], ns), si
            stop = min(m1, (si + 1) * per)
            chunk = mcus[m - m0:stop - m0]
            if kind == "sequential":
                _decode_sequential(rd, chunk, ks, dc_tabs, ac_tabs, pos, val)
            elif kind == "dc_first":
                _decode_dc_first(rd, chunk, ks, dc_tabs, al, coef)
            elif kind == "dc_refine":
                _decode_dc_refine(rd, chunk, al, coef)
            elif kind == "ac_first":
                _decode_ac_first(rd, chunk, ac_tabs[0], ss, se, al, coef)
            else:
                _decode_ac_refine(rd, chunk, ac_tabs[0], ss, se, al, coef)
            seg = segs[si]
            if stop == min(total, (si + 1) * per) and not seg.terminated:
                if rd.pos > seg.nbits or si < n_intervals - 1:
                    raise _truncated("the scan's data ends early")
                cut = (seg, stop - si * per, ks, dc_tabs, ac_tabs)
            m = stop
        if kind == "sequential":
            coef = np.zeros(offs[-1], np.int64)
            coef[np.asarray(pos, np.int64)] = val
        else:
            coef = np.asarray(coef, np.int64)
        for k, (c, b0, b1) in enumerate(rows):
            region = coef[offs[k]:offs[k + 1]].reshape(b1 - b0, c.pw, stride)
            if store is None:
                _blocks_to_plane(c, region, b0)
            elif stride == 1:
                store[c.index][b0:b1, :, 0] = region[..., 0].astype(np.int16)
            else:
                store[c.index][b0:b1] = region.astype(np.int16)  # wraps as JCOEF does
    return end, cut


def _upsampled_rows(c: _Component, hr: int, vr: int, y0: int, y1: int) -> np.ndarray:
    """Rows y0..y1 (y0 a multiple of vr) of component c's samples upsampled
    by (vr, hr): its rows that they come from, with one more on each side
    as the vertical triangle filter's context."""
    plane = c.plane[:c.dh, :c.dw]
    r0, r1 = y0 // vr, -(-y1 // vr)
    s0, s1 = max(r0 - 1, 0), min(r1 + 1, c.dh)
    up = _upsample(plane[s0:s1], hr, vr)
    return up[(r0 - s0) * vr:(r0 - s0) * vr + y1 - y0]


def _assemble(frame: _Frame, jfif: bool, adobe) -> PngImage:
    """The image in PIL's mode from the components' samples: upsampled and
    colour-converted a band of rows at a time."""
    h, w, comps = frame.height, frame.width, frame.comps
    nf = len(comps)
    if nf == 1:
        return PngImage(np.ascontiguousarray(comps[0].plane[:h, :w]), "L", None)
    # default_decompress_parms: JFIF means YCbCr; else Adobe's transform;
    # else the component ids ("RGB" means RGB)
    ids = tuple(c.id for c in comps)
    rgb = (not jfif and adobe == 0) if (jfif or adobe is not None) else ids == (82, 71, 66)
    out = np.empty((h, w, nf), np.uint8)
    step = max(frame.vmax, _BAND_PIXELS // w // frame.vmax * frame.vmax)
    for y0 in range(0, h, step):
        y1 = min(h, y0 + step)
        planes = [_upsampled_rows(c, frame.hmax // c.h, frame.vmax // c.v, y0, y1)[:, :w]
                  for c in comps]
        if nf == 3:
            out[y0:y1] = np.stack(planes if rgb else _ycc_to_rgb(*planes), axis=-1)
            continue
        if adobe is not None and adobe != 0:    # YCCK (transform 2, or unknown)
            r, g, b = _ycc_to_rgb(*planes[:3])
            planes = [255 - r, 255 - g, 255 - b, planes[3]]
        # PIL decodes CMYK with raw mode "CMYK;I": every sample inverted
        out[y0:y1] = 255 - np.stack(planes, axis=-1).astype(np.int64)
    return PngImage(out, "RGB" if nf == 3 else "CMYK", None)


def decode_jpeg(data: bytes) -> PngImage:
    """JPEG bytes -> ``data.png.PngImage`` (pixels, PIL mode "L", "RGB" or
    "CMYK", no palette), equal to ``np.asarray(PIL.Image.open(...))``."""
    data = bytes(data)
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG file (no SOI marker)")
    arr = np.frombuffer(data, np.uint8)
    qt, dc_def, ac_def = [None] * 4, {}, {}
    restart, jfif, adobe = 0, False, None
    frame, scans = None, 0
    pos = 2
    while True:
        marker, pos = _next_marker(data, arr, pos)
        if marker == 0xD9:
            break
        if marker == 0xD8:
            raise ValueError("corrupt JPEG (a second SOI marker)")
        if pos + 2 > len(data):
            raise _truncated(f"marker 0x{marker:02X} header")
        (length,) = struct.unpack(">H", data[pos:pos + 2])
        if length < 2:
            raise ValueError(f"corrupt JPEG marker 0x{marker:02X} length")
        if pos + length > len(data):
            raise _truncated(f"marker 0x{marker:02X} runs past the end")
        body = data[pos + 2:pos + length]
        pos += length
        if marker in _SOF_REFUSED:
            raise ValueError(f"{_SOF_REFUSED[marker]} is not decoded by the port")
        if marker in (0xC0, 0xC1, 0xC2):
            if frame is not None:
                raise ValueError("corrupt JPEG (a second frame header)")
            frame = _Frame(marker, body)
        elif marker == 0xC4:
            _parse_dht(body, dc_def, ac_def)
        elif marker == 0xDB:
            _parse_dqt(body, qt)
        elif marker == 0xDD:
            if len(body) < 2:
                raise ValueError("corrupt JPEG restart interval")
            (restart,) = struct.unpack(">H", body[:2])
        elif marker == 0xE0:
            jfif = jfif or (len(body) >= 14 and body[:5] == b"JFIF\0")
        elif marker == 0xEE:
            if len(body) >= 12 and body[:5] == b"Adobe":
                adobe = body[11]
        elif marker == 0xDA:
            if frame is None:
                raise ValueError("corrupt JPEG (a scan before the frame header)")
            if scans == 0:
                ns = body[0] if body else 0
                frame.start(multi_scan=frame.progressive or ns < len(frame.comps))
            scans += 1
            end, cut = _scan(frame, body, qt, dc_def, ac_def, restart, arr, pos)
            if end is None:
                # the file ends inside the scan of a single-scan file
                if cut is not None:
                    seg, n, ks, dc_tabs, ac_tabs = cut
                    if _pil_reads_past(seg, _trace_sequential(seg, n, ks, dc_tabs, ac_tabs),
                                       len(ks), len(data), bool(restart)):
                        raise _truncated("the reader needs bytes past the end")
                break
            pos = end
            if frame.store is None:
                break  # every row is out: PIL reads no further
        elif marker in (0xCC, 0xDC, 0xFE) or 0xE1 <= marker <= 0xEF:
            pass  # DAC, DNL, COM, APPn
        else:
            raise ValueError(f"unsupported JPEG marker 0x{marker:02X}")
    if frame is None or scans == 0:
        raise ValueError("JPEG file has no image data")
    if frame.store is not None:
        frame.finish()
    return _assemble(frame, jfif, adobe)
