"""Native baseline-JPEG decoder (pure Python + NumPy).

A copy of dsrt_tpu/utils/jpeg.py: the port imports nothing of the JAX package.

The reference links the vendored stb_image (inc/stb_image.h:1) so a
textured OBJ whose MTL points at a .jpg always loads; round-2 review
flagged that our loader silently fell back to a 1x1 white texture on a
PIL-less install (VERDICT r2 item 9).  This module closes that gap for
the JPEG flavors texture assets actually ship in: baseline sequential DCT
(SOF0/1) and PROGRESSIVE DCT (SOF2, spectral selection + successive
approximation, T.81 annex G), 8-bit, greyscale or YCbCr, with
restart-marker support.  Arithmetic-coded and hierarchical files raise
UnsupportedJPEG so the caller can fall back to PIL (and the error names
the real reason instead of masking it with white).

Decode pipeline (the classic ITU T.81 path): marker parse -> Huffman
entropy decode (table-driven, 16-bit peek) -> dequantize -> dezigzag ->
vectorized 8x8 IDCT (separable, einsum over all blocks at once) -> level
shift -> chroma upsample (nearest, like stb's default resampler rounding
aside) -> YCbCr->RGB (BT.601 floats, clipped).
"""

from __future__ import annotations

import struct

import numpy as np


class UnsupportedJPEG(ValueError):
    pass


ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63],
    np.int32)

# separable IDCT basis: C[u, x] = c(u)/2 * cos((2x+1) u pi / 16)
_C = np.zeros((8, 8), np.float64)
for _u in range(8):
    for _x in range(8):
        cu = (1.0 / np.sqrt(2.0)) if _u == 0 else 1.0
        _C[_u, _x] = 0.5 * cu * np.cos((2 * _x + 1) * _u * np.pi / 16.0)


class _HuffTable:
    """Canonical Huffman table with a 16-bit fast lookup array."""

    def __init__(self, counts, symbols):
        self.lookup_sym = np.zeros(1 << 16, np.uint8)
        self.lookup_len = np.zeros(1 << 16, np.uint8)
        code = 0
        k = 0
        for length in range(1, 17):
            for _ in range(counts[length - 1]):
                sym = symbols[k]
                k += 1
                lo = code << (16 - length)
                hi = (code + 1) << (16 - length)
                self.lookup_sym[lo:hi] = sym
                self.lookup_len[lo:hi] = length
                code += 1
            code <<= 1


class _BitReader:
    """MSB-first bit reader over the entropy segment (0xFF00 unstuffed)."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.acc = 0
        self.nbits = 0

    def _fill(self):
        while self.nbits <= 48 and self.pos < len(self.data):
            self.acc = (self.acc << 8) | self.data[self.pos]
            self.pos += 1
            self.nbits += 8

    def peek16(self) -> int:
        if self.nbits < 16:
            self._fill()
        if self.nbits >= 16:
            return (self.acc >> (self.nbits - 16)) & 0xFFFF
        # end of stream: pad with 1s (spec behavior for final bits)
        return ((self.acc << (16 - self.nbits)) | ((1 << (16 - self.nbits)) - 1)) \
            & 0xFFFF if self.nbits else 0xFFFF

    def drop(self, n: int):
        self.nbits -= n
        self.acc &= (1 << max(self.nbits, 0)) - 1

    def get(self, n: int) -> int:
        if n == 0:
            return 0
        if self.nbits < n:
            self._fill()
        if self.nbits < n:
            raise UnsupportedJPEG("truncated entropy stream")
        v = (self.acc >> (self.nbits - n)) & ((1 << n) - 1)
        self.drop(n)
        return v


def _extend(v: int, n: int) -> int:
    """JPEG EXTEND: map n-bit magnitude to signed value (T.81 F.12)."""
    return v - ((1 << n) - 1) if n and v < (1 << (n - 1)) else v


def decode_jpeg(data: bytes) -> np.ndarray:
    """Decode a baseline JPEG to (H, W, 3) uint8 RGB."""
    if data[:2] != b"\xff\xd8":
        raise UnsupportedJPEG("not a JPEG (no SOI)")
    pos = 2
    qt = {}
    huff_dc = {}
    huff_ac = {}
    frame = None
    restart_interval = 0
    while pos < len(data):
        if data[pos] != 0xFF:
            pos += 1
            continue
        marker = data[pos + 1]
        pos += 2
        if marker in (0xD8, 0x01) or 0xD0 <= marker <= 0xD7:
            continue
        if marker == 0xD9:  # EOI
            break
        (seglen,) = struct.unpack(">H", data[pos:pos + 2])
        seg = data[pos + 2:pos + seglen]
        if marker == 0xDB:  # DQT
            i = 0
            while i < len(seg):
                pq, tq = seg[i] >> 4, seg[i] & 15
                i += 1
                if pq:
                    tbl = np.frombuffer(seg[i:i + 128], ">u2").astype(np.int32)
                    i += 128
                else:
                    tbl = np.frombuffer(seg[i:i + 64], np.uint8).astype(np.int32)
                    i += 64
                qt[tq] = tbl
        elif marker == 0xC4:  # DHT
            i = 0
            while i < len(seg):
                tc, th = seg[i] >> 4, seg[i] & 15
                counts = list(seg[i + 1:i + 17])
                n = sum(counts)
                symbols = list(seg[i + 17:i + 17 + n])
                (huff_ac if tc else huff_dc)[th] = _HuffTable(counts, symbols)
                i += 17 + n
        elif marker in (0xC0, 0xC1, 0xC2):  # SOF0/1 baseline, SOF2 prog
            prec, h, w, nc = seg[0], struct.unpack(">H", seg[1:3])[0], \
                struct.unpack(">H", seg[3:5])[0], seg[5]
            if prec != 8:
                raise UnsupportedJPEG(f"{prec}-bit precision")
            comps = []
            for c in range(nc):
                cid, hv, tq = seg[6 + 3 * c], seg[7 + 3 * c], seg[8 + 3 * c]
                comps.append({"id": cid, "h": hv >> 4, "v": hv & 15, "tq": tq})
            frame = {"w": w, "h": h, "comps": comps,
                     "progressive": marker == 0xC2}
        elif marker in (0xC3, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA, 0xCB,
                        0xCD, 0xCE, 0xCF):
            raise UnsupportedJPEG(f"unsupported SOF marker 0x{marker:02x} "
                                  "(lossless/arithmetic/hierarchical)")
        elif marker == 0xDD:  # DRI
            restart_interval = struct.unpack(">H", seg[:2])[0]
        elif marker == 0xDA:  # SOS
            if frame is None:
                raise UnsupportedJPEG("SOS before SOF")
            ns = seg[0]
            scan = []
            for c in range(ns):
                cs, tt = seg[1 + 2 * c], seg[2 + 2 * c]
                comp = next(x for x in frame["comps"] if x["id"] == cs)
                scan.append((comp, tt >> 4, tt & 15))
            entropy_start = pos + seglen
            if not frame["progressive"]:
                return _decode_scan(data, entropy_start, frame, scan, qt,
                                    huff_dc, huff_ac, restart_interval)
            ss, se = seg[1 + 2 * ns], seg[2 + 2 * ns]
            ahal = seg[3 + 2 * ns]
            pos = _decode_scan_progressive(
                data, entropy_start, frame, scan, huff_dc, huff_ac,
                restart_interval, ss, se, ahal >> 4, ahal & 15)
            continue
        pos += seglen
    if frame is not None and frame.get("progressive") \
            and "coef" in frame["comps"][0]:
        return _finish(frame, qt)
    raise UnsupportedJPEG("no scan data found")


def _geometry(frame):
    w, h = frame["w"], frame["h"]
    comps = frame["comps"]
    hmax = max(c["h"] for c in comps)
    vmax = max(c["v"] for c in comps)
    mcux = (w + 8 * hmax - 1) // (8 * hmax)
    mcuy = (h + 8 * vmax - 1) // (8 * vmax)
    return hmax, vmax, mcux, mcuy


def _entropy_segments(data, pos):
    """Unstuff the entropy stream from `pos` (0xFF00 -> 0xFF), split at
    RSTn markers.  Returns (segments, end_pos) with end_pos at the 0xFF
    of the terminating marker."""
    out = bytearray()
    segments = [out]
    end = len(data)
    i = pos
    while i < end:
        b = data[i]
        if b == 0xFF:
            m = data[i + 1] if i + 1 < end else 0xD9
            if m == 0x00:
                out.append(0xFF)
                i += 2
                continue
            if 0xD0 <= m <= 0xD7:  # restart marker
                out = bytearray()
                segments.append(out)
                i += 2
                continue
            break  # any other marker ends the scan
        out.append(b)
        i += 1
    return segments, i


def _alloc_coef(frame):
    _, _, mcux, mcuy = _geometry(frame)
    for c in frame["comps"]:
        if "coef" not in c:
            c["coef"] = np.zeros((mcuy * c["v"], mcux * c["h"], 64),
                                 np.int32)


def _decode_scan(data, pos, frame, scan, qt, huff_dc, huff_ac, dri):
    comps = frame["comps"]
    hmax, vmax, mcux, mcuy = _geometry(frame)
    segments, _ = _entropy_segments(data, pos)
    _alloc_coef(frame)
    nmcu = mcux * mcuy
    per_rst = dri if dri else nmcu
    mcu = 0
    seg_idx = 0
    reader = _BitReader(bytes(segments[0]))
    pred = {c["id"]: 0 for c in comps}
    while mcu < nmcu:
        if dri and mcu and mcu % per_rst == 0:
            seg_idx += 1
            if seg_idx >= len(segments):
                raise UnsupportedJPEG("missing restart segment")
            reader = _BitReader(bytes(segments[seg_idx]))
            pred = {c["id"]: 0 for c in comps}
        my, mx = divmod(mcu, mcux)
        for comp, tdc, tac in scan:
            dct = huff_dc[tdc]
            act = huff_ac[tac]
            for by in range(comp["v"]):
                for bx in range(comp["h"]):
                    blk = _decode_block(reader, dct, act)
                    pred[comp["id"]] += blk[0]
                    blk[0] = pred[comp["id"]]
                    comp["coef"][my * comp["v"] + by,
                                 mx * comp["h"] + bx] = blk
        mcu += 1

    return _finish(frame, qt)


def _finish(frame, qt):
    """Dequantize + dezigzag + IDCT + upsample + color convert the
    accumulated coefficient planes (shared by the baseline and
    progressive paths)."""
    w, h = frame["w"], frame["h"]
    comps = frame["comps"]
    hmax, vmax, _, _ = _geometry(frame)
    planes = []
    for c in comps:
        q = qt[c["tq"]]
        coef = c["coef"].astype(np.float64) * q[None, None, :]
        z = np.zeros_like(coef)
        z[:, :, ZIGZAG] = coef
        blocks = z.reshape(-1, 8, 8)
        # spatial = C^T @ F @ C  (einsum over every block)
        spatial = np.einsum("ux,buv,vy->bxy", _C, blocks, _C)
        bh, bw = c["coef"].shape[:2]
        img = spatial.reshape(bh, bw, 8, 8).transpose(0, 2, 1, 3) \
            .reshape(bh * 8, bw * 8)
        img = np.clip(np.round(img + 128.0), 0, 255).astype(np.uint8)
        # crop to the component's true dimensions, then upsample.  2x axes
        # use the stb/libjpeg "fancy" triangle filter ((3*near + far + 2)
        # >> 2, stb_image stbi__resample_row_hv_2); other ratios repeat.
        ch = -(-h * c["v"] // vmax)
        cw = -(-w * c["h"] // hmax)
        img = img[:ch, :cw]
        ry, rx = vmax // c["v"], hmax // c["h"]
        if rx == 2:
            img = _fancy_up2(img, axis=1)
        elif rx > 1:
            img = np.repeat(img, rx, axis=1)
        if ry == 2:
            img = _fancy_up2(img, axis=0)
        elif ry > 1:
            img = np.repeat(img, ry, axis=0)
        planes.append(img)

    if len(planes) == 1:
        y = planes[0][:h, :w].astype(np.float64)
        rgb = np.stack([y, y, y], axis=-1)
    elif len(planes) == 3:
        y = planes[0][:h, :w].astype(np.float64)
        cb = planes[1][:h, :w].astype(np.float64) - 128.0
        cr = planes[2][:h, :w].astype(np.float64) - 128.0
        r = y + 1.402 * cr
        g = y - 0.344136 * cb - 0.714136 * cr
        b = y + 1.772 * cb
        rgb = np.stack([r, g, b], axis=-1)
    else:
        raise UnsupportedJPEG(f"{len(planes)}-component JPEG")
    return np.clip(np.round(rgb), 0, 255).astype(np.uint8)


def _huff_decode(reader, table):
    peek = reader.peek16()
    n = table.lookup_len[peek]
    if n == 0:
        raise UnsupportedJPEG("bad Huffman code")
    reader.drop(int(n))
    return int(table.lookup_sym[peek])


def _refine_nonzero(reader, blk, k, bit):
    """AC successive-approximation correction bit for a nonzero
    coefficient (T.81 G.1.2.3; two's-complement & works for negatives
    in Python exactly as for C shorts)."""
    c = int(blk[k])
    if reader.get(1):
        if (c & bit) == 0:
            blk[k] = c + bit if c > 0 else c - bit


def _ac_first(reader, act, blk, ss, se, al, state):
    """First AC scan of a band: EOB-run decoding (T.81 G.1.2.2)."""
    if state["eobrun"] > 0:
        state["eobrun"] -= 1
        return
    k = ss
    while k <= se:
        rs = _huff_decode(reader, act)
        r, s = rs >> 4, rs & 15
        if s == 0:
            if r < 15:
                state["eobrun"] = (1 << r) - 1
                if r:
                    state["eobrun"] += reader.get(r)
                return
            k += 16         # ZRL
        else:
            k += r
            if k > se:
                raise UnsupportedJPEG("AC run past spectral band")
            blk[k] = _extend(reader.get(s), s) << al
            k += 1


def _ac_refine(reader, act, blk, ss, se, al, state):
    """AC refinement scan (T.81 G.1.2.3; the stb_image
    stbi__jpeg_decode_block_prog_ac structure, coefficients in zigzag
    order since the planes store zigzag indices)."""
    bit = 1 << al
    if state["eobrun"] > 0:
        state["eobrun"] -= 1
        for k in range(ss, se + 1):
            if blk[k] != 0:
                _refine_nonzero(reader, blk, k, bit)
        return
    k = ss
    while k <= se:
        rs = _huff_decode(reader, act)
        r, s = rs >> 4, rs & 15
        if s == 0:
            if r < 15:
                state["eobrun"] = (1 << r) - 1
                if r:
                    state["eobrun"] += reader.get(r)
                r = 64      # force the tail walk to spec_end
            val = 0
        else:
            if s != 1:
                raise UnsupportedJPEG("bad AC refinement size")
            val = bit if reader.get(1) else -bit
        # advance over r zero-HISTORY coefficients, refining nonzeros
        # passed along the way; then place the new value
        while k <= se:
            if blk[k] != 0:
                _refine_nonzero(reader, blk, k, bit)
                k += 1
            else:
                if r == 0:
                    if val:
                        blk[k] = val
                    k += 1
                    break
                r -= 1
                k += 1


def _decode_scan_progressive(data, pos, frame, scan, huff_dc, huff_ac,
                             dri, ss, se, ah, al):
    """One progressive scan (T.81 annex G): DC first/refinement
    (interleaved or single-component) or a single-component AC band
    scan.  Accumulates into the per-component zigzag coefficient
    planes; _finish renders once all scans are in.  Returns the stream
    position after the scan's entropy data."""
    comps = frame["comps"]
    hmax, vmax, mcux, mcuy = _geometry(frame)
    segments, end = _entropy_segments(data, pos)
    _alloc_coef(frame)

    ctx = {"seg": 0, "reader": _BitReader(bytes(segments[0])),
           "pred": {c["id"]: 0 for c in comps}}
    state = {"eobrun": 0}

    def restart():
        ctx["seg"] += 1
        if ctx["seg"] >= len(segments):
            raise UnsupportedJPEG("missing restart segment")
        ctx["reader"] = _BitReader(bytes(segments[ctx["seg"]]))
        ctx["pred"] = {c["id"]: 0 for c in comps}
        state["eobrun"] = 0

    def dc_block(comp, tdc, blk):
        reader = ctx["reader"]
        if ah == 0:
            size = _huff_decode(reader, huff_dc[tdc])
            diff = _extend(reader.get(size), size)
            ctx["pred"][comp["id"]] += diff
            blk[0] = ctx["pred"][comp["id"]] << al
        else:
            if reader.get(1):
                blk[0] += 1 << al

    if ss == 0 and len(scan) > 1:
        # interleaved DC scan
        if se != 0:
            raise UnsupportedJPEG("interleaved scan with AC band")
        nmcu = mcux * mcuy
        per_rst = dri if dri else nmcu
        for mcu in range(nmcu):
            if dri and mcu and mcu % per_rst == 0:
                restart()
            my, mx = divmod(mcu, mcux)
            for comp, tdc, _tac in scan:
                for by in range(comp["v"]):
                    for bx in range(comp["h"]):
                        dc_block(comp, tdc,
                                 comp["coef"][my * comp["v"] + by,
                                              mx * comp["h"] + bx])
        return end
    if len(scan) != 1:
        raise UnsupportedJPEG("interleaved progressive AC scan")

    # single-component scan over the component's own (non-interleaved)
    # block grid (T.81 A.2.2)
    comp, tdc, tac = scan[0]
    cw = -(-frame["w"] * comp["h"] // hmax)
    ch = -(-frame["h"] * comp["v"] // vmax)
    bw_ni = (cw + 7) // 8
    bh_ni = (ch + 7) // 8
    nblk = bw_ni * bh_ni
    per_rst = dri if dri else nblk
    for bi in range(nblk):
        if dri and bi and bi % per_rst == 0:
            restart()
        by, bx = divmod(bi, bw_ni)
        blk = comp["coef"][by, bx]
        if ss == 0:
            dc_block(comp, tdc, blk)
            if se != 0:
                raise UnsupportedJPEG("scan mixes DC and AC")
        elif ah == 0:
            _ac_first(ctx["reader"], huff_ac[tac], blk, ss, se, al, state)
        else:
            _ac_refine(ctx["reader"], huff_ac[tac], blk, ss, se, al, state)
    return end


def _fancy_up2(img: np.ndarray, axis: int) -> np.ndarray:
    """2x upsample along `axis` with the JPEG triangle filter: each output
    sample is (3*nearest + other + 2) >> 2, edges clamped."""
    a = img.astype(np.uint16)
    if axis == 1:
        a = a.T
    prev = np.vstack([a[:1], a[:-1]])
    nxt = np.vstack([a[1:], a[-1:]])
    lo = (3 * a + prev + 2) >> 2
    hi = (3 * a + nxt + 2) >> 2
    out = np.empty((a.shape[0] * 2, a.shape[1]), np.uint8)
    out[0::2] = lo.astype(np.uint8)
    out[1::2] = hi.astype(np.uint8)
    return out.T if axis == 1 else out


def _decode_block(reader: _BitReader, dct: _HuffTable, act: _HuffTable):
    blk = np.zeros(64, np.int32)
    # DC
    peek = reader.peek16()
    n = dct.lookup_len[peek]
    if n == 0:
        raise UnsupportedJPEG("bad DC Huffman code")
    reader.drop(int(n))
    size = int(dct.lookup_sym[peek])
    blk[0] = _extend(reader.get(size), size)
    # AC
    k = 1
    while k < 64:
        peek = reader.peek16()
        n = act.lookup_len[peek]
        if n == 0:
            raise UnsupportedJPEG("bad AC Huffman code")
        reader.drop(int(n))
        rs = int(act.lookup_sym[peek])
        r, s = rs >> 4, rs & 15
        if s == 0:
            if r == 15:
                k += 16     # ZRL
                continue
            break           # EOB
        k += r
        if k > 63:
            raise UnsupportedJPEG("AC run past end of block")
        blk[k] = _extend(reader.get(s), s)
        k += 1
    return blk


def read_jpeg(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_jpeg(f.read())
