"""A small PNG decoder (8-bit greyscale, RGB or RGBA, not interlaced, all
five row filters), so that the benchmark reads the program's PNGs and its
own texture with code of its own."""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
CHANNELS = {0: 1, 2: 3, 6: 4}


def _chunks(data: bytes):
    pos = len(SIGNATURE)
    while pos + 8 <= len(data):
        (ln,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        yield tag, data[pos + 8:pos + 8 + ln]
        pos += 12 + ln


def size(path: str):
    """(width, height) from the IHDR chunk."""
    with open(path, "rb") as fh:
        head = fh.read(24)
    if head[:8] != SIGNATURE or head[12:16] != b"IHDR":
        raise ValueError(f"{path}: not a PNG")
    return struct.unpack(">II", head[16:24])


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def read_rgb8(path: str) -> np.ndarray:
    """(H, W, 3) uint8 of an 8-bit PNG (greyscale repeated, alpha dropped)."""
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:8] != SIGNATURE:
        raise ValueError(f"{path}: not a PNG")
    idat = []
    w = h = None
    for tag, payload in _chunks(data):
        if tag == b"IHDR":
            w, h, depth, ctype, _, _, interlace = struct.unpack(
                ">IIBBBBB", payload)
            if depth != 8 or ctype not in CHANNELS or interlace:
                raise ValueError(f"{path}: unsupported PNG")
        elif tag == b"IDAT":
            idat.append(payload)
        elif tag == b"IEND":
            break
    nch = CHANNELS[ctype]
    stride = w * nch
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = raw.reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for r in range(h):
        ftype, cur = rows[r, 0], rows[r, 1:]
        if ftype == 0:
            line = cur.copy()
        elif ftype == 2:
            line = (cur + prev).astype(np.uint8)
        else:
            line = np.zeros(stride, np.uint8)
            for i in range(stride):
                a = int(line[i - nch]) if i >= nch else 0
                b = int(prev[i])
                c = int(prev[i - nch]) if i >= nch else 0
                pred = {1: a, 3: (a + b) // 2, 4: _paeth(a, b, c)}[int(ftype)]
                line[i] = (int(cur[i]) + pred) & 0xFF
        out[r] = line
        prev = line
    img = out.reshape(h, w, nch)
    if nch == 1:
        return np.repeat(img, 3, axis=2)
    return np.ascontiguousarray(img[..., :3])
