"""Image I/O without external process boundaries.

A copy of dsrt_tpu/utils/image_io.py: the port imports nothing of the JAX package.

The reference writes binary PPM P6 from the CUDA host wrapper
(src/gpu_render.cu:1100-1107) and shells out to ImageMagick per frame for
PNG conversion (src/main.cpp:28-36).  Here PNG encoding is an in-process
pure-Python encoder (stdlib zlib), with decoders for PNG/PPM so texture
loading (the stb_image role, inc/stb_image.h) has no hard third-party
dependency.  PIL is used opportunistically for other formats (JPEG, BMP...)
when importable.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_PNG_SIG = b"\x89PNG\r\n\x1a\n"


def write_png(path: str, rgb8: np.ndarray) -> None:
    """Write an (H,W,3) uint8 array as an RGB PNG."""
    img = np.ascontiguousarray(rgb8, dtype=np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected (H,W,3) uint8, got {img.shape}")
    h, w = img.shape[:2]
    raw = b"".join(b"\x00" + img[r].tobytes() for r in range(h))  # filter 0 rows
    idat = zlib.compress(raw, 6)

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)  # 8-bit RGB
    with open(path, "wb") as f:
        f.write(_PNG_SIG + chunk(b"IHDR", ihdr) + chunk(b"IDAT", idat)
                + chunk(b"IEND", b""))


def _png_unfilter(raw: bytes, w: int, h: int, nch: int, bpp_bytes: int,
                  pos: int = 0) -> np.ndarray:
    stride = w * nch * bpp_bytes
    out = np.empty((h, stride), np.uint8)
    fb = bpp_bytes * nch
    prev = np.zeros(stride, np.uint16)
    for r in range(h):
        ftype = raw[pos]
        pos += 1
        row = np.frombuffer(raw, np.uint8, stride, pos).astype(np.uint16)
        pos += stride
        if ftype == 0:
            cur = row
        elif ftype == 1:  # Sub
            cur = row.copy()
            for i in range(fb, stride):
                cur[i] = (cur[i] + cur[i - fb]) & 0xFF
        elif ftype == 2:  # Up
            cur = (row + prev) & 0xFF
        elif ftype == 3:  # Average
            cur = row.copy()
            for i in range(stride):
                a = cur[i - fb] if i >= fb else 0
                cur[i] = (cur[i] + ((a + prev[i]) >> 1)) & 0xFF
        elif ftype == 4:  # Paeth
            cur = row.copy()
            for i in range(stride):
                a = int(cur[i - fb]) if i >= fb else 0
                b = int(prev[i])
                c = int(prev[i - fb]) if i >= fb else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                cur[i] = (cur[i] + pred) & 0xFF
        else:
            raise ValueError(f"bad PNG filter {ftype}")
        out[r] = cur.astype(np.uint8)
        prev = cur
    return out


# Adam7 interlace pass geometry: (x0, y0, dx, dy) per pass
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def read_png(path: str) -> np.ndarray:
    """Minimal PNG decoder -> (H,W,3) uint8.  Supports 8/16-bit gray /
    RGB / RGBA / gray+alpha + 8-bit palette, all filter types, and Adam7
    interlace (the stb_image PNG surface minus sub-byte depths,
    inc/stb_image.h png; 16-bit samples reduce to 8 by the high byte,
    stb's stbi__convert_16_to_8)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_SIG:
        raise ValueError("not a PNG")
    pos = 8
    idat = b""
    plte = None
    w = h = depth = ctype = interlace = None
    while pos < len(data):
        (ln,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + ln]
        pos += 12 + ln
        if tag == b"IHDR":
            w, h, depth, ctype, _, _, interlace = struct.unpack(">IIBBBBB", payload)
        elif tag == b"PLTE":
            plte = np.frombuffer(payload, np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat += payload
        elif tag == b"IEND":
            break
    if depth not in (8, 16) or interlace not in (0, 1):
        raise ValueError(f"unsupported PNG (depth={depth}, interlace={interlace})")
    if depth == 16 and ctype == 3:
        raise ValueError("16-bit palette PNG is invalid")
    nch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    sb = depth // 8                       # sample bytes
    raw = zlib.decompress(idat)

    def decode_sub(pos: int, pw: int, ph: int):
        """Unfilter one (sub)image; returns ((ph, pw, nch) u8, consumed)."""
        rows = _png_unfilter(raw, pw, ph, nch, sb, pos)
        if sb == 2:                       # 16-bit: network order, high byte
            rows = (rows.reshape(ph, pw * nch, 2)[..., 0]
                    .reshape(ph, pw * nch))
        return rows.reshape(ph, pw, nch), ph * (1 + pw * nch * sb)

    if interlace == 0:
        img, _ = decode_sub(0, w, h)
    else:                                 # Adam7: 7 independent passes
        img = np.zeros((h, w, nch), np.uint8)
        pos = 0
        for x0, y0, dx, dy in _ADAM7:
            pw = (w - x0 + dx - 1) // dx
            ph = (h - y0 + dy - 1) // dy
            if pw <= 0 or ph <= 0:
                continue
            sub, used = decode_sub(pos, pw, ph)
            img[y0::dy, x0::dx] = sub
            pos += used
    if ctype == 3:
        img = plte[img[..., 0]]
    elif ctype == 0:
        img = np.repeat(img, 3, axis=2)
    elif ctype == 4:
        img = np.repeat(img[..., :1], 3, axis=2)
    elif ctype == 6:
        img = img[..., :3]
    return np.ascontiguousarray(img)


def write_ppm(path: str, rgb8: np.ndarray) -> None:
    """Binary PPM P6, the reference's native output format
    (src/gpu_render.cu:1100-1107)."""
    img = np.ascontiguousarray(rgb8, dtype=np.uint8)
    h, w = img.shape[:2]
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(img.tobytes())


def read_ppm(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    # header: magic, w, h, maxval separated by whitespace/comments
    tokens = []
    pos = 0
    while len(tokens) < 4:
        while pos < len(data) and data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":
            while pos < len(data) and data[pos] != 0x0A:
                pos += 1
            continue
        start = pos
        while pos < len(data) and not data[pos:pos + 1].isspace():
            pos += 1
        tokens.append(data[start:pos])
    pos += 1  # single whitespace after maxval
    magic, w, h, maxval = tokens[0], int(tokens[1]), int(tokens[2]), int(tokens[3])
    if magic != b"P6" or maxval != 255:
        raise ValueError("only P6/255 PPM supported")
    img = np.frombuffer(data, np.uint8, w * h * 3, pos).reshape(h, w, 3)
    return np.ascontiguousarray(img)


def read_bmp(path: str) -> np.ndarray:
    """Uncompressed 24/32-bit BI_RGB Windows BMP -> (H,W,3) uint8 (the
    stb_image BMP subset that texture assets actually use)."""
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:2] != b"BM":
        raise ValueError("not a BMP file")
    off = int.from_bytes(data[10:14], "little")
    hdr_size = int.from_bytes(data[14:18], "little")
    if hdr_size < 40:
        raise ValueError("BMP core headers unsupported")
    w = int.from_bytes(data[18:22], "little", signed=True)
    h = int.from_bytes(data[22:26], "little", signed=True)
    bpp = int.from_bytes(data[28:30], "little")
    comp = int.from_bytes(data[30:34], "little")
    if comp not in (0, 3) or bpp not in (24, 32):
        raise ValueError(f"BMP bpp={bpp} compression={comp} unsupported")
    flip = h > 0          # positive height = bottom-up storage
    h = abs(h)
    nch = bpp // 8
    stride = (w * nch + 3) & ~3
    rows = np.frombuffer(data, np.uint8, stride * h, off)
    img = rows.reshape(h, stride)[:, :w * nch].reshape(h, w, nch)
    img = img[::-1] if flip else img
    # BGR(A) -> RGB
    return np.ascontiguousarray(img[..., 2::-1])


def read_tga(path: str) -> np.ndarray:
    """TGA type 2 (uncompressed true-color) and type 10 (RLE true-color)
    -> (H,W,3) uint8."""
    with open(path, "rb") as fh:
        data = fh.read()
    idlen, cmap_type, imgtype = data[0], data[1], data[2]
    if cmap_type != 0 or imgtype not in (2, 10):
        raise ValueError(f"TGA type {imgtype}/cmap {cmap_type} unsupported")
    w = int.from_bytes(data[12:14], "little")
    h = int.from_bytes(data[14:16], "little")
    bpp = data[16]
    desc = data[17]
    if bpp not in (24, 32):
        raise ValueError(f"TGA bpp={bpp} unsupported")
    nch = bpp // 8
    pos = 18 + idlen
    if imgtype == 2:
        px = np.frombuffer(data, np.uint8, w * h * nch, pos)
    else:                 # RLE
        out = bytearray()
        need = w * h * nch
        while len(out) < need:
            hdrb = data[pos]
            pos += 1
            cnt = (hdrb & 0x7F) + 1
            if hdrb & 0x80:           # run packet
                out += data[pos:pos + nch] * cnt
                pos += nch
            else:                     # raw packet
                out += data[pos:pos + nch * cnt]
                pos += nch * cnt
        px = np.frombuffer(bytes(out), np.uint8, need)
    img = px.reshape(h, w, nch)
    if not (desc & 0x20):             # bit 5 clear = bottom-up
        img = img[::-1]
    return np.ascontiguousarray(img[..., 2::-1])  # BGR(A) -> RGB


def read_pnm(path: str) -> np.ndarray:
    """Netpbm P2/P3 (ASCII) and P5/P6 (binary) gray/color images ->
    (H,W,3) uint8.  stb_image covers binary P5/P6 (inc/stb_image.h pnm);
    the ASCII forms are included because tiny hand-written test assets
    commonly use them.  maxval up to 65535 is rescaled to 8-bit."""
    with open(path, "rb") as fh:
        data = fh.read()
    magic = data[:2]
    if magic not in (b"P2", b"P3", b"P5", b"P6"):
        raise ValueError(f"PNM magic {magic!r} unsupported")
    # tokenize header (comments start with '#', run to end of line)
    tokens, pos = [], 2
    while len(tokens) < 3:
        while pos < len(data) and data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":
            while pos < len(data) and data[pos] != 0x0A:
                pos += 1
            continue
        start = pos
        while pos < len(data) and not data[pos:pos + 1].isspace():
            pos += 1
        tokens.append(data[start:pos])
    pos += 1                               # single whitespace after maxval
    w, h, maxval = int(tokens[0]), int(tokens[1]), int(tokens[2])
    nch = 3 if magic in (b"P3", b"P6") else 1
    count = w * h * nch
    if magic in (b"P2", b"P3"):
        vals = np.array(data[pos:].split()[:count], dtype=np.int64)
        if vals.size != count:
            raise ValueError("truncated ASCII PNM")
    elif maxval > 255:
        vals = np.frombuffer(data, ">u2", count, pos).astype(np.int64)
    else:
        vals = np.frombuffer(data, np.uint8, count, pos).astype(np.int64)
    img = ((vals * 255 + maxval // 2) // maxval).astype(np.uint8)
    img = img.reshape(h, w, nch)
    if nch == 1:
        img = np.repeat(img, 3, axis=2)
    return np.ascontiguousarray(img)


def read_hdr(path: str) -> np.ndarray:
    """Radiance RGBE (.hdr) -> (H,W,3) float32 linear radiance.

    Decodes both the adaptive-RLE "new" scanline format and flat RGBE
    (stb_image's .hdr coverage, inc/stb_image.h radiance loader).  Used
    both for texture loading (tone-mapped to 8-bit in load_image_rgb8,
    stb's ldr conversion: pow(f, 1/2.2)*255) and directly for HDR
    environment-map skies."""
    with open(path, "rb") as fh:
        data = fh.read()
    if not (data.startswith(b"#?RADIANCE") or data.startswith(b"#?RGBE")):
        raise ValueError("not a Radiance HDR file")
    # header: lines until the blank line; then the resolution line
    pos = data.index(b"\n") + 1
    while True:
        end = data.index(b"\n", pos)
        line = data[pos:end]
        pos = end + 1
        if line == b"":
            break
        if line.startswith(b"FORMAT=") and b"32-bit_rle_rgbe" not in line:
            raise ValueError(f"HDR format {line!r} unsupported")
    end = data.index(b"\n", pos)
    res = data[pos:end].split()
    pos = end + 1
    if len(res) != 4 or res[0] != b"-Y" or res[2] != b"+X":
        raise ValueError(f"HDR resolution line {res!r} unsupported")
    h, w = int(res[1]), int(res[3])

    rgbe = np.zeros((h, w, 4), np.uint8)
    buf = memoryview(data)
    for y in range(h):
        if (8 <= w < 32768 and buf[pos] == 2 and buf[pos + 1] == 2
                and (buf[pos + 2] << 8 | buf[pos + 3]) == w):
            pos += 4                     # adaptive RLE, per-component
            for c in range(4):
                x = 0
                while x < w:
                    cnt = buf[pos]
                    pos += 1
                    if cnt > 128:        # run of the next byte
                        rgbe[y, x:x + cnt - 128, c] = buf[pos]
                        x += cnt - 128
                        pos += 1
                    else:                # cnt literal bytes
                        rgbe[y, x:x + cnt, c] = np.frombuffer(
                            buf, np.uint8, cnt, pos)
                        x += cnt
                        pos += cnt
        else:                            # flat RGBE (with old-style runs)
            x = 0
            while x < w:
                px = np.frombuffer(buf, np.uint8, 4, pos)
                pos += 4
                if px[0] == 1 and px[1] == 1 and px[2] == 1:
                    n = int(px[3])       # old run: repeat previous pixel
                    rgbe[y, x:x + n] = rgbe[y, x - 1]
                    x += n
                else:
                    rgbe[y, x] = px
                    x += 1
    f = rgbe.astype(np.float32)
    scale = np.ldexp(np.float32(1.0), rgbe[..., 3].astype(np.int32) - 136)
    out = f[..., :3] * scale[..., None]
    out[rgbe[..., 3] == 0] = 0.0
    return out


def read_gif(path: str) -> np.ndarray:
    """GIF87a/89a first frame -> (H,W,3) uint8 (LZW decode, global/local
    color tables, interlace; the stb_image single-frame GIF behavior)."""
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:6] not in (b"GIF87a", b"GIF89a"):
        raise ValueError("not a GIF file")
    sw = int.from_bytes(data[6:8], "little")
    sh = int.from_bytes(data[8:10], "little")
    flags = data[10]
    bg_idx = data[11]
    pos = 13
    gct = None
    if flags & 0x80:
        n = 2 << (flags & 7)
        gct = np.frombuffer(data, np.uint8, n * 3, pos).reshape(n, 3)
        pos += n * 3
    transparent = -1
    while pos < len(data):
        b = data[pos]
        pos += 1
        if b == 0x3B:                     # trailer
            break
        if b == 0x21:                     # extension
            label = data[pos]
            pos += 1
            if label == 0xF9:             # graphic control
                blk = data[pos + 1:pos + 1 + data[pos]]
                if blk[0] & 1:
                    transparent = blk[3]
            while data[pos] != 0:         # skip sub-blocks
                pos += 1 + data[pos]
            pos += 1
            continue
        if b != 0x2C:
            raise ValueError(f"unexpected GIF block 0x{b:02x}")
        # image descriptor
        ix = int.from_bytes(data[pos:pos + 2], "little")
        iy = int.from_bytes(data[pos + 2:pos + 4], "little")
        iw = int.from_bytes(data[pos + 4:pos + 6], "little")
        ih = int.from_bytes(data[pos + 6:pos + 8], "little")
        lflags = data[pos + 8]
        pos += 9
        table = gct
        if lflags & 0x80:
            n = 2 << (lflags & 7)
            table = np.frombuffer(data, np.uint8, n * 3, pos).reshape(n, 3)
            pos += n * 3
        if table is None:
            raise ValueError("GIF image with no color table")
        min_code = data[pos]
        pos += 1
        stream = bytearray()
        while data[pos] != 0:
            stream += data[pos + 1:pos + 1 + data[pos]]
            pos += 1 + data[pos]
        pos += 1
        # LZW decode
        clear, eoi = 1 << min_code, (1 << min_code) + 1
        codes: list[bytes] = [bytes([i]) for i in range(clear)] + [b"", b""]
        width = min_code + 1
        acc = nbits = 0
        out = bytearray()
        prev = None
        for byte in stream:
            acc |= byte << nbits
            nbits += 8
            while nbits >= width:
                code = acc & ((1 << width) - 1)
                acc >>= width
                nbits -= width
                if code == clear:
                    codes = codes[:clear + 2]
                    width = min_code + 1
                    prev = None
                    continue
                if code == eoi:
                    nbits = 0
                    acc = 0
                    break
                if prev is None:
                    entry = codes[code]
                elif code < len(codes):
                    entry = codes[code]
                    codes.append(prev + entry[:1])
                else:                     # KwKwK case
                    entry = prev + prev[:1]
                    codes.append(entry)
                out += entry
                prev = entry
                if len(codes) == (1 << width) and width < 12:
                    width += 1
        idx = np.frombuffer(bytes(out[:iw * ih]), np.uint8).reshape(ih, iw)
        if lflags & 0x40:                 # interlaced rows
            deinter = np.empty_like(idx)
            order = np.concatenate([np.arange(0, ih, 8),
                                    np.arange(4, ih, 8),
                                    np.arange(2, ih, 4),
                                    np.arange(1, ih, 2)])
            deinter[order] = idx
            idx = deinter
        frame = table[np.minimum(idx, len(table) - 1)]
        canvas = np.zeros((sh, sw, 3), np.uint8)
        if gct is not None:
            canvas[:] = gct[min(bg_idx, len(gct) - 1)]
        if transparent >= 0:
            mask = idx != transparent
            canvas[iy:iy + ih, ix:ix + iw][mask] = frame[mask]
        else:
            canvas[iy:iy + ih, ix:ix + iw] = frame
        return canvas                     # first frame only
    raise ValueError("GIF contains no image data")


def read_psd(path: str) -> np.ndarray:
    """Photoshop PSD composited image -> (H,W,3) uint8 (raw or PackBits-
    RLE planar data, 8/16-bit channels; the stb_image PSD subset)."""
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:4] != b"8BPS" or int.from_bytes(data[4:6], "big") != 1:
        raise ValueError("not a PSD (v1) file")
    nch = int.from_bytes(data[12:14], "big")
    h = int.from_bytes(data[14:18], "big")
    w = int.from_bytes(data[18:22], "big")
    depth = int.from_bytes(data[22:24], "big")
    if depth not in (8, 16):
        raise ValueError(f"PSD depth {depth} unsupported")
    pos = 26
    for _ in range(3):                    # color mode / resources / layers
        ln = int.from_bytes(data[pos:pos + 4], "big")
        pos += 4 + ln
    comp = int.from_bytes(data[pos:pos + 2], "big")
    pos += 2
    if comp == 0:                         # raw planar
        bpc = depth // 8
        count = nch * h * w
        dt = ">u2" if depth == 16 else np.uint8
        plane = np.frombuffer(data, dt, count, pos).astype(np.uint16)
        if depth == 16:
            plane = plane >> 8
        img = plane.reshape(nch, h, w).astype(np.uint8)
    elif comp == 1:                       # PackBits RLE (8-bit only)
        pos += nch * h * 2                # per-row byte-count table
        out = bytearray()
        need = nch * h * w
        while len(out) < need:
            n = data[pos]
            pos += 1
            if n < 128:                   # n+1 literal bytes
                out += data[pos:pos + n + 1]
                pos += n + 1
            elif n > 128:                 # repeat next byte 257-n times
                out += data[pos:pos + 1] * (257 - n)
                pos += 1
        img = np.frombuffer(bytes(out), np.uint8, need).reshape(nch, h, w)
    else:
        raise ValueError(f"PSD compression {comp} unsupported")
    if nch >= 3:
        return np.ascontiguousarray(img[:3].transpose(1, 2, 0))
    return np.repeat(img[0][..., None], 3, axis=2)


def read_pic(path: str) -> np.ndarray:
    """Softimage PIC -> (H,W,3) uint8 (the stb_image PIC subset,
    inc/stb_image.h stbi__pic_load: chained packet headers, packet types
    0 = uncompressed, 1 = pure RLE, 2 = mixed RLE; channel masks 0x80/
    0x40/0x20/0x10 = R/G/B/A).  Alpha is decoded then dropped (force-RGB,
    matching the builder's stbi_load(..., STBI_rgb))."""
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:4] != b"\x53\x80\xf6\x34" or data[88:92] != b"PICT":
        raise ValueError("not a Softimage PIC file")
    # header: magic(4) version(4) comment(80) 'PICT' w(2be) h(2be)
    # ratio(4) fields(2) pad(2), then the chained packet headers
    w = int.from_bytes(data[92:94], "big")
    h = int.from_bytes(data[94:96], "big")
    pos = 104
    packets = []
    chained = 1
    while chained:
        if len(packets) > 10:
            raise ValueError("PIC packet chain too long")
        chained, _size, ptype, channel = data[pos:pos + 4]
        packets.append((ptype, channel))
        pos += 4
    img = np.zeros((h, w, 4), np.uint8)
    chan_idx = {0x80: 0, 0x40: 1, 0x20: 2, 0x10: 3}

    def readval(channel, pos):
        """One pixel's bytes for the channels in the mask (MSB first)."""
        vals = []
        for mask in (0x80, 0x40, 0x20, 0x10):
            if channel & mask:
                vals.append(data[pos])
                pos += 1
        return vals, pos

    for y in range(h):
        for ptype, channel in packets:
            idxs = [chan_idx[m] for m in (0x80, 0x40, 0x20, 0x10)
                    if channel & m]
            if ptype == 0:                # uncompressed
                for x in range(w):
                    vals, pos = readval(channel, pos)
                    img[y, x, idxs] = vals
            elif ptype == 1:              # pure RLE
                left = 0
                x = 0
                while x < w:
                    count = data[pos]
                    pos += 1
                    count = min(count, w - x)
                    vals, pos = readval(channel, pos)
                    # slice+list mixed indexing puts the advanced axis
                    # first: result is (nch, count), so assign columns
                    img[y, x:x + count, idxs] = np.asarray(
                        vals, np.uint8)[:, None]
                    x += count
            elif ptype == 2:              # mixed RLE
                x = 0
                while x < w:
                    count = data[pos]
                    pos += 1
                    if count >= 128:      # run
                        if count == 128:
                            count = int.from_bytes(data[pos:pos + 2], "big")
                            pos += 2
                        else:
                            count -= 127
                        if count > w - x:
                            raise ValueError("PIC bad RLE run")
                        vals, pos = readval(channel, pos)
                        img[y, x:x + count, idxs] = np.asarray(
                            vals, np.uint8)[:, None]
                        x += count
                    else:                 # count+1 literal pixels
                        count += 1
                        if count > w - x:
                            raise ValueError("PIC bad RLE literals")
                        for _ in range(count):
                            vals, pos = readval(channel, pos)
                            img[y, x, idxs] = vals
                            x += 1
            else:
                raise ValueError(f"PIC packet type {ptype} unsupported")
    return np.ascontiguousarray(img[..., :3])


def hdr_to_ldr(hdr: np.ndarray, gamma: float = 2.2) -> np.ndarray:
    """stb's HDR->LDR conversion (scale 1, gamma 2.2): byte =
    clamp(pow(f, 1/gamma)*255+0.5)."""
    f = np.power(np.maximum(hdr.astype(np.float32), 0.0), 1.0 / gamma)
    return np.clip(f * 255.0 + 0.5, 0.0, 255.0).astype(np.uint8)


def load_image_rgb8(path: str) -> np.ndarray:
    """Decode any supported image to (H,W,3) uint8 (stbi_load force-RGB
    analogue, src/gpu_scene_builder.cpp:215).  Native decoders cover
    PNG (8/16-bit, Adam7 interlace), PPM, baseline+progressive JPEG,
    BMP (24/32-bit BI_RGB), TGA (types 2/10), GIF (first frame), PSD
    (composited raw/RLE), Softimage PIC, Radiance HDR (tone-mapped like
    stb's ldr conversion), and PNM — the stb_image format surface;
    anything else falls through to PIL when available."""
    lower = path.lower()
    if lower.endswith(".png"):
        try:
            return read_png(path)
        except Exception:
            pass  # fall through to PIL for exotic PNGs
    if lower.endswith((".ppm",)):
        return read_ppm(path)
    if lower.endswith((".jpg", ".jpeg")):
        # native baseline-JPEG decoder (stb_image analogue); progressive
        # or exotic files fall through to PIL
        from dsrt_tpu_torch.utils import jpeg
        try:
            return jpeg.read_jpeg(path)
        except jpeg.UnsupportedJPEG:
            pass
    if lower.endswith(".bmp"):
        try:
            return read_bmp(path)
        except ValueError:
            pass
    if lower.endswith(".tga"):
        try:
            return read_tga(path)
        except ValueError:
            pass
    if lower.endswith((".pnm", ".pgm")):
        try:
            return read_pnm(path)
        except ValueError:
            pass
    if lower.endswith(".hdr"):
        try:
            return hdr_to_ldr(read_hdr(path))
        except ValueError:
            pass
    if lower.endswith(".gif"):
        try:
            return read_gif(path)
        except ValueError:
            pass
    if lower.endswith(".psd"):
        try:
            return read_psd(path)
        except ValueError:
            pass
    if lower.endswith(".pic"):
        try:
            return read_pic(path)
        except ValueError:
            pass
    try:
        from PIL import Image  # optional
        with Image.open(path) as im:
            return np.asarray(im.convert("RGB"), np.uint8)
    except ImportError as e:
        raise IOError(f"cannot decode '{path}': PIL unavailable (native "
                      "decoders cover PNG/PPM/PNM/JPEG/BMP/TGA/GIF/PSD/"
                      "HDR)") from e
