"""Minimal PNG write/read (pure Python: zlib + struct; counterpart of
``tpurt/io/image.py``).

Replaces the reference's stb_image_write screenshot path [RECALL]. Only what
the renderer and golden-image tests need: 8-bit RGB(A), no interlacing.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_PNG_SIG = b"\x89PNG\r\n\x1a\n"


def _chunk(tag: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + tag + payload
            + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))


def to_uint8(img: np.ndarray) -> np.ndarray:
    """Linear [0,1] float -> sRGB-ish gamma-2.2 uint8."""
    img = np.clip(np.asarray(img, np.float32), 0.0, 1.0)
    return (np.power(img, 1.0 / 2.2) * 255.0 + 0.5).astype(np.uint8)


def write_png(path: str, img: np.ndarray, gamma: bool = True) -> None:
    """img: [H, W, 3|4] float in [0,1] (gamma-encoded on write) or uint8."""
    if img.dtype != np.uint8:
        img = to_uint8(img) if gamma else (np.clip(img, 0, 1) * 255 + 0.5).astype(np.uint8)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    h, w, ch = img.shape
    color_type = {3: 2, 4: 6}[ch]
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))
    with open(path, "wb") as f:
        f.write(_PNG_SIG)
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(_chunk(b"IEND", b""))


def read_png(path: str) -> np.ndarray:
    """Read an 8-bit non-interlaced RGB/RGBA/gray PNG back to uint8 [H,W,C]."""
    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == _PNG_SIG, "not a PNG"
    pos = 8
    idat = b""
    w = h = None
    color_type = None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + length]
        if tag == b"IHDR":
            w, h, bits, color_type, comp, filt, interlace = struct.unpack(">IIBBBBB", payload)
            assert bits == 8 and interlace == 0, "unsupported PNG variant"
        elif tag == b"IDAT":
            idat += payload
        elif tag == b"IEND":
            break
        pos += 12 + length
    ch = {0: 1, 2: 3, 6: 4}[color_type]
    raw = zlib.decompress(idat)
    stride = w * ch
    img = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    ptr = 0
    for y in range(h):
        ftype = raw[ptr]
        line = np.frombuffer(raw[ptr + 1:ptr + 1 + stride], np.uint8).copy()
        ptr += 1 + stride
        if ftype == 0:
            pass
        elif ftype == 1:  # Sub
            for x in range(ch, stride):
                line[x] = (line[x] + line[x - ch]) & 0xFF
        elif ftype == 2:  # Up
            line = (line.astype(np.int32) + prev).astype(np.uint8)
        elif ftype == 3:  # Average
            for x in range(stride):
                left = int(line[x - ch]) if x >= ch else 0
                line[x] = (line[x] + ((left + int(prev[x])) >> 1)) & 0xFF
        elif ftype == 4:  # Paeth
            for x in range(stride):
                a = int(line[x - ch]) if x >= ch else 0
                b = int(prev[x])
                c = int(prev[x - ch]) if x >= ch else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pr = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                line[x] = (line[x] + pr) & 0xFF
        else:
            raise ValueError(f"bad filter {ftype}")
        img[y] = line
        prev = img[y]
    return img.reshape(h, w, ch)
