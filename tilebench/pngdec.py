"""PNG for the comparison, standard library zlib and numpy only.

`decode` reads what the server sends: 8-bit truecolour (colour type 2)
and 8-bit palette (colour type 3) images, not interlaced, with any of
the five row filters.  Anything else raises, so a malformed answer is
never judged as pixels.  `encode` writes the truecolour PNG that the
control serves in the program's place.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    data = np.frombuffer(raw, np.uint8)
    if data.size != h * (stride + 1):
        raise ValueError(f"PNG data has {data.size} bytes, want {h * (stride + 1)}")
    rows = data.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for r in range(h):
        f, line = rows[r, 0], rows[r, 1:].astype(np.int32)
        if f == 0:
            cur = line
        elif f == 2:
            cur = (line + prev) & 0xFF
        elif f in (1, 3, 4):
            cur = np.zeros(stride, np.int32)
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                b = prev[i]
                if f == 1:
                    p = a
                elif f == 3:
                    p = (a + b) >> 1
                else:
                    c = prev[i - bpp] if i >= bpp else 0
                    pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                    p = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                cur[i] = (line[i] + p) & 0xFF
        else:
            raise ValueError(f"PNG row filter {f}")
        out[r] = cur
        prev = cur
    return out


def decode(png: bytes) -> np.ndarray:
    """PNG bytes -> (h, w, 3) u8 RGB; raises ValueError on anything this
    decoder does not read."""
    if png[:8] != SIGNATURE:
        raise ValueError("not a PNG")
    pos, idat, plte, ihdr = 8, [], None, None
    while pos < len(png):
        n, ctype = struct.unpack(">I4s", png[pos:pos + 8])
        body = png[pos + 8:pos + 8 + n]
        pos += 12 + n
        if ctype == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif ctype == b"PLTE":
            plte = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
    if ihdr is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, color, _, _, interlace = ihdr
    if depth != 8 or interlace or color not in (2, 3):
        raise ValueError(f"PNG depth {depth}, colour type {color}, interlace {interlace}")
    bpp = 3 if color == 2 else 1
    px = _unfilter(zlib.decompress(b"".join(idat)), h, w * bpp, bpp)
    if color == 2:
        return px.reshape(h, w, 3)
    if plte is None:
        raise ValueError("palette PNG without PLTE")
    if int(px.max(initial=0)) >= plte.shape[0]:
        raise ValueError("palette index out of range")
    return plte[px]


def _chunk(ctype: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + ctype + body
            + struct.pack(">I", zlib.crc32(ctype + body) & 0xFFFFFFFF))


def encode(rgb: np.ndarray) -> bytes:
    """(h, w, 3) u8 RGB -> PNG bytes (colour type 2, filter 0 on every row)."""
    h, w, _ = rgb.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           np.ascontiguousarray(rgb, np.uint8).reshape(h, 3 * w)], axis=1)
    return (SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 1)) + _chunk(b"IEND", b""))
