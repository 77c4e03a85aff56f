"""In-memory PNG encoding (reference: `png_writer.rs`).

Two paths, both RGB8 like the reference's output:

* native (`native/pngenc.cpp`, libdeflate) — the serving turbo path;
  at >1000 tiles/s/chip the encoder otherwise bottlenecks the server;
* pure-Python chunk assembly over zlib — fallback when the native
  library can't build.
"""

from __future__ import annotations

import ctypes
import struct
import threading
import zlib
from typing import Optional

import numpy as np

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"

_U8P = np.ctypeslib.ndpointer(dtype=np.uint8, flags="C_CONTIGUOUS")
_I32P = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")
_F64P = np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS")

_native = None
_native_failed = False
_native_lock = threading.Lock()


def _get_native():
    """The libdeflate encoder, or None if it can't be built here."""
    global _native, _native_failed
    if _native is not None or _native_failed:
        return _native
    with _native_lock:
        if _native is not None or _native_failed:
            return _native
        try:
            from osm_renderer_tpu_torch.utils.torch_setup import host_lib_path

            lib = ctypes.CDLL(host_lib_path("pngenc"))
            lib.osmr_png_encode.argtypes = [
                _U8P, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_char_p, ctypes.c_size_t,
            ]
            lib.osmr_png_encode.restype = ctypes.c_size_t
            lib.osmr_rle_decode.argtypes = [
                _I32P, _I32P, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_int32, _U8P,
            ]
            lib.osmr_rle_decode.restype = ctypes.c_int32
            lib.osmr_rle_decode_packed.argtypes = [
                _I32P, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, _U8P,
            ]
            lib.osmr_rle_decode_packed.restype = ctypes.c_int32
            lib.osmr_rle_decode_words.argtypes = [
                _I32P, ctypes.c_int64, ctypes.c_int32, _I32P,
                ctypes.c_int32, ctypes.c_int32, _U8P,
            ]
            lib.osmr_rle_decode_words.restype = ctypes.c_int32
            lib.osmr_rle_decode_words_idx.argtypes = [
                _I32P, ctypes.c_int64, ctypes.c_int32, _I32P,
                ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, _U8P, _I32P,
            ]
            lib.osmr_rle_decode_words_idx.restype = ctypes.c_int32
            lib.osmr_png_encode_pal.argtypes = [
                _U8P, ctypes.c_int32, ctypes.c_int32, _I32P, ctypes.c_int32,
                ctypes.c_int32, ctypes.c_char_p, ctypes.c_size_t,
            ]
            lib.osmr_png_encode_pal.restype = ctypes.c_size_t
            lib.osmr_label_composite.argtypes = [
                _U8P, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_int32, ctypes.c_int32, _F64P, _F64P,
            ]
            lib.osmr_label_composite.restype = None
            _native = lib
        except Exception:
            _native_failed = True
    return _native


def _chunk(tag: bytes, payload: bytes) -> bytes:
    return (
        struct.pack(">I", len(payload))
        + tag
        + payload
        + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)
    )


def rle_decode(
    vals: np.ndarray, lens: np.ndarray, n_runs: int, h: int, w: int
) -> np.ndarray:
    """Device RLE (ops/rle.py) -> (h, w, 3) uint8.  Native C++ loop when
    available, numpy fallback otherwise."""
    vals = np.ascontiguousarray(vals[:n_runs], dtype=np.int32)
    lens = np.ascontiguousarray(lens[:n_runs], dtype=np.int32)
    lib = _get_native()
    if lib is not None:
        out = np.empty((h, w, 3), np.uint8)
        if lib.osmr_rle_decode(vals, lens, int(n_runs), h, w, out):
            return out
        raise ValueError("RLE runs do not cover the tile")
    lengths = lens.astype(np.int64) + 1
    if lengths.sum() != h * w:
        raise ValueError("RLE runs do not cover the tile")
    flat = np.repeat(vals, lengths)
    out = np.empty((h * w, 3), np.uint8)
    out[:, 0] = (flat >> 16) & 0xFF
    out[:, 1] = (flat >> 8) & 0xFF
    out[:, 2] = flat & 0xFF
    return out.reshape(h, w, 3)


def rle_decode_packed(packed: np.ndarray, h: int, w: int) -> np.ndarray:
    """One tile's slice of the batch-wide packed run stream
    ((len-1)<<24 | rgb int32s, ops/rle.py encode_batch) -> (h, w, 3) u8."""
    packed = np.ascontiguousarray(packed, dtype=np.int32)
    lib = _get_native()
    if lib is not None:
        out = np.empty((h, w, 3), np.uint8)
        if lib.osmr_rle_decode_packed(packed, packed.shape[0], h, w, out):
            return out
        raise ValueError("packed RLE runs do not cover the tile")
    lens = ((packed >> 24) & 0xFF).astype(np.int64) + 1
    if lens.sum() != h * w:
        raise ValueError("packed RLE runs do not cover the tile")
    flat = np.repeat(packed & 0xFFFFFF, lens)
    out = np.empty((h * w, 3), np.uint8)
    out[:, 0] = (flat >> 16) & 0xFF
    out[:, 1] = (flat >> 8) & 0xFF
    out[:, 2] = flat & 0xFF
    return out.reshape(h, w, 3)


def rle_decode_words(
    packed32: np.ndarray, word_off: int, n_words: int, table: np.ndarray,
    h: int, w: int,
) -> np.ndarray:
    """One tile's slice of the indexed 16-bit-word wire (ops/rle.py
    encode_batch_words) -> (h, w, 3) u8.  Native C++ loop when
    available; numpy fallback via the reference decoder."""
    packed32 = np.ascontiguousarray(packed32, dtype=np.int32)
    table = np.ascontiguousarray(table, dtype=np.int32)
    lib = _get_native()
    if lib is not None:
        out = np.empty((h, w, 3), np.uint8)
        if lib.osmr_rle_decode_words(
            packed32, int(word_off), int(n_words), table, h, w, out
        ):
            return out
        raise ValueError("indexed RLE words do not cover the tile")
    # numpy fallback: expand this tile's words scalar-wise.
    w16 = np.empty(2 * packed32.shape[0], np.int64)
    w16[0::2] = packed32 & 0xFFFF
    w16[1::2] = (packed32 >> 16) & 0xFFFF
    words = w16[word_off : word_off + n_words]
    flat = np.empty(h * w, np.int64)
    fp = 0
    i = 0
    while i < n_words:
        hdr = int(words[i])
        pidx = hdr >> 8
        ln = (hdr & 0xFF) + 1
        if pidx == 0xFF:
            val = int(words[i + 1]) | ((int(words[i + 2]) & 0xFF) << 16)
            i += 3
        else:
            val = int(table[pidx])
            i += 1
        flat[fp : fp + ln] = val
        fp += ln
    if fp != h * w:
        raise ValueError("indexed RLE words do not cover the tile")
    out = np.empty((h * w, 3), np.uint8)
    out[:, 0] = (flat >> 16) & 0xFF
    out[:, 1] = (flat >> 8) & 0xFF
    out[:, 2] = flat & 0xFF
    return out.reshape(h, w, 3)


def rle_to_png(
    vals: np.ndarray, lens: np.ndarray, n_runs: int, h: int, w: int,
    compress_level: int = 6,
) -> bytes:
    """Device RLE -> PNG bytes (decode + encode, both native when built)."""
    return rgb_to_png(rle_decode(vals, lens, n_runs, h, w), compress_level)


def words_to_png_pal(
    packed32: np.ndarray, word_off: int, n_words: int, table: np.ndarray,
    h: int, w: int, compress_level: int = 6,
) -> Optional[bytes]:
    """One tile's slice of the indexed wire -> palette (PNG-8) bytes,
    decoding STRAIGHT to index rows — the serving wire's adaptive
    <= 255-color palette is exactly a PLTE (the reference's encoder
    role, png_writer.rs:4-21, at 1/3 the raw stream).  Returns None
    when the tile needs the RGB path (palette overflow after literal
    extension, or no native library) — pixels are lossless either way
    (tests/test_rle.py decodes and compares)."""
    lib = _get_native()
    if lib is None:
        return None
    packed32 = np.ascontiguousarray(packed32, dtype=np.int32)
    table = np.ascontiguousarray(table, dtype=np.int32)
    idx = np.empty((h, w), np.uint8)
    plte = np.zeros(256, np.int32)
    n_pal = lib.osmr_rle_decode_words_idx(
        packed32, int(word_off), int(n_words), table, table.shape[0],
        h, w, idx, plte,
    )
    if not n_pal:
        return None
    buf = ctypes.create_string_buffer(h * w + 4096)
    n = lib.osmr_png_encode_pal(
        idx, h, w, plte, int(n_pal), compress_level, buf, len(buf)
    )
    if not n:
        return None
    return buf.raw[:n]


def rgb_to_png(rgb: np.ndarray, compress_level: int = 6) -> bytes:
    """rgb: (H, W, 3) uint8 -> PNG bytes."""
    h, w = rgb.shape[:2]
    lib = _get_native()
    if lib is not None:
        buf = ctypes.create_string_buffer(h * w * 3 + 4096)
        rgb_c = np.ascontiguousarray(rgb, dtype=np.uint8)
        n = lib.osmr_png_encode(rgb_c, h, w, compress_level, buf, len(buf))
        if n:
            return buf.raw[:n]
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    # Filter byte 0 (None) per scanline.
    raw = np.empty((h, w * 3 + 1), dtype=np.uint8)
    raw[:, 0] = 0
    raw[:, 1:] = rgb.reshape(h, w * 3)
    idat = zlib.compress(raw.tobytes(), compress_level)
    return (
        _PNG_SIGNATURE
        + _chunk(b"IHDR", ihdr)
        + _chunk(b"IDAT", idat)
        + _chunk(b"IEND", b"")
    )
