"""The served path's host codec: run-length wires read back from the card
-> RGB tiles, or palette PNGs (PNG-8) straight from the v2 wire.

The port's own C++ (`csrc/wire_host.cpp`, plain g++, neither libdeflate
nor zlib.h) decodes the wire to palette-index rows and the tile's own
palette, or to RGB, and Up-filters the index rows; Python's `zlib`
deflates the stream and the chunks are written here.  Its PNG-8 has the
IHDR and PLTE of the JAX package's `png_writer.words_to_png_pal` and an
IDAT that inflates to the same bytes; only the deflate encoder differs.
Every host serves through it, with or without libdeflate.

RGB tiles (more than 256 colours, v1 and raw batches) are written by
`png_writer.rgb_to_png`.

There is no silent fallback: `library()` raises where the port's library
cannot be built or loaded, and a device service does not start.  The
numpy decoders (`ops/rle_layout.decode_words_numpy`, png_writer's numpy
loops) are the plain versions the tests hold this module to; the served
path never reaches them.
"""

from __future__ import annotations

import ctypes
import struct
import threading
import zlib
from typing import Optional, Tuple

import numpy as np

# The PNG writer the served path runs, as the server and the bench name it.
WRITER = "port (zlib)"

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_U8P = np.ctypeslib.ndpointer(dtype=np.uint8, flags="C_CONTIGUOUS")
_I32P = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")
# Entries of the v2 wire's palette table (ops/rle_layout.PAL_CAP): a
# palette run's index is below it, 255 is the literal escape.
_TABLE_ENTRIES = 255

_lib = None
_lock = threading.Lock()


def library():
    """The port's wire decoder (`csrc/wire_host.cpp`), built and bound on
    first use.  Raises when it cannot be built or loaded."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            from osm_renderer_tpu_torch.utils.torch_setup import host_lib_path

            lib = ctypes.CDLL(host_lib_path("wirehost"))
            lib.osmr_rle_decode_packed.argtypes = [
                _I32P, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, _U8P]
            lib.osmr_rle_decode_packed.restype = ctypes.c_int32
            lib.osmr_rle_decode_words.argtypes = [
                _I32P, ctypes.c_int64, ctypes.c_int32, _I32P, ctypes.c_int32, ctypes.c_int32,
                _U8P]
            lib.osmr_rle_decode_words.restype = ctypes.c_int32
            lib.osmr_rle_decode_words_idx.argtypes = [
                _I32P, ctypes.c_int64, ctypes.c_int32, _I32P, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_int32, _U8P, _I32P]
            lib.osmr_rle_decode_words_idx.restype = ctypes.c_int32
            lib.osmr_png8_filter_up.argtypes = [_U8P, ctypes.c_int32, ctypes.c_int32, _U8P]
            lib.osmr_png8_filter_up.restype = None
            _lib = lib
    return _lib


def _words_args(packed32, table):
    packed32 = np.ascontiguousarray(packed32, dtype=np.int32)
    table = np.ascontiguousarray(table, dtype=np.int32)
    if table.shape[0] < _TABLE_ENTRIES:
        raise ValueError(f"palette table of {table.shape[0]} entries, want {_TABLE_ENTRIES}")
    return packed32, table


def decode_packed(packed: np.ndarray, h: int, w: int) -> np.ndarray:
    """One tile's slice of the v1 wire ((len-1) << 24 | rgb int32s) ->
    (h, w, 3) u8.  Raises ValueError when its runs do not cover the tile."""
    packed = np.ascontiguousarray(packed, dtype=np.int32)
    out = np.empty((h, w, 3), np.uint8)
    if not library().osmr_rle_decode_packed(packed, packed.shape[0], h, w, out):
        raise ValueError("packed RLE runs do not cover the tile")
    return out


def decode_words(packed32: np.ndarray, word_off: int, n_words: int, table: np.ndarray,
                 h: int, w: int) -> np.ndarray:
    """One tile's slice of the v2 wire (its `n_words` 16-bit words from
    `word_off`) -> (h, w, 3) u8.  Raises ValueError when its runs do not
    cover the tile or its words end inside a literal."""
    packed32, table = _words_args(packed32, table)
    out = np.empty((h, w, 3), np.uint8)
    if not library().osmr_rle_decode_words(packed32, int(word_off), int(n_words), table,
                                            h, w, out):
        raise ValueError("indexed RLE words do not cover the tile")
    return out


def decode_words_idx(packed32: np.ndarray, word_off: int, n_words: int, table: np.ndarray,
                     h: int, w: int) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """One tile's slice of the v2 wire -> ((h, w) u8 palette-index rows,
    its palette as 0x00RRGGBB int32s in order of first use), or None when
    the tile uses more than 256 colours or the wire is short."""
    packed32, table = _words_args(packed32, table)
    idx = np.empty((h, w), np.uint8)
    plte = np.zeros(256, np.int32)
    n_pal = library().osmr_rle_decode_words_idx(
        packed32, int(word_off), int(n_words), table, table.shape[0], h, w, idx, plte)
    if not n_pal:
        return None
    return idx, plte[:n_pal]


def _chunk(tag: bytes, payload: bytes) -> bytes:
    crc = zlib.crc32(payload, zlib.crc32(tag)) & 0xFFFFFFFF
    return struct.pack(">I", len(payload)) + tag + payload + struct.pack(">I", crc)


def words_to_png_pal(packed32: np.ndarray, word_off: int, n_words: int, table: np.ndarray,
                     h: int, w: int, compress_level: int = 6) -> Optional[bytes]:
    """One tile's slice of the v2 wire -> palette PNG (colour type 3,
    8 bits) bytes, or None when the tile needs the RGB path (more than 256
    colours, or a short wire).  The contract of
    `png_writer.words_to_png_pal`."""
    got = decode_words_idx(packed32, word_off, n_words, table, h, w)
    if got is None:
        return None
    idx, plte = got
    raw = np.empty(h * (w + 1), np.uint8)
    library().osmr_png8_filter_up(idx, h, w, raw)
    rgb = plte.astype(">u4").view(np.uint8).reshape(-1, 4)[:, 1:]
    return (_PNG_SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 3, 0, 0, 0))
            + _chunk(b"PLTE", rgb.tobytes())
            + _chunk(b"IDAT", zlib.compress(raw, compress_level))
            + _chunk(b"IEND", b""))
