"""ctypes bindings to the native CPU oracle rasterizer (native/oracle.cpp).

The oracle implements the reference renderer's exact per-tile draw
semantics and serves as (a) the pixel-parity ground truth for the
JAX/Pallas device kernels and (b) the host-side CPU fallback path.
The shared library is built on first use, for the port alone
(`utils.torch_setup.host_lib_path`).
"""

from __future__ import annotations

import ctypes
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np


_lib = None
_lib_lock = threading.Lock()

LINE_CAP_BUTT = 0
LINE_CAP_ROUND = 1
LINE_CAP_SQUARE = 2

_I32P = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")
_F64P = np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS")
_U8P = np.ctypeslib.ndpointer(dtype=np.uint8, flags="C_CONTIGUOUS")


def _get_lib():
    global _lib
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        from osm_renderer_tpu_torch.utils.torch_setup import host_lib_path

        lib = ctypes.CDLL(host_lib_path("oracle"))

        lib.osmr_tile_new.restype = ctypes.c_void_p
        lib.osmr_tile_new.argtypes = [ctypes.c_size_t]
        lib.osmr_tile_free.argtypes = [ctypes.c_void_p]
        lib.osmr_tile_reset.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_uint8, ctypes.c_uint8, ctypes.c_uint8,
        ]
        lib.osmr_tile_bump_generation.argtypes = [ctypes.c_void_p]
        lib.osmr_tile_bump_label_generation.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.osmr_tile_blend_unfinished.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.osmr_tile_to_rgb.argtypes = [ctypes.c_void_p, _U8P]
        lib.osmr_tile_export_label_layer.argtypes = [ctypes.c_void_p, _F64P]
        lib.osmr_fill_contour_color.argtypes = [
            ctypes.c_void_p, _I32P, ctypes.c_size_t,
            ctypes.c_uint8, ctypes.c_uint8, ctypes.c_uint8, ctypes.c_double,
        ]
        lib.osmr_fill_contour_icon.argtypes = [
            ctypes.c_void_p, _I32P, ctypes.c_size_t, _F64P, ctypes.c_size_t, ctypes.c_size_t,
        ]
        lib.osmr_draw_lines.argtypes = [
            ctypes.c_void_p, _I32P, ctypes.c_size_t, ctypes.c_double,
            ctypes.c_uint8, ctypes.c_uint8, ctypes.c_uint8, ctypes.c_double,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ]
        lib.osmr_label_icon.restype = ctypes.c_int
        lib.osmr_label_icon.argtypes = [
            ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_size_t, ctypes.c_size_t, _F64P,
        ]
        lib.osmr_glyph_rasterizer_new.restype = ctypes.c_void_p
        lib.osmr_glyph_rasterizer_new.argtypes = [ctypes.c_uint8, ctypes.c_uint8, ctypes.c_uint8]
        lib.osmr_glyph_rasterizer_free.argtypes = [ctypes.c_void_p]
        lib.osmr_glyph_draw_line.argtypes = [ctypes.c_void_p] + [ctypes.c_double] * 4
        lib.osmr_glyph_draw_quad.argtypes = [ctypes.c_void_p] + [ctypes.c_double] * 6
        lib.osmr_glyph_draw_path.argtypes = [ctypes.c_void_p, _F64P, ctypes.c_size_t]
        lib.osmr_glyph_save.restype = ctypes.c_int
        lib.osmr_glyph_save.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.osmr_glyph_bounds.restype = ctypes.c_int
        lib.osmr_glyph_bounds.argtypes = [ctypes.c_void_p, _I32P]
        lib.osmr_glyph_export.argtypes = [
            ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_size_t, ctypes.c_size_t, _F64P,
        ]

        _lib = lib
    return _lib


class OracleTile:
    """One reusable tile pixel buffer (mirror of `TilePixels`)."""

    def __init__(self, scale: int = 1):
        self._lib = _get_lib()
        self.scale = scale
        self.dimension = 256 * scale
        self._handle = self._lib.osmr_tile_new(scale)

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.osmr_tile_free(self._handle)
            self._handle = None

    def reset(self, canvas_color: Optional[Tuple[int, int, int]] = None) -> None:
        if canvas_color is None:
            self._lib.osmr_tile_reset(self._handle, 0, 0, 0, 0)
        else:
            r, g, b = canvas_color
            self._lib.osmr_tile_reset(self._handle, 1, r, g, b)

    def bump_generation(self) -> None:
        self._lib.osmr_tile_bump_generation(self._handle)

    def bump_label_generation(self, succeeded: bool) -> None:
        self._lib.osmr_tile_bump_label_generation(self._handle, int(succeeded))

    def blend_unfinished(self, for_labels: bool) -> None:
        self._lib.osmr_tile_blend_unfinished(self._handle, int(for_labels))

    def fill_contour(
        self, edges: np.ndarray, color: Tuple[int, int, int], opacity: float
    ) -> None:
        """edges: int32 (N, 4) array of (x1, y1, x2, y2) point pairs."""
        edges = np.ascontiguousarray(edges, dtype=np.int32)
        r, g, b = color
        self._lib.osmr_fill_contour_color(
            self._handle, edges, edges.shape[0], r, g, b, float(opacity)
        )

    def fill_contour_icon(self, edges: np.ndarray, icon_rgba: np.ndarray) -> None:
        """icon_rgba: float64 (H, W, 4) premultiplied RGBA."""
        edges = np.ascontiguousarray(edges, dtype=np.int32)
        icon = np.ascontiguousarray(icon_rgba, dtype=np.float64)
        h, w = icon.shape[:2]
        self._lib.osmr_fill_contour_icon(self._handle, edges, edges.shape[0], icon.reshape(-1), w, h)

    def draw_lines(
        self,
        pairs: np.ndarray,
        width: float,
        color: Tuple[int, int, int],
        opacity: float,
        dashes: Optional[Sequence[float]],
        line_cap: int,
        use_caps_for_dashes: bool,
    ) -> None:
        """pairs: int32 (N, 4) consecutive point pairs of the polyline."""
        pairs = np.ascontiguousarray(pairs, dtype=np.int32)
        r, g, b = color
        if dashes is None:
            dash_ptr, n_dashes = None, -1
        else:
            dash_arr = np.ascontiguousarray(dashes, dtype=np.float64)
            dash_ptr = dash_arr.ctypes.data_as(ctypes.c_void_p)
            n_dashes = len(dash_arr)
        self._lib.osmr_draw_lines(
            self._handle, pairs, pairs.shape[0], float(width), r, g, b,
            float(opacity), dash_ptr, n_dashes, line_cap, int(use_caps_for_dashes),
        )

    def label_icon(self, start_x: int, start_y: int, icon_rgba: np.ndarray) -> bool:
        icon = np.ascontiguousarray(icon_rgba, dtype=np.float64)
        h, w = icon.shape[:2]
        return bool(
            self._lib.osmr_label_icon(self._handle, start_x, start_y, w, h, icon.reshape(-1))
        )

    def to_rgb(self) -> np.ndarray:
        out = np.empty((self.dimension, self.dimension, 3), dtype=np.uint8)
        self._lib.osmr_tile_to_rgb(self._handle, out.reshape(-1))
        return out

    def export_label_layer(self) -> np.ndarray:
        """Successful-label staging of the center window, premult RGBA."""
        out = np.empty((self.dimension, self.dimension, 4), dtype=np.float64)
        self._lib.osmr_tile_export_label_layer(self._handle, out.reshape(-1))
        return out


class GlyphRasterizer:
    """Scanline coverage accumulator for one label's text."""

    def __init__(self, color: Tuple[int, int, int]):
        self._lib = _get_lib()
        r, g, b = color
        self._handle = self._lib.osmr_glyph_rasterizer_new(r, g, b)

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.osmr_glyph_rasterizer_free(self._handle)
            self._handle = None

    def draw_line(self, x0, y0, x1, y1) -> None:
        self._lib.osmr_glyph_draw_line(self._handle, x0, y0, x1, y1)

    def draw_quad(self, x0, y0, x1, y1, x2, y2) -> None:
        self._lib.osmr_glyph_draw_quad(self._handle, x0, y0, x1, y1, x2, y2)

    def draw_path(self, ops: np.ndarray) -> None:
        """ops: (N, 7) f64 records [kind, x0, y0, x1, y1, x2, y2];
        kind 0 = line, 1 = quad.  One native call per glyph."""
        ops = np.ascontiguousarray(ops, dtype=np.float64)
        self._lib.osmr_glyph_draw_path(self._handle, ops.reshape(-1), ops.shape[0])

    def save_to_figure(self, tile: OracleTile) -> bool:
        return bool(self._lib.osmr_glyph_save(self._handle, tile._handle))

    def bounds(self) -> Optional[Tuple[int, int, int, int]]:
        """(x_min, x_max, y_min, y_max) of drawn coverage, or None."""
        out = np.zeros(4, dtype=np.int32)
        if not self._lib.osmr_glyph_bounds(self._handle, out):
            return None
        return int(out[0]), int(out[1]), int(out[2]), int(out[3])

    def export_patch(self, x0: int, y0: int, w: int, h: int) -> np.ndarray:
        """Dense (h, w) f64 alpha over the window — the exact values
        save_to_figure would emit (glyph-atlas baking)."""
        out = np.zeros(h * w, dtype=np.float64)
        self._lib.osmr_glyph_export(self._handle, x0, y0, w, h, out)
        return out.reshape(h, w)
