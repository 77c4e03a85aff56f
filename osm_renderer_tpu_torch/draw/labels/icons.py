"""Icon loading and caching (reference: `icon.rs`, `icon_cache.rs`).

PNG icons are decoded to premultiplied f64 RGBA (all color types
normalized to 8-bit, like the reference's `normalize_to_color8`);
failed loads are cached as None with a warning on stderr.
"""

from __future__ import annotations

import os
import sys
import threading
from typing import Dict, Optional

import numpy as np


class Icon:
    __slots__ = ("rgba", "width", "height")

    def __init__(self, rgba: np.ndarray):
        self.rgba = rgba  # (H, W, 4) float64 premultiplied
        self.height, self.width = rgba.shape[:2]


def load_icon(path: str) -> Icon:
    from PIL import Image

    img = Image.open(path)
    if img.mode not in ("RGBA", "RGB", "LA", "L"):
        img = img.convert("RGBA")
    arr = np.asarray(img)
    if img.mode == "RGB":
        rgba = np.concatenate(
            [arr, np.full(arr.shape[:2] + (1,), 255, dtype=np.uint8)], axis=-1
        )
    elif img.mode == "L":
        rgba = np.stack([arr] * 3 + [np.full_like(arr, 255)], axis=-1)
    elif img.mode == "LA":
        rgba = np.stack([arr[..., 0]] * 3 + [arr[..., 1]], axis=-1)
    else:
        rgba = arr
    rgba = rgba.astype(np.float64) / 255.0
    a = rgba[..., 3:4]
    premult = np.concatenate([rgba[..., :3] * a, a], axis=-1)
    return Icon(np.ascontiguousarray(premult))


class IconCache:
    def __init__(self, base_path: str):
        self.base_path = base_path
        self._cache: Dict[str, Optional[Icon]] = {}
        self._lock = threading.Lock()

    def get(self, icon_name: str) -> Optional[Icon]:
        with self._lock:
            if icon_name in self._cache:
                return self._cache[icon_name]
        full_path = os.path.join(self.base_path, icon_name)
        try:
            icon = load_icon(full_path)
        except Exception as error:
            print(f"Failed to load icon from {full_path}: {error}", file=sys.stderr)
            icon = None
        with self._lock:
            self._cache.setdefault(icon_name, icon)
            return self._cache[icon_name]
