"""The port's dense renderer against `render_jnp.render_batch` where its
windows are tight: the window-margin fuzz scene (wide strokes at and
across the tile's edges, long diagonals, degenerate segments,
round-capped dashes, concave polygons and polygons crossing the tile),
in both precisions.  A
window too small shows as a byte mismatch.  Bar: byte-identical."""

import pytest

from tests.test_torch_render_dense import CHUNK, assert_same, both, scene_window_fuzz


@pytest.mark.parametrize("precision", ["exact", "fast"])
def test_window_fuzz_matches_render_jnp(precision):
    want, got, chain = both([lambda prim: scene_window_fuzz(1, prim)], 256, CHUNK, precision)
    assert chain
    assert_same(want, got, precision)
