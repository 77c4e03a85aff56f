"""The port's dense renderer against `render_jnp.render_batch` at @2x
(ts 512): the tests/test_torch_render.py @2x scene (fills and
round-capped dashed strokes), in both precisions.  Bar: byte-identical."""

import pytest

from tests.test_torch_render import scene_2x
from tests.test_torch_render_dense import CHUNK, assert_same, both


@pytest.mark.parametrize("precision", ["exact", "fast"])
def test_2x_scene_matches_render_jnp(precision):
    want, got, chain = both([lambda prim: scene_2x(prim)[1]], 512, CHUNK, precision)
    assert chain and got.shape == (1, 512, 512, 3)
    assert_same(want, got, precision)
