"""The port's dense renderer against `render_jnp.render_batch` on two
fuzz scenes of tests/test_torch_render.py (seeds 3 and 11: random fills
and strokes of every cap, dash pattern and width), one tile each of one
batch, in both precisions.  Bar: byte-identical."""

import pytest

from tests.test_torch_render import scene_fuzz
from tests.test_torch_render_dense import CHUNK, assert_same, both

SCENES = {
    "fuzz3": lambda prim: scene_fuzz(3, prim)[1],
    "fuzz11": lambda prim: scene_fuzz(11, prim)[1],
}


@pytest.fixture(scope="module", params=["exact", "fast"])
def rendered(request):
    want, got, chain = both(list(SCENES.values()), 256, CHUNK, request.param)
    assert chain
    return request.param, want, got


@pytest.mark.parametrize("tile", range(len(SCENES)), ids=list(SCENES))
def test_fuzz_scenes_match_render_jnp(rendered, tile):
    precision, want, got = rendered
    assert_same(want[tile:tile + 1], got[tile:tile + 1], f"{precision} {list(SCENES)[tile]}")
