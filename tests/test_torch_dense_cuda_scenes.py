"""The dense kernels' plain version (`dense_cuda.render_batch_twin`, fed
`pack_plan`'s arguments) against `render_jnp.render_batch` under x64:
the icon-fill scene (kind 5, the pattern blend; the walk chain off) and
the tests/test_torch_render.py @2x scene (ts 512), in both precisions.
Bar: byte-identical."""

import pytest

from tests.test_torch_dense_cuda import twin_and_jax
from tests.test_torch_render import scene_2x
from tests.test_torch_render_dense import assert_same, scene_icon, write_icon


@pytest.mark.parametrize("precision", ["exact", "fast"])
def test_twin_matches_render_jnp_icon_fill_chain_off(tmp_path, precision):
    from osm_renderer_tpu.draw.labels.icons import IconCache as JaxIconCache
    from osm_renderer_tpu_torch.draw.labels.icons import IconCache

    write_icon(tmp_path)
    caches = (JaxIconCache(str(tmp_path)), IconCache(str(tmp_path)))
    want, got, chain = twin_and_jax([scene_icon], 256, precision, caches)
    assert not chain
    assert_same(want, got, precision)


@pytest.mark.parametrize("precision", ["exact", "fast"])
def test_twin_matches_render_jnp_2x(precision):
    want, got, chain = twin_and_jax([lambda prim: scene_2x(prim)[1]], 512, precision)
    assert chain and got.shape == (1, 512, 512, 3)
    assert_same(want, got, precision)
