"""osm_renderer_tpu_torch: the tile renderer on PyTorch and CUDA.

The port of `osm_renderer_tpu` (JAX/Pallas) to one NVIDIA Hopper GPU.
It imports nothing of the JAX package: the jax-free host modules (core,
perfstats, geodata, mapcss, draw) are copies under the same relative
paths, and the device path (batch layout on the device, the
hand-written CUDA kernels in `csrc/`, serving) lives here.  This
package never imports jax.
"""
