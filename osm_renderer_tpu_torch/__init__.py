"""osm_renderer_tpu_torch: the tile renderer on PyTorch and CUDA.

The port of `osm_renderer_tpu` (JAX/Pallas) to one NVIDIA Hopper GPU.
Host code that does not import jax is shared with the JAX package; the
device path (batch layout on the device, the hand-written CUDA render
kernel in `csrc/`, serving) lives here.  This package never imports jax.
"""
