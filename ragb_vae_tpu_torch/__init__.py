"""PyTorch / CUDA port of ragb_vae_tpu for one NVIDIA H100.

Mirrors the JAX package's layout (`models/`, `ops/`, `ops/kernels/` in place
of `ops/pallas/`, `inference.py`, `serving.py`); the CUDA sources of the
hand-written kernels live in `csrc/`. Public functions keep the JAX
package's layout: NHWC images in [0, 1], FLUX tokens as (B, S, C).
"""
