"""mdgen_tpu_torch: the PyTorch + CUDA port of mdgen_tpu.

Mirrors the JAX package's layout and names. It imports torch and numpy,
never jax, flax, optax, orbax or pandas. The slices ported so far are 4AA
training (``python -m mdgen_tpu_torch.train``, with the frame attention's
flash kernels forward and backward) and 4AA forward simulation
(``python -m mdgen_tpu_torch.sim_inference``, with the three fused serving
sublayers); all seven kernels are hand-written CUDA (``ops/``, ``csrc/``).
"""

__version__ = "0.2.0"
