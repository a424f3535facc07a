"""mdgen_tpu_torch: the PyTorch + CUDA port of mdgen_tpu.

Mirrors the JAX package's layout and names. It imports torch and numpy,
never jax, flax, optax, orbax or pandas. The slices ported so far are 4AA
training (``python -m mdgen_tpu_torch.train``, with the frame attention's
flash kernels forward and backward), 4AA forward simulation
(``python -m mdgen_tpu_torch.sim_inference``, Euler, Heun or dopri5, with
the three fused serving sublayers) and the quality chain (the synthetic
rotamer dataset, PDB/XTC I/O, ``python -m
mdgen_tpu_torch.analyze_peptide_sim`` and ``python -m
mdgen_tpu_torch.quality_run``), the TPS, upsampling and design tasks, every
model configuration, data-parallel training over ``torch.distributed``
(``parallel/``), reference checkpoints (``port_checkpoint``), MD
preprocessing (``prep_sims``) and the noise-floor protocol
(``noise_floor``, ``eval_protocol``); all seven kernels are hand-written
CUDA (``ops/``, ``csrc/``).
"""

__version__ = "0.2.0"
