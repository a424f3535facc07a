"""Batching loader: the JAX package's ``mdgen_tpu/data/loader.py`` (queue,
threading and numpy only), executed by file path and shared, not copied.

``Loader(dataset, batch_size, shuffle, drop_last=True, seed, max_batches)``
yields numpy batches {atom14, seqres, mask, name} from a prefetch thread.
With ``drop_last`` a split smaller than one batch gives no batch at all.
"""
from .._shared import load_module

Loader = load_module("mdgen_tpu_torch._jax_loader", "mdgen_tpu/data/loader.py").Loader
