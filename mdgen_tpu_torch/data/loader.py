"""Batching loader with background prefetch: the port's own copy of
``mdgen_tpu/data/loader.py`` (queue, threading and numpy only; held to the
original by ``tests/test_torch_selfcontained.py``). One change: a shard
walks the other shards' items of each batch for their random draws.

``Loader(dataset, batch_size, shuffle, drop_last=True, seed, max_batches)``
yields numpy batches {atom14, seqres, mask, name} from a prefetch thread.
With ``drop_last`` a split smaller than one batch gives no batch at all.
Tokenization runs on the device, so the host side is memmap window reads
and ``np.stack``, which one prefetch thread overlaps with device compute.
Each batch's reads and stack are a ``data.load`` span on that thread, and
the consumer's wait for it a ``data.wait`` span (``tracing``), both with the
batch's index in the epoch.
"""
from __future__ import annotations

import queue
import threading

import numpy as np

from .. import tracing

_STACK_KEYS = ("atom14", "seqres", "mask")


class Loader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 drop_last: bool = True, seed: int = 0, prefetch: int = 2,
                 max_batches=None, num_shards: int = 1, shard_id: int = 0):
        """``batch_size`` is the GLOBAL batch. With num_shards > 1 (one shard
        per process), every process draws the identical shuffled order (same
        seed) and loads only its contiguous slice of each batch, the
        counterpart of torch's DistributedSampler. It walks the other
        shards' items too (``dataset.skip(i)`` where the dataset has it,
        else a load it drops), so a dataset that draws at random (a window,
        a replica, a crop) gives each item the draw it gets with one
        shard."""
        assert batch_size % num_shards == 0, (
            f"batch {batch_size} not divisible by {num_shards} shards"
        )
        assert 0 <= shard_id < num_shards
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.rng = np.random.default_rng(seed)
        self.prefetch = prefetch
        self.max_batches = max_batches
        self.num_shards = num_shards
        self.shard_id = shard_id

    def __len__(self):
        n = len(self.dataset) // self.batch_size
        if not self.drop_last and len(self.dataset) % self.batch_size:
            n += 1
        if self.max_batches is not None:
            n = min(n, self.max_batches)
        return n

    def _batches(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(order)
        nb = len(self)
        per = self.batch_size // self.num_shards
        skip = getattr(self.dataset, "skip", self.dataset.__getitem__)
        for b in range(nb):
            with tracing.span("data.load", b):
                idxs = order[b * self.batch_size : (b + 1) * self.batch_size]
                lo, hi = self.shard_id * per, (self.shard_id + 1) * per
                items = []
                for j, i in enumerate(idxs):
                    if lo <= j < hi:
                        items.append(self.dataset[int(i)])
                    else:
                        skip(int(i))
                batch = {
                    k: np.stack([it[k] for it in items]) for k in _STACK_KEYS
                }
                batch["name"] = [it["name"] for it in items]
            yield batch

    def __iter__(self):
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        DONE = object()

        def worker():
            try:
                for batch in self._batches():
                    q.put(batch)
            finally:
                q.put(DONE)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        b = 0
        while True:
            with tracing.span("data.wait", b):
                item = q.get()
            if item is DONE:
                break
            yield item
            b += 1
