"""Operations and bytes of the trunk's residue attention in a train step,
after ``counting.py``'s rules: 2 operations a multiply-add, each input byte
read once and each output byte written once.

Each trunk layer attends over the L residues of every (b, t) row plus the
learned bias key, from the packed projection [B, T, L, 3C] to o [B, T, L,
C]. The least the work must move: forward, q, k and v read and o written;
backward, q, k, v and dO read and dq, dk and dv written; 11 tensors of B T
L C elements at the cell's itemsize. Left out: the bias key and value (C
elements), the key mask, anything a kernel saves or reads again, and the
IPA tower's rows (B L a layer), so the least time cannot exceed the time
of the kernels that do more.
"""
from __future__ import annotations


def residue_attn_work(cfg: dict, B: int, T: int, L: int, itemsize: int = 4):
    """(operations, bytes) of one train step's trunk residue attentions,
    forward and backward, over every layer. Operations per (query, key)
    pair and channel: forward q.k and p.v (4); backward the logit again,
    dp, dq, dk and dv (10)."""
    C, nl = cfg["embed_dim"], cfg["num_layers"]
    n = B * T * L * C
    ops = (4 + 10) * (L + 1) * n
    return float(nl * ops), float(nl * (4 + 7) * n * itemsize)
