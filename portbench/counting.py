"""Operations and bytes of the work, counted from the configuration's shapes.

Operations count 2 per multiply-add. A kernel's work counts each input
byte read once and each output byte written once, at the cell's shapes and
dtypes, and the operations that the work needs: never a kernel's own
re-reads, recomputation or launch arguments.
"""
from __future__ import annotations

# NVIDIA's data sheet, H100 SXM, dense, at its 700 W power limit
PEAKS = {"32-true": 495e12, "bf16-mixed": 989e12}  # TF32 and bf16 tensor cores
HBM_BYTES_PER_S = 3.35e12


def forward_flops(cfg: dict, B: int, T: int, L: int) -> float:
    """One forward of the denoiser over [B, T, L] tokens: every projection,
    the attention products (q.k and p.v over every key and the bias key) and
    the IPA tower over the key frame. Padded positions count: they are part
    of the shapes the model runs."""
    C, nl, D = cfg["embed_dim"], cfg["num_layers"], cfg["latent_dim"]
    H, ch, Pq, Pv = cfg["ipa_heads"], cfg["ipa_head_dim"], cfg["ipa_qk"], cfg["ipa_v"]
    N, n = B * T * L, B * L
    f = 2 * N * D * C * 2  # latent_to_emb, cond_to_emb
    f += 2 * B * (256 * C + C * C)  # t_embedder
    f += 2 * B * C * (6 + 9) * C * nl  # the adaLN producers
    tower = 2 * n * C * 3 * H * ch + 2 * n * C * H * (2 * Pq + Pv) * 3
    tower += 2 * B * H * L * L * (ch + 3 * Pq + ch + 3 * Pv)
    tower += 2 * n * (H * ch + 4 * H * Pv) * C
    tower += 8 * n * C * C + 4 * n * (L + 1) * C + 16 * n * C * C
    trunk = 8 * N * C * C + 4 * N * (L + 1) * C  # residue attention
    trunk += 8 * N * C * C + 4 * N * (T + 1) * C  # frame attention
    trunk += 16 * N * C * C  # MLP
    f += nl * (tower + trunk)
    f += 2 * B * C * 2 * C + 2 * N * C * D  # the output head
    return float(f)


def train_flops(cfg: dict, B: int, T: int, L: int) -> float:
    """Forward and backward: three forwards; recomputation not counted."""
    return 3.0 * forward_flops(cfg, B, T, L)


def flash_work(cfg: dict, B: int, T: int, L: int, itemsize: int = 4):
    """(operations, bytes) of one train step's frame attentions, forward and
    backward, over every layer: rows N = B L H of Tq = T queries and Tk =
    T + 1 keys of d channels. Forward: q.k and p.v (4 d a pair); backward:
    dv, dp, dq, dk (8 d a pair). Bytes: forward reads q, k, v and the key
    bias and writes o and the log-sum-exp; backward reads q, k, v, the bias,
    o, do and the log-sum-exp and writes dq, dk, dv."""
    C, H, nl = cfg["embed_dim"], cfg["mha_heads"], cfg["num_layers"]
    d, N, Tq, Tk = C // H, B * L * H, T, T + 1
    ops = 12 * d * Tq * Tk * N
    q, kv, bias, lse = N * Tq * d, N * Tk * d, N * Tk, N * Tq
    fwd = (q + 2 * kv + bias) * itemsize + (q + lse) * 4
    bwd = (q + 2 * kv + bias + 2 * q) * itemsize + lse * 4 + (q + 2 * kv) * itemsize
    return float(nl * ops), float(nl * (fwd + bwd))


def least_seconds(ops: float, nbytes: float, peak: float, bw: float = HBM_BYTES_PER_S):
    """(seconds, what bounds it): the larger of operations over the peak
    and bytes over the bandwidth."""
    t_ops, t_mem = ops / peak, nbytes / bw
    return (t_ops, "operations") if t_ops >= t_mem else (t_mem, "bytes")
