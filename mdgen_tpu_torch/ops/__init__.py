"""Hand-written CUDA kernels with plain twins: the three fused serving
sublayers, the four flash-attention kernels and the train step's optimizer
pass (the gradients' sum of squares, the fused clip, Adam and EMA).

Each public function takes its plain PyTorch version for CPU tensors and
launches its kernel for CUDA tensors; each counts its kernel launches in a
plain integer attribute ``launches``.
"""
from .flash_attention import (  # noqa: F401
    chunked_attention,
    flash_attention,
    flash_attention_bwd_plain,
    flash_attention_plain,
    flash_bwd_dkv,
    flash_bwd_dq,
    flash_fwd,
    flash_fwd_lse,
)
from .fused_optim import (  # noqa: F401
    fused_adam,
    fused_adam_plain,
    sum_of_squares,
    sum_of_squares_plain,
)
from .fused_block import fused_l_sublayer, fused_l_sublayer_plain  # noqa: F401
from .fused_ffn import fused_ffn_sublayer, fused_ffn_sublayer_plain  # noqa: F401
from .fused_t_block import fused_t_sublayer, fused_t_sublayer_plain  # noqa: F401

KERNELS = (fused_l_sublayer, fused_t_sublayer, fused_ffn_sublayer,
           flash_fwd, flash_fwd_lse, flash_bwd_dq, flash_bwd_dkv, sum_of_squares, fused_adam)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNELS}
