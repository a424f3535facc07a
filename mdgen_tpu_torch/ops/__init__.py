"""Hand-written CUDA kernels with plain twins: the three fused serving
sublayers, the four flash-attention kernels, the short attention over the
residue axis with its backward, and the train step's optimizer pass (the
gradients' sum of squares, the fused clip, Adam and EMA).

The bottom layer of the port: it imports torch and its own modules, nothing
else of the package. What the kernels define and the model reads lives
here: the rotary tables and ``rotate_half``, the masked-key fill
``NEG_INF``, the refusal probe ``carries_tangent``, and the shape limits
that gate the model's routes (``CUDA_FLASH_MIN_KEYS``,
``FUSED_L_MAX_RESIDUES``, ``SHORT_ATTN_MAX_KEYS``, ``SHORT_ATTN_MAX_HEAD_DIM``).

Each public function takes its plain PyTorch version for CPU tensors and
launches its kernel for CUDA tensors; each counts its kernel launches in a
plain integer attribute ``launches``. ``launch_counts`` reports them, and
beside them the calls of the Hyena operator's ``fftconv`` (``torch.fft``,
cuFFT on the card, no kernel of this package) under ``fftconv``.
"""
from ._common import NEG_INF, carries_tangent, rope_tables, rotate_half  # noqa: F401
from .flash_attention import (  # noqa: F401
    CUDA_FLASH_MIN_KEYS,
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
    load_bias_corrections,
    sum_of_squares,
    sum_of_squares_plain,
)
from .fused_block import (  # noqa: F401
    FUSED_L_MAX_RESIDUES,
    fused_l_sublayer,
    fused_l_sublayer_plain,
)
from .fused_ffn import fused_ffn_sublayer, fused_ffn_sublayer_plain  # noqa: F401
from .fused_t_block import fused_t_sublayer, fused_t_sublayer_plain  # noqa: F401
from .short_attention import (  # noqa: F401
    SHORT_ATTN_MAX_HEAD_DIM,
    SHORT_ATTN_MAX_KEYS,
    short_attention,
    short_attention_plain,
)
from .long_conv import fftconv

KERNELS = (fused_l_sublayer, fused_t_sublayer, fused_ffn_sublayer,
           flash_fwd, flash_fwd_lse, flash_bwd_dq, flash_bwd_dkv, sum_of_squares, fused_adam,
           short_attention)
COUNTED = KERNELS + (fftconv,)


def reset_launch_counts() -> None:
    for fn in COUNTED:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in COUNTED}


def add_launch_counts(counts: dict) -> None:
    """Credit ``counts`` ({name: launches}, as ``launch_counts`` names them):
    the launches of a replayed CUDA graph, which no wrapper sees."""
    for fn in COUNTED:
        fn.launches += counts.get(fn.__name__, 0)
