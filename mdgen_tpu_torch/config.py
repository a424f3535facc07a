"""Configuration: the port's own copy of ``mdgen_tpu/config.py``.

One frozen dataclass holds the reference's ~70 CLI flags (reference
`mdgen/parsing.py:5-125`). It is hashable, JSON-serializable (stored beside
checkpoints so inference needs no side-band flags) and CLI-compatible:
``add_model_args``/``config_from_args`` keep the reference flag names.

The copy is field for field the JAX package's (held to it by
``tests/test_torch_selfcontained.py``), without ``compute_dtype``, which
returns a jax dtype: use :func:`torch_dtype`. Port functions read config
attributes only, so either package's config object works.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Optional

import torch


@dataclass(frozen=True)
class MDGenConfig:
    # -- data ------------------------------------------------------------
    num_frames: int = 50
    crop: int = 256
    suffix: str = ""
    atlas: bool = False
    frame_interval: Optional[int] = None
    copy_frames: bool = False
    overfit: bool = False
    overfit_peptide: Optional[str] = None
    overfit_frame: bool = False

    # -- task / conditioning ----------------------------------------------
    sim_condition: bool = False
    tps_condition: bool = False
    inpainting: bool = False
    design: bool = False
    dynamic_mpnn: bool = False
    mpnn: bool = False
    cond_interval: Optional[int] = None

    # -- masking / ablations -----------------------------------------------
    design_key_frames: bool = False
    no_aa_emb: bool = False
    no_torsion: bool = False
    no_design_torsion: bool = False
    supervise_no_torsions: bool = False
    supervise_all_torsions: bool = False
    no_offsets: bool = False
    no_frames: bool = False
    # relative loss weight on the sidechain (chi1-4) torsion sin/cos
    # channels; 1.0 = reference behavior (uniform)
    chi_loss_weight: float = 1.0
    # optional per-chi override "w1,w2,w3,w4" multiplied on top of
    # chi_loss_weight; a comma string so the config stays hashable and JSON
    # round-trippable
    chi_loss_weights: Optional[str] = None

    # -- model -------------------------------------------------------------
    num_layers: int = 5
    embed_dim: int = 384
    mha_heads: int = 16
    ipa_heads: int = 4
    ipa_head_dim: int = 32
    ipa_qk: int = 8
    ipa_v: int = 8
    dropout: float = 0.0
    hyena: bool = False
    no_rope: bool = False
    prepend_ipa: bool = False
    interleave_ipa: bool = False
    abs_pos_emb: bool = False
    abs_time_emb: bool = False
    time_multiplier: float = 100.0
    grad_checkpointing: bool = False
    # attention inner loop for the frame axis: auto | dense | chunked | flash
    attn_impl: str = "auto"
    # run each trunk layer's sublayers as the fused forward-only kernels
    # (serving only; the trainer builds its model with fused_block=False)
    fused_block: bool = False

    # -- transport -----------------------------------------------------------
    path_type: str = "GVP"  # Linear | GVP | VP
    prediction: str = "velocity"  # velocity | score | noise
    sampling_method: str = "dopri5"  # dopri5 | euler
    inference_steps: int = 50
    alpha_max: float = 8.0
    discrete_loss_weight: float = 0.5
    dirichlet_flow_temp: float = 1.0
    allow_nan_cfactor: bool = False
    oracle: bool = False

    # -- optimization -----------------------------------------------------
    lr: float = 1e-4
    adamW: bool = False
    grad_clip: float = 1.0
    accumulate_grad: int = 1
    ema: bool = False
    ema_decay: float = 0.999
    batch_size: int = 8
    epochs: int = 100
    # "32-true": f32 compute; "bf16-mixed": bf16 activations/matmuls with f32
    # params, layernorms, and softmax (DiT-standard mixed precision)
    precision: str = "32-true"

    # -- parallelism -------------------------------------------------------
    dp_size: int = -1  # -1: all devices on the data axis
    tp_size: int = 1  # tensor-parallel (embed/FFN sharding) axis size
    sp_size: int = 1  # sequence-parallel (frame-axis activation sharding)

    # ------------------------------------------------------------------
    @property
    def latent_dim(self) -> int:
        """Latent-channel law (reference `mdgen/wrapper.py:195-202`):
        7 (frame offset tensor-7) + 14 (torsion sin/cos); doubled offsets for
        endpoint-conditioned tasks; +20 simplex channels for design; raw
        atom37 (37*3=111) when frames are ablated."""
        dim = 21 if not (self.tps_condition or self.inpainting or self.dynamic_mpnn) else 28
        if self.design:
            dim += 20
        if self.no_frames:
            dim = 111
        return dim

    # -- (de)serialization --------------------------------------------------
    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "MDGenConfig":
        data = json.loads(s)
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in data.items() if k in fields})

    def replace(self, **kw) -> "MDGenConfig":
        return dataclasses.replace(self, **kw)


def add_model_args(parser):
    """Register reference-compatible CLI flags on an argparse parser."""
    g = parser.add_argument_group("data")
    g.add_argument("--num_frames", type=int, default=50)
    g.add_argument("--crop", type=int, default=256)
    g.add_argument("--suffix", type=str, default="")
    g.add_argument("--atlas", action="store_true")
    g.add_argument("--frame_interval", type=int, default=None)
    g.add_argument("--copy_frames", action="store_true")
    g.add_argument("--overfit", action="store_true")
    g.add_argument("--overfit_peptide", type=str, default=None)
    g.add_argument("--overfit_frame", action="store_true")

    g = parser.add_argument_group("task")
    g.add_argument("--sim_condition", action="store_true")
    g.add_argument("--tps_condition", action="store_true")
    g.add_argument("--inpainting", action="store_true")
    g.add_argument("--design", action="store_true")
    g.add_argument("--dynamic_mpnn", action="store_true")
    g.add_argument("--mpnn", action="store_true")
    g.add_argument("--cond_interval", type=int, default=None)

    g = parser.add_argument_group("masking")
    g.add_argument("--design_key_frames", action="store_true")
    g.add_argument("--no_aa_emb", action="store_true")
    g.add_argument("--no_torsion", action="store_true")
    g.add_argument("--no_design_torsion", action="store_true")
    g.add_argument("--supervise_no_torsions", action="store_true")
    g.add_argument("--supervise_all_torsions", action="store_true")
    g.add_argument("--chi_loss_weight", type=float, default=1.0)
    g.add_argument("--chi_loss_weights", type=str, default=None,
                   help="per-chi loss weights 'w1,w2,w3,w4', multiplied "
                        "on top of --chi_loss_weight")
    g.add_argument("--no_offsets", action="store_true")
    g.add_argument("--no_frames", action="store_true")

    g = parser.add_argument_group("model")
    g.add_argument("--num_layers", type=int, default=5)
    g.add_argument("--embed_dim", type=int, default=384)
    g.add_argument("--mha_heads", type=int, default=16)
    g.add_argument("--ipa_heads", type=int, default=4)
    g.add_argument("--ipa_head_dim", type=int, default=32)
    g.add_argument("--ipa_qk", type=int, default=8)
    g.add_argument("--ipa_v", type=int, default=8)
    g.add_argument("--dropout", type=float, default=0.0)
    g.add_argument("--hyena", action="store_true")
    g.add_argument("--no_rope", action="store_true")
    g.add_argument("--prepend_ipa", action="store_true")
    g.add_argument("--interleave_ipa", action="store_true")
    g.add_argument("--abs_pos_emb", action="store_true")
    g.add_argument("--abs_time_emb", action="store_true")
    g.add_argument("--time_multiplier", type=float, default=100.0)
    g.add_argument("--grad_checkpointing", action="store_true")

    g = parser.add_argument_group("transport")
    g.add_argument("--path-type", dest="path_type", type=str, default="GVP",
                   choices=["Linear", "GVP", "VP"])
    g.add_argument("--prediction", type=str, default="velocity",
                   choices=["velocity", "score", "noise"])
    g.add_argument("--sampling_method", type=str, default="dopri5",
                   choices=["dopri5", "euler"])
    g.add_argument("--inference_steps", type=int, default=50)
    g.add_argument("--alpha_max", type=float, default=8.0)
    g.add_argument("--discrete_loss_weight", type=float, default=0.5)
    g.add_argument("--dirichlet_flow_temp", type=float, default=1.0)
    g.add_argument("--allow_nan_cfactor", action="store_true")
    g.add_argument("--oracle", action="store_true")

    g = parser.add_argument_group("optimization")
    g.add_argument("--lr", type=float, default=1e-4)
    g.add_argument("--adamW", action="store_true")
    g.add_argument("--grad_clip", type=float, default=1.0)
    g.add_argument("--accumulate_grad", type=int, default=1)
    g.add_argument("--ema", action="store_true")
    g.add_argument("--ema_decay", type=float, default=0.999)
    g.add_argument("--batch_size", type=int, default=8)
    g.add_argument("--epochs", type=int, default=100)
    g.add_argument("--precision", type=str, default="32-true")

    g = parser.add_argument_group("parallelism")
    g.add_argument("--dp_size", type=int, default=-1)
    g.add_argument("--tp_size", type=int, default=1)
    g.add_argument("--sp_size", type=int, default=1)
    return parser


def config_from_args(args) -> MDGenConfig:
    fields = {f.name for f in dataclasses.fields(MDGenConfig)}
    return MDGenConfig(**{k: v for k, v in vars(args).items() if k in fields})


def torch_dtype(cfg) -> torch.dtype:
    """Compute dtype: bf16 under ``bf16-mixed``, else f32."""
    return torch.bfloat16 if cfg.precision == "bf16-mixed" else torch.float32
