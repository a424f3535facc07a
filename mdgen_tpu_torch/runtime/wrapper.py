"""Port of ``mdgen_tpu/runtime/wrapper.py``: forward-simulation inference
(:class:`MDGenRuntime`) and training (:class:`TrainRuntime`).

PyTorch runs eagerly: each rollout tokenizes its start frame on the device,
integrates the Euler ODE over the denoiser (one model call per step,
launched from the host), decodes the latents to atom14 and re-tokenizes the
last frame for the next rollout. A train step tokenizes the raw atom14
batch on the device, takes the flow-matching loss and its gradient with
autograd (at T=1000 through the flash kernels' backward), and applies the
optax-equivalent optimizer (``optim.py``) and the EMA.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Optional

import torch

from ..geometry import atom14_to_atom37, atom14_to_frames, atom37_to_torsions
from ..models import LatentMDGenModel
from ..tasks import decode_latents, prep_batch
from ..transport import Sampler, Transport, TransportConfig
from .optim import Optimizer, global_norm


def transport_config(cfg) -> TransportConfig:
    return TransportConfig(path_type=cfg.path_type, prediction=cfg.prediction)


def tokenize_atom14(batch: dict) -> dict:
    """Raw atom14 windows -> (frames, torsions) tokens, on the batch's device.

    batch: {atom14 [B,T,L,14,3], seqres [B,L], mask [B,L]} -> {torsions,
    torsion_mask, trans, rots, seqres, mask}; padded residues get identity
    frames and a zero torsion mask.
    """
    atom14 = batch["atom14"].float()
    seqres, mask = batch["seqres"], batch["mask"]
    B, T, L = atom14.shape[:3]
    aatype_btl = seqres[:, None].expand(B, T, L)

    frames = atom14_to_frames(atom14)
    atom37 = atom14_to_atom37(atom14, aatype_btl)
    torsions, torsion_mask = atom37_to_torsions(atom37, aatype_btl)

    pad = (mask < 0.5)[:, None, :]
    eye = torch.eye(3, dtype=atom14.dtype, device=atom14.device).expand(frames.rots.shape)
    rots = torch.where(pad[..., None, None], eye, frames.rots)
    trans = torch.where(pad[..., None], torch.zeros_like(frames.trans), frames.trans)
    return {
        "torsions": torsions,
        "torsion_mask": torsion_mask[:, 0] * mask[..., None],
        "trans": trans,
        "rots": rots,
        "seqres": seqres,
        "mask": mask,
    }


def inference_param_cast(cfg, model: LatentMDGenModel) -> LatentMDGenModel:
    """Serving copy of the model: under bf16-mixed every f32 parameter is
    rounded to bf16 once (buffers such as the sin-cos tables stay f32).
    Layers with a compute dtype then run in bf16; the others compute in f32
    on the bf16-rounded weights, as flax promotes to the f32 input."""
    if cfg.precision != "bf16-mixed":
        return model
    model = copy.deepcopy(model)
    with torch.no_grad():
        for p in model.parameters():
            if p.dtype == torch.float32:
                p.data = p.data.to(torch.bfloat16)
    return model


class MDGenRuntime:
    def __init__(self, cfg, model: LatentMDGenModel):
        if cfg.no_frames or cfg.atlas:
            raise NotImplementedError("no_frames / atlas tokenization is not ported yet")
        self.cfg = cfg
        self.model = model
        self.model_inf = inference_param_cast(cfg, model).eval()
        self.sampler = Sampler(Transport(transport_config(cfg)))

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    @torch.inference_mode()
    def inference(self, batch: dict, generator: Optional[torch.Generator] = None,
                  noise: Optional[torch.Tensor] = None):
        """noise -> Euler ODE sample -> (atom14 [B,T,L,14,3], aatype [B,T,L]).
        ``noise`` [B,T,L,latent_dim] replaces the draw from ``generator``."""
        cfg = self.cfg
        tok = tokenize_atom14(batch)
        prep = prep_batch(cfg, tok)
        B, T, L = prep.model_kwargs["mask"].shape
        if noise is None:
            noise = torch.randn((B, T, L, cfg.latent_dim), generator=generator,
                                device=self.device)
        sample_fn = self.sampler.sample_ode(
            self.model_inf, sampling_method=cfg.sampling_method,
            num_steps=cfg.inference_steps,
        )
        samples = sample_fn(noise.float(), **prep.model_kwargs)
        return decode_latents(cfg, samples, prep.rigids, tok["seqres"])

    @torch.inference_mode()
    def rollout(self, start_atom14, seqres, mask, num_rollouts: int,
                generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None):
        """Autoregressive forward simulation: start [B,L,14,3] ->
        [B, R*T, L, 14, 3]. ``noise`` [R,B,T,L,latent_dim] replaces the draws."""
        B, L = seqres.shape
        T = self.cfg.num_frames
        start = start_atom14.float()
        trajs = []
        for r in range(num_rollouts):
            batch = {
                "atom14": start[:, None].expand(B, T, L, 14, 3),
                "seqres": seqres,
                "mask": mask,
            }
            atom14, _ = self.inference(
                batch, generator, None if noise is None else noise[r]
            )
            start = atom14[:, -1]
            trajs.append(atom14)
        return torch.stack(trajs, dim=1).reshape(B, num_rollouts * T, L, 14, 3)


# -- training ------------------------------------------------------------------


def check_trainable(cfg) -> None:
    """Options that change training and are not ported raise here instead of
    being ignored (serving accepts them: dropout does nothing at inference)."""
    if cfg.dropout > 0:
        raise NotImplementedError(
            f"cfg.dropout={cfg.dropout}: training with dropout is not ported to "
            "mdgen_tpu_torch yet (ROADMAP queue 1, item 14)"
        )
    if cfg.grad_checkpointing:
        raise NotImplementedError(
            "cfg.grad_checkpointing is not ported to mdgen_tpu_torch yet "
            "(ROADMAP queue 1, item 14)"
        )
    if cfg.no_frames or cfg.atlas:
        raise NotImplementedError("no_frames / atlas tokenization is not ported yet")


def batch_to_device(batch: dict, device) -> dict:
    """A loader batch (numpy) -> {atom14 f32, seqres long, mask f32} tensors."""
    return {
        "atom14": torch.as_tensor(batch["atom14"], dtype=torch.float32, device=device),
        "seqres": torch.as_tensor(batch["seqres"], device=device).long(),
        "mask": torch.as_tensor(batch["mask"], dtype=torch.float32, device=device),
    }


@dataclass
class TrainState:
    step: int
    model: LatentMDGenModel  # f32 parameters, trained
    opt_state: dict
    ema: Optional[LatentMDGenModel]  # the EMA copy when cfg.ema, else None


class TrainRuntime:
    """The JAX runtime's training half: ``_loss_fn``, ``train_step``,
    ``val_step``, ``eval_params`` and ``grad_report``."""

    def __init__(self, cfg, device="cpu"):
        check_trainable(cfg)
        self.cfg = cfg
        self.device = torch.device(device)
        # the fused sublayers are forward-only: never in the training model
        self.model_cfg = cfg.replace(fused_block=False)
        self.transport = Transport(transport_config(cfg))
        self.tx = Optimizer.from_config(cfg)

    def init(self, generator: Optional[torch.Generator] = None,
             state_dict: Optional[dict] = None) -> TrainState:
        """Fresh parameters from ``generator`` (or ``state_dict``), a fresh
        optimizer state and, with ``cfg.ema``, an EMA copy."""
        model = LatentMDGenModel(self.model_cfg, self.cfg.latent_dim)
        if state_dict is None:
            model.reset_parameters(generator)
        else:
            model.load_state_dict(state_dict)
        model = model.to(self.device)
        ema = copy.deepcopy(model).requires_grad_(False) if self.cfg.ema else None
        return TrainState(0, model, self.tx.init(list(model.parameters())), ema)

    def loss_fn(self, model, batch: dict, generator=None, t=None, x0=None):
        """Mean flow-matching loss and its metrics. A raw batch (atom14) is
        tokenized on its device; a token dict (``tokenize_atom14``'s output)
        passes through, as in the JAX runtime."""
        tok = tokenize_atom14(batch) if "atom14" in batch else batch
        prep = prep_batch(self.cfg, tok)
        out = self.transport.training_losses(
            model, prep.latents, prep.loss_mask, prep.model_kwargs,
            generator=generator, t=t, x0=x0,
        )
        loss = out["loss"].mean()
        return loss, {"loss": loss.detach(), "time": out["t"].mean()}

    def _grads(self, model, batch, generator=None, t=None, x0=None):
        params = list(model.parameters())
        loss, metrics = self.loss_fn(model, batch, generator, t, x0)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        return params, grads, metrics

    def train_step(self, state: TrainState, batch: dict, generator=None, t=None, x0=None):
        """One micro-step: gradient, optimizer (which applies an update on
        every ``accumulate_grad``-th call), EMA and the step counter, which
        both advance on every call. ``grad_norm`` is this micro-batch's."""
        params, grads, metrics = self._grads(state.model, batch, generator, t, x0)
        metrics["grad_norm"] = global_norm(grads)
        self.tx.step(params, grads, state.opt_state)
        if state.ema is not None:
            d = self.cfg.ema_decay
            with torch.no_grad():
                for e, p in zip(state.ema.parameters(), params):
                    e.copy_(e * d + (1 - d) * p)
        state.step += 1
        return state, metrics

    @torch.no_grad()
    def val_step(self, model, batch: dict, generator=None, t=None, x0=None) -> dict:
        return self.loss_fn(model, batch, generator, t, x0)[1]

    def eval_params(self, state: TrainState) -> LatentMDGenModel:
        """The model to evaluate with: the EMA copy when enabled."""
        return state.ema if self.cfg.ema else state.model

    def grad_report(self, state: TrainState, batch: dict, generator=None) -> dict:
        """{parameter name: gradient norm} for ``--check_grad``."""
        names = [n for n, _ in state.model.named_parameters()]
        _, grads, _ = self._grads(state.model, batch, generator)
        return {n: float(torch.linalg.vector_norm(g)) for n, g in zip(names, grads)}
