"""Port of ``mdgen_tpu/runtime/wrapper.py``: inference for forward
simulation, TPS, upsampling, inpainting and sequence design
(:class:`MDGenRuntime`) and training (:class:`TrainRuntime`), in every
configuration of the JAX runtime: ATLAS crops (tokenized with their
left-context column), the ``no_frames`` ablation (raw atom37 latents),
dropout and gradient checkpointing.

PyTorch runs eagerly: each rollout tokenizes its start frame on the device,
integrates the probability-flow ODE over the denoiser with the configured
solver (Euler, Heun or dopri5; one model call per stage, launched from the
host), decodes the latents to atom14 and re-tokenizes the
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

from ..geometry import (
    atom14_to_atom37,
    atom14_to_frames,
    atom37_to_atom14,
    atom37_to_torsions,
    frames_torsions_to_atom14,
)
from ..geometry import constants as rc
from ..models import LatentMDGenModel
from ..parallel import all_reduce_mean, process_allgather, rank, world_size
from ..tasks import decode_latents, prep_batch
from ..transport import Sampler, Transport, TransportConfig
from ..transport.dirichlet import sample_dirichlet
from .optim import Optimizer, global_norm


def transport_config(cfg) -> TransportConfig:
    return TransportConfig(path_type=cfg.path_type, prediction=cfg.prediction,
                           design=cfg.design, dynamic_mpnn=cfg.dynamic_mpnn, mpnn=cfg.mpnn,
                           alpha_max=cfg.alpha_max,
                           discrete_loss_weight=cfg.discrete_loss_weight)


def tokenize_atom14(batch: dict, drop_left_context: bool = False) -> dict:
    """Raw atom14 windows -> (frames, torsions) tokens, on the batch's device.

    batch: {atom14 [B,T,L,14,3], seqres [B,L], mask [B,L]} -> {torsions,
    torsion_mask, trans, rots, seqres, mask}; padded residues get identity
    frames and a zero torsion mask.

    ``drop_left_context``: column 0 is the ATLAS item's left-context residue
    (``data.dataset``): its atoms give the first cropped residue its phi and
    omega, then every output drops it. The atom mask is the residue type's
    times the residue mask, so a mask-0 context column (the chain's start)
    leaves that phi and omega masked.
    """
    atom14 = batch["atom14"].float()
    seqres, mask = batch["seqres"], batch["mask"]
    B, T, L = atom14.shape[:3]
    aatype_btl = seqres[:, None].expand(B, T, L)

    frames = atom14_to_frames(atom14)
    atom37 = atom14_to_atom37(atom14, aatype_btl)
    atom37_mask = None
    if drop_left_context:
        a37 = torch.as_tensor(rc.RESTYPE_ATOM37_MASK, dtype=torch.float32, device=atom14.device)
        atom37_mask = a37[aatype_btl.long()] * mask[:, None, :, None]
    torsions, torsion_mask = atom37_to_torsions(atom37, aatype_btl, all_atom_mask=atom37_mask)
    if drop_left_context:
        torsions, torsion_mask = torsions[:, :, 1:], torsion_mask[:, :, 1:]
        frames = frames[:, :, 1:]
        seqres, mask = seqres[:, 1:], mask[:, 1:]

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


def tokenize_no_frames(batch: dict) -> dict:
    """Raw atom14 -> the ``no_frames`` ablation's batch: {atom37
    [B,T,L,37,3], seqres [B,L], mask [B,L,37]}, the mask the residue type's
    atom37 mask."""
    atom14 = batch["atom14"].float()
    seqres = batch["seqres"]
    B, T, L = atom14.shape[:3]
    atom37 = atom14_to_atom37(atom14, seqres[:, None].expand(B, T, L))
    a37 = torch.as_tensor(rc.RESTYPE_ATOM37_MASK, dtype=torch.float32, device=atom14.device)
    return {"atom37": atom37, "seqres": seqres, "mask": a37[seqres.long()]}


def tokenize(cfg, batch: dict) -> dict:
    """The runtime's tokenizer: a raw batch (atom14) is tokenized on its
    device, a token dict passes through. ``no_frames`` takes atom37; an
    ATLAS batch whose width is ``crop + 1`` carries the left-context column
    (detected by shape, as the JAX runtime does) and drops it."""
    if "atom14" not in batch:
        return batch
    if cfg.no_frames:
        return tokenize_no_frames(batch)
    drop_ctx = cfg.atlas and batch["atom14"].shape[2] == cfg.crop + 1
    return tokenize_atom14(batch, drop_left_context=drop_ctx)


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
        self.cfg = cfg
        self.model = model
        self.model_inf = inference_param_cast(cfg, model).eval()
        self.sampler = Sampler(Transport(transport_config(cfg)))

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    @torch.inference_mode()
    def inference(self, batch: dict, generator: Optional[torch.Generator] = None,
                  noise: Optional[torch.Tensor] = None, stats: Optional[dict] = None,
                  rows: Optional[tuple] = None):
        """noise -> ODE sample (``cfg.sampling_method``) -> (atom14 [B,T,L,14,3],
        aatype [B,T,L]). A raw batch (atom14) is tokenized on its device
        (``tokenize``); a token dict (``tokenize_atom14``'s keys, e.g.
        upsampling windows) passes through. Under ``no_frames`` the samples
        are atom37 coordinates, decoded to atom14. ``noise``
        [B,T,L,latent_dim] replaces the draw from ``generator``; ``stats``
        receives the solver's counts.

        Design: the start is N(0, I) over the continuous channels and
        Dirichlet(1) over [B, L, 20], broadcast over T (a given ``noise``
        carries both), and ``aatype`` is the designed sequence. The mpnn
        modes take one forward at t = 1 with zero simplex channels: aatype
        [B, 1, L] is its argmax, the atoms are those of the true tokens.
        ``rows = (lo, n)``: the batch is rows lo.. of an n-row one (a
        data-parallel rank); the noise is drawn for n rows and sliced."""
        cfg = self.cfg
        tok = tokenize(cfg, batch)
        prep = prep_batch(cfg, tok)
        B, T, L = prep.model_kwargs["mask"].shape
        if cfg.dynamic_mpnn or cfg.mpnn:
            x1 = prep.latents
            xt = torch.cat([x1, x1.new_zeros((B, T, L, 20))], dim=-1)
            logits = self.model_inf.forward_inference(xt, x1.new_ones((B,)), **prep.model_kwargs)
            aatype = tok["seqres"][:, None].expand(B, T, L)
            atom14 = frames_torsions_to_atom14(prep.rigids, tok["torsions"], aatype)
            return atom14, torch.argmax(logits, dim=-1)
        if noise is None:
            lo, n = rows or (0, B)
            if cfg.design:
                noise = torch.cat([
                    torch.randn((n, T, L, cfg.latent_dim - 20), generator=generator,
                                device=self.device),
                    sample_dirichlet(torch.ones((n, L, 20), device=self.device),
                                     generator)[:, None].expand(n, T, L, 20),
                ], dim=-1)
            else:
                noise = torch.randn((n, T, L, cfg.latent_dim), generator=generator,
                                    device=self.device)
            noise = noise[lo:lo + B]
        sample_fn = self.sampler.sample_ode(
            self.model_inf.forward_inference, sampling_method=cfg.sampling_method,
            num_steps=cfg.inference_steps, stats=stats,
        )
        samples = sample_fn(noise.float(), **prep.model_kwargs)
        if cfg.no_frames:
            aatype = tok["seqres"][:, None].expand(B, T, L)
            return atom37_to_atom14(samples.reshape(B, T, L, 37, 3), aatype), aatype
        return decode_latents(cfg, samples, prep.rigids, tok["seqres"])

    @torch.inference_mode()
    def rollout(self, start_atom14, seqres, mask, num_rollouts: int,
                generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None, stats: Optional[list] = None):
        """Autoregressive forward simulation: start [B,L,14,3] ->
        [B, R*T, L, 14, 3]. ``noise`` [R,B,T,L,latent_dim] replaces the draws;
        ``stats``, a list, receives one dict of solver counts per rollout."""
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
            solve = {}
            atom14, _ = self.inference(
                batch, generator, None if noise is None else noise[r], solve
            )
            if stats is not None:
                stats.append(solve)
            start = atom14[:, -1]
            trajs.append(atom14)
        return torch.stack(trajs, dim=1).reshape(B, num_rollouts * T, L, 14, 3)


# -- training ------------------------------------------------------------------


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
    ``val_step``, ``eval_params`` and ``grad_report``.

    Data parallel (a process group of ``world`` ranks, read when the runtime
    is made; ``parallel.init_distributed``): each rank holds rows rank*B..
    of a global batch of world*B rows and computes what one process computes
    on the global batch. It draws t, x0, the design simplex point and the
    dropout masks for the global batch from the shared generator and keeps
    its rows; the gradients are averaged over ranks (one all-reduce per
    dtype) before the norm, the clip, the optimizer and the EMA, and the
    step's and validation's metrics are averaged too. One rank runs no
    collective."""

    def __init__(self, cfg, device="cpu"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.rank, self.world = rank(), world_size()
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

    def loss_fn(self, model, batch: dict, generator=None, t=None, x0=None, x_d=None,
                train=True, dropout_seed=None):
        """Mean flow-matching loss and its metrics. A raw batch (atom14) is
        tokenized on its device; a token dict (``tokenize_atom14``'s output)
        passes through, as in the JAX runtime. Under ``design`` ``x_d``
        [B, L, 20] replaces the simplex draw, and the metrics add the
        argmax recovery of the designed (1:-1) and conditioning residues
        and the two loss terms. With ``cfg.dropout > 0`` a train step's
        model runs with dropout: its seed is ``dropout_seed``, else drawn
        from ``generator`` before t and x0 (validation: ``train=False``,
        no dropout). With more than one rank the draws are the global
        batch's (``_global_draws``) and the metrics this rank's means."""
        cfg = self.cfg
        tok = tokenize(cfg, batch)
        prep = prep_batch(cfg, tok)
        kwargs = prep.model_kwargs
        B = prep.latents.shape[0]
        if train and cfg.dropout > 0:
            if dropout_seed is None:
                dev = generator.device if generator is not None else prep.latents.device
                dropout_seed = int(torch.randint(0, 2**62, (1,), generator=generator,
                                                 device=dev))
            kwargs = dict(kwargs, dropout_seed=dropout_seed)
            if self.world > 1:
                kwargs["dropout_rows"] = (self.rank * B, self.world * B)
        if self.world > 1:
            t, x0, x_d = self._global_draws(prep.latents, tok["seqres"], generator, t, x0, x_d)
        out = self.transport.training_losses(
            model, prep.latents, prep.loss_mask, kwargs,
            generator=generator, t=t, x0=x0,
            aatype1=tok["seqres"] if cfg.design else None, x_d=x_d,
        )
        loss = out["loss"].mean()
        metrics = {"loss": loss.detach(), "time": out["t"].mean()}
        if cfg.design:
            aa_out = torch.argmax(out["logits"].detach(), dim=-1)
            rec = (aa_out == tok["seqres"][:, None]).float()
            metrics["category_pred_design_aa_recovery"] = rec[:, :, 1:-1].mean()
            metrics["category_pred_cond_aa_recovery"] = torch.cat(
                [rec[:, :, :1], rec[:, :, -1:]], dim=2).mean()
            metrics["loss_continuous"] = out["loss_continuous"].detach().mean()
            metrics["loss_discrete"] = out["loss_discrete"].detach().mean()
        return loss, metrics

    def _global_draws(self, x1, seqres, generator, t, x0, x_d):
        """This rank's rows of t [world*B], x0 [world*B, ...] and, under
        design (not the mpnn modes), x_d [world*B, L, 20], drawn as
        ``training_losses`` draws them for the global batch (a given t, x0 or
        x_d is this rank's rows and stays)."""
        cfg = self.cfg
        B = x1.shape[0]
        lo, n = self.rank * B, self.world * B
        rows = slice(lo, lo + B)
        t_all = self.transport.sample_t(n, generator, x1.device) if t is None \
            else process_allgather(t)
        if x0 is None:
            x0 = torch.randn((n, *x1.shape[1:]), generator=generator, device=x1.device,
                             dtype=x1.dtype)[rows]
        if cfg.design and not (cfg.dynamic_mpnn or cfg.mpnn) and x_d is None:
            x_d = self.transport.sample_x_d(t_all, process_allgather(seqres), generator)[rows]
        return t_all[rows], x0, x_d

    def _mean_over_ranks(self, metrics: dict) -> dict:
        if self.world == 1:
            return metrics
        means = all_reduce_mean([torch.stack([v.float() for v in metrics.values()])])[0]
        return dict(zip(metrics, means))

    def _grads(self, model, batch, generator=None, t=None, x0=None, x_d=None,
               dropout_seed=None):
        params = list(model.parameters())
        loss, metrics = self.loss_fn(model, batch, generator, t, x0, x_d,
                                     dropout_seed=dropout_seed)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        return params, all_reduce_mean(grads), self._mean_over_ranks(metrics)

    def train_step(self, state: TrainState, batch: dict, generator=None, t=None, x0=None):
        """One micro-step: gradient, optimizer (which applies an update on
        every ``accumulate_grad``-th call), EMA and the step counter, which
        both advance on every call. ``grad_norm`` is this micro-batch's
        (the global batch's, averaged over ranks)."""
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
        return self._mean_over_ranks(self.loss_fn(model, batch, generator, t, x0,
                                                  train=False)[1])

    def eval_params(self, state: TrainState) -> LatentMDGenModel:
        """The model to evaluate with: the EMA copy when enabled."""
        return state.ema if self.cfg.ema else state.model

    def grad_report(self, state: TrainState, batch: dict, generator=None) -> dict:
        """{parameter name: gradient norm} for ``--check_grad``."""
        names = [n for n, _ in state.model.named_parameters()]
        _, grads, _ = self._grads(state.model, batch, generator)
        return {n: float(torch.linalg.vector_norm(g)) for n, g in zip(names, grads)}
