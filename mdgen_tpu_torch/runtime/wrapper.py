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

from .. import tracing
from ..geometry import (
    atom14_to_atom37,
    atom14_to_frames,
    atom37_to_atom14,
    atom37_to_torsions,
    frames_torsions_to_atom14,
)
from ..geometry import constants as rc
from ..models import LatentMDGenModel
from ..parallel import all_reduce_sum, make_grid, shard_model, sp_size, world_size
from ..parallel.mesh import full_tensors, global_sq_norm, shard_tensors
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
    """Inference on one rank, or on the data-parallel ranks of ``dp`` (a
    mesh axis), each with its rows of every batch (``rows``)."""

    def __init__(self, cfg, model: LatentMDGenModel, dp=None):
        self.cfg = cfg
        self.model = model
        self.dp = dp
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
        data-parallel rank), padded past n with copies of row 0; the noise
        is drawn for the n rows and sliced (a pad takes row 0's), and
        dopri5's error norm is the n rows' over the ranks of ``self.dp``, so
        every rank takes the steps one rank takes."""
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
        lo, n = rows or (0, B)
        row = torch.arange(lo, lo + B, device=self.device)  # global row indices
        if noise is None:
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
            noise = noise[torch.where(row < n, row, 0)]
        error = {} if rows is None else dict(
            error_weight=(row < n).float(), error_sum=lambda t: all_reduce_sum(t, self.dp))
        sample_fn = self.sampler.sample_ode(
            self.model_inf.forward_inference, sampling_method=cfg.sampling_method,
            num_steps=cfg.inference_steps, stats=stats, **error,
        )
        samples = sample_fn(noise.float(), **prep.model_kwargs)
        if cfg.no_frames:
            aatype = tok["seqres"][:, None].expand(B, T, L)
            return atom37_to_atom14(samples.reshape(B, T, L, 37, 3), aatype), aatype
        return decode_latents(cfg, samples, prep.rigids, tok["seqres"])

    @torch.inference_mode()
    def rollout(self, start_atom14, seqres, mask, num_rollouts: int,
                generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None, stats: Optional[list] = None,
                rows: Optional[tuple] = None):
        """Autoregressive forward simulation: start [B,L,14,3] ->
        [B, R*T, L, 14, 3]. ``noise`` [R,B,T,L,latent_dim] replaces the draws;
        ``stats``, a list, receives one dict of solver counts per rollout;
        ``rows`` as ``inference``'s."""
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
                batch, generator, None if noise is None else noise[r], solve, rows
            )
            if stats is not None:
                stats.append(solve)
            start = atom14[:, -1]
            trajs.append(atom14)
        return torch.stack(trajs, dim=1).reshape(B, num_rollouts * T, L, 14, 3)


# -- training ------------------------------------------------------------------


def batch_to_device(batch: dict, device) -> dict:
    """A loader batch (numpy) -> {atom14 f32, seqres long, mask f32} tensors."""
    with tracing.span("data.to_device"):
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


# model kwargs with a frame axis (axis 1), sliced to a rank's frames under sp
_FRAME_KWARGS = ("mask", "x_cond", "x_cond_mask")


class TrainRuntime:
    """The JAX runtime's training half: ``_loss_fn``, ``train_step``,
    ``val_step``, ``eval_params`` and ``grad_report``.

    On a (dp, sp, tp) grid of ranks (``parallel.mesh``; default: every rank
    of the process group on dp) every rank computes what one process
    computes on the global batch:
      * dp: each dp index holds rows d*B.. of a global batch of dp*B rows. It
        draws t, x0, the design simplex point and the dropout masks for the
        global batch from the shared generator and keeps its rows;
      * sp: each sp index tokenizes the whole window, keeps its frames of
        the model's inputs and of x0, and the loss sums its numerator and
        denominator over sp (``mean_flat``), so every sp rank holds the
        whole loss;
      * tp: the model's projections are sharded (``parallel.shard_model``),
        and every tp rank holds the whole loss too.
    The autograd collectives sum every rank's share of a gradient, so the
    gradients are averaged over the dp x sp plane (one all-reduce per dtype,
    ``grid.data``) before the norm, the clip, the optimizer and the EMA;
    the tp ranks' replicated parameters then stay equal, and the norm
    counts each tp shard once. The metrics are averaged over that plane
    too. One rank runs no collective."""

    def __init__(self, cfg, device="cpu", grid=None):
        self.cfg = cfg
        self.device = torch.device(device)
        self.grid = grid if grid is not None else make_grid(world_size())
        # the fused sublayers are forward-only: never in the training model
        self.model_cfg = cfg.replace(fused_block=False)
        self.transport = Transport(transport_config(cfg))
        self.tx = Optimizer.from_config(cfg, norm=self._global_norm)
        self.specs, self.sharded = {}, []  # of the model, set by init
        sp = self.grid.sp
        self._reduce = (lambda t: all_reduce_sum(t, sp)) if sp_size(self.grid) > 1 else None

    def init(self, generator: Optional[torch.Generator] = None,
             state_dict: Optional[dict] = None) -> TrainState:
        """Fresh parameters from ``generator`` (or a whole ``state_dict``),
        this rank's shards of them, a fresh optimizer state and, with
        ``cfg.ema``, an EMA copy."""
        model = LatentMDGenModel(self.model_cfg, self.cfg.latent_dim)
        if state_dict is None:
            model.reset_parameters(generator)
        else:
            model.load_state_dict(state_dict)
        model = model.to(self.device)
        self.specs = shard_model(model, self.grid)
        self.sharded = [n in self.specs for n, _ in model.named_parameters()]
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
        no dropout). On a grid the batch is this rank's dp rows, whole in
        T; the draws are the global batch's (``_global_draws``; a given
        x0 is this rank's frames) and the metrics this rank's means."""
        cfg, grid = self.cfg, self.grid
        with tracing.span("train.tokenize"):
            tok = tokenize(cfg, batch)
        prep = prep_batch(cfg, tok)
        x1, loss_mask, kwargs = prep.latents, prep.loss_mask, prep.model_kwargs
        if grid.sp.size > 1:
            x1, loss_mask = grid.frames(x1), grid.frames(loss_mask)
            kwargs = {k: grid.frames(v) if k in _FRAME_KWARGS else v for k, v in kwargs.items()}
        B, dp = x1.shape[0], grid.dp
        if train and cfg.dropout > 0:
            if dropout_seed is None:
                dev = generator.device if generator is not None else x1.device
                dropout_seed = int(torch.randint(0, 2**62, (1,), generator=generator,
                                                 device=dev))
            kwargs = dict(kwargs, dropout_seed=dropout_seed)
            if dp.size > 1:
                kwargs["dropout_rows"] = (dp.index * B, dp.size * B)
        if dp.size > 1 or grid.sp.size > 1:
            t, x0, x_d = self._global_draws(x1, tok["seqres"], generator, t, x0, x_d)
        out = self.transport.training_losses(
            model, x1, loss_mask, kwargs,
            generator=generator, t=t, x0=x0,
            aatype1=tok["seqres"] if cfg.design else None, x_d=x_d, reduce=self._reduce,
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
        """This rank's rows of t [dp*B], x0 [dp*B, T, ...] (and its frames
        of T) and, under design (not the mpnn modes), x_d [dp*B, L, 20],
        drawn as ``training_losses`` draws them for the global batch (a
        given t, x0 or x_d is this rank's part and stays)."""
        cfg, grid = self.cfg, self.grid
        B = x1.shape[0]
        lo, n = grid.dp.index * B, grid.dp.size * B
        rows = slice(lo, lo + B)
        t_all = self.transport.sample_t(n, generator, x1.device) if t is None \
            else grid.dp.gather(t)
        if x0 is None:
            shape = (n, x1.shape[1] * grid.sp.size, *x1.shape[2:])
            x0 = grid.frames(torch.randn(shape, generator=generator, device=x1.device,
                                         dtype=x1.dtype)[rows])
        if cfg.design and not (cfg.dynamic_mpnn or cfg.mpnn) and x_d is None:
            x_d = self.transport.sample_x_d(t_all, grid.dp.gather(seqres), generator)[rows]
        return t_all[rows], x0, x_d

    def _mean_over_ranks(self, metrics: dict) -> dict:
        if self.grid.data.size == 1:
            return metrics
        means = self.grid.data.mean([torch.stack([v.float() for v in metrics.values()])])[0]
        return dict(zip(metrics, means))

    def _global_norm(self, grads) -> torch.Tensor:
        """The one-process gradients' global norm: each tp shard once. A
        device tensor on the card, which the host does not read."""
        if self.grid.tp.size == 1:
            return global_norm(grads)
        return torch.sqrt(global_sq_norm(grads, self.sharded, self.grid.tp))

    def _grads(self, model, batch, generator=None, t=None, x0=None, x_d=None,
               dropout_seed=None):
        params = list(model.parameters())
        with tracing.span("train.forward"):
            loss, metrics = self.loss_fn(model, batch, generator, t, x0, x_d,
                                         dropout_seed=dropout_seed)
        with tracing.span("train.backward"):
            grads = torch.autograd.grad(loss, params, allow_unused=True)
            # contiguous, as the optimizer's kernels take them
            grads = [torch.zeros_like(p) if g is None else g.contiguous()
                     for p, g in zip(params, grads)]
        with tracing.span("train.grad_mean"):
            grads = self.grid.data.mean(grads)
        return params, grads, self._mean_over_ranks(metrics)

    def train_step(self, state: TrainState, batch: dict, generator=None, t=None, x0=None):
        """One micro-step: gradient, optimizer (which applies an update on
        every ``accumulate_grad``-th call), EMA and the step counter, which
        both advance on every call. ``grad_norm`` is this micro-batch's
        (the global batch's, averaged over ranks), and the norm the clip
        uses when every call applies. The optimizer moves the EMA in the
        same pass. Its phases are spans (``tracing``) that share
        ``state.step`` on entry."""
        with tracing.span("train.step", state.step):
            params, grads, metrics = self._grads(state.model, batch, generator, t, x0)
            with tracing.span("train.optimizer"):
                norm = metrics["grad_norm"] = self._global_norm(grads)
                ema = None if state.ema is None else list(state.ema.parameters())
                self.tx.step(params, grads, state.opt_state, norm, ema)
            state.step += 1
        return state, metrics

    @torch.no_grad()
    def val_step(self, model, batch: dict, generator=None, t=None, x0=None) -> dict:
        return self._mean_over_ranks(self.loss_fn(model, batch, generator, t, x0,
                                                  train=False)[1])

    def eval_params(self, state: TrainState) -> LatentMDGenModel:
        """The model to evaluate with: the EMA copy when enabled."""
        return state.ema if self.cfg.ema else state.model

    def whole_model(self, model: LatentMDGenModel) -> LatentMDGenModel:
        """``model`` unsharded, with every tensor whole, on every rank (a
        collective of the tp group): the model a grid samples with, each
        rank on its dp rows. On a dp-only grid: ``model`` itself."""
        if not self.specs and self.grid.sp.size == 1:
            return model
        whole = LatentMDGenModel(self.model_cfg, self.cfg.latent_dim)
        whole.load_state_dict(full_tensors(model.state_dict(), self.specs, self.grid.tp))
        return whole.to(self.device).requires_grad_(False)

    def full_state(self, state: TrainState) -> dict:
        """{"model", "ema", "optimizer"} of ``state`` with every tensor whole
        (gathered over tp: every rank of a tp group calls it), as a
        one-process run holds them."""
        names = [n for n, _ in state.model.named_parameters()]

        def full(named):
            return full_tensors(named, self.specs, self.grid.tp)

        opt = dict(state.opt_state)
        for key in ("mu", "nu", "acc"):
            if key in opt:
                opt[key] = list(full(dict(zip(names, opt[key]))).values())
        return {"model": full(state.model.state_dict()),
                "ema": None if state.ema is None else full(state.ema.state_dict()),
                "optimizer": opt}

    def shard_state(self, named: dict) -> dict:
        """This rank's shards of whole {name: tensor} (``full_state``'s
        inverse), for ``checkpoint.load_train_checkpoint``."""
        return shard_tensors(named, self.specs, self.grid.tp)

    def grad_report(self, state: TrainState, batch: dict, generator=None) -> dict:
        """{parameter name: gradient norm} for ``--check_grad`` (of this
        rank's shard of a tp-sharded parameter)."""
        names = [n for n, _ in state.model.named_parameters()]
        _, grads, _ = self._grads(state.model, batch, generator)
        return {n: float(torch.linalg.vector_norm(g)) for n, g in zip(names, grads)}
