"""Task layer: tokenized batches -> model inputs, and latents -> atoms.

Port of ``mdgen_tpu/tasks.py`` (the upsampling window packing numpy
only). Latent layout per frame and residue: [offset tensor-7 (+7 reverse
offsets for endpoint tasks) | 14 torsion sin/cos | 20 design simplex
channels (design only)]; under ``no_frames`` the 111 flattened atom37
coordinates.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .geometry import Rigid, canonicalize_quat_sign, frames_torsions_to_atom14, get_offsets

DESIGN_IDX = (1, 2)
COND_IDX = (0, 3)
DESIGN_MAP_TO_COND = (0, 0, 3, 3)


class PreparedBatch(NamedTuple):
    latents: torch.Tensor  # [B, T, L, latent_dim]
    loss_mask: torch.Tensor  # [B, T, L, latent_dim_continuous]
    rigids: Optional[Rigid]  # [B, T, L]
    model_kwargs: dict


def build_cond_mask(cfg, B: int, T: int, L: int, device=None) -> torch.Tensor:
    """Which latent tokens are given: sim frame 0; tps frames 0 and -1;
    upsampling every cond_interval-th frame; inpainting residues COND_IDX."""
    mask = torch.zeros((B, T, L), dtype=torch.int32, device=device)
    if cfg.sim_condition:
        mask[:, 0] = 1
    if cfg.tps_condition:
        mask[:, 0] = 1
        mask[:, -1] = 1
    if cfg.cond_interval:
        mask[:, :: cfg.cond_interval] = 1
    if cfg.inpainting or cfg.dynamic_mpnn or cfg.mpnn:
        for i in COND_IDX:  # one residue at a time: a CUDA graph captures no host index
            mask[:, :, i] = 1
    return mask


def masked_aatype(cfg, seqres: torch.Tensor) -> torch.Tensor:
    """Designed positions become UNK=20."""
    if cfg.design:
        seqres = seqres.clone()
        for i in DESIGN_IDX:
            seqres[:, i] = 20
    return seqres


def prep_batch(cfg, batch: dict) -> PreparedBatch:
    """Tokenized batch {torsions [B,T,L,7,2], torsion_mask [B,L,7],
    trans [B,T,L,3], rots [B,T,L,3,3], seqres [B,L], mask [B,L]} ->
    latents, loss mask and denoiser kwargs."""
    if cfg.no_frames:
        return prep_batch_no_frames(cfg, batch)
    rigids = Rigid(batch["rots"], batch["trans"])
    B, T, L = rigids.batch_shape

    if cfg.design_key_frames:
        idx = list(DESIGN_MAP_TO_COND)
        rigids = Rigid.cat(
            [rigids[:, :1][:, :, idx], rigids[:, 1:-1], rigids[:, -1:][:, :, idx]],
            axis=1,
        )

    if cfg.no_offsets:
        offsets = rigids.to_tensor_7()
    else:
        offsets = get_offsets(rigids[:, 0:1], rigids)
    offsets = canonicalize_quat_sign(offsets)

    frame_loss_mask = batch["mask"][..., None].expand(B, L, 7)
    torsion_loss_mask = (
        batch["torsion_mask"][..., None].expand(B, L, 7, 2).reshape(B, L, 14)
    )
    if cfg.tps_condition or cfg.inpainting or cfg.dynamic_mpnn:
        offsets_r = canonicalize_quat_sign(get_offsets(rigids[:, -1:], rigids))
        offsets = torch.cat([offsets, offsets_r], dim=-1)
        frame_loss_mask = torch.cat([frame_loss_mask, frame_loss_mask], dim=-1)

    torsions = batch["torsions"].reshape(B, T, L, 14)
    if cfg.no_torsion:
        torsions = torch.zeros_like(torsions)
    elif cfg.no_design_torsion:
        torsions = torsions.clone()
        for i in DESIGN_IDX:
            torsions[:, :, i] = 0.0
    latents = torch.cat([offsets, torsions], dim=-1)

    if cfg.supervise_all_torsions:
        torsion_loss_mask = torch.ones_like(torsion_loss_mask)
    elif cfg.supervise_no_torsions:
        torsion_loss_mask = torch.zeros_like(torsion_loss_mask)
    if cfg.chi_loss_weight != 1.0 or cfg.chi_loss_weights:
        w = torch.ones(14, device=latents.device)
        w[6:] = cfg.chi_loss_weight
        if cfg.chi_loss_weights:
            per_chi = [float(v) for v in cfg.chi_loss_weights.split(",")]
            if len(per_chi) != 4:
                raise ValueError(f"chi_loss_weights needs 4 values, got {cfg.chi_loss_weights!r}")
            w[6:] *= torch.tensor(per_chi, device=w.device).repeat_interleave(2)
        torsion_loss_mask = torsion_loss_mask.float() * w
        frame_loss_mask = frame_loss_mask.float()
    loss_mask = torch.cat([frame_loss_mask, torsion_loss_mask], dim=-1)
    loss_mask = loss_mask[:, None].expand(B, T, L, loss_mask.shape[-1])

    cond_mask = build_cond_mask(cfg, B, T, L, device=latents.device)
    model_kwargs = {
        "start_frames": rigids[:, 0],
        "end_frames": rigids[:, -1],
        "mask": batch["mask"][:, None].expand(B, T, L),
        "aatype": masked_aatype(cfg, batch["seqres"]),
        "x_cond": torch.where(cond_mask[..., None].bool(), latents, 0.0),
        "x_cond_mask": cond_mask,
    }
    return PreparedBatch(latents, loss_mask, rigids, model_kwargs)


def prep_batch_no_frames(cfg, batch: dict) -> PreparedBatch:
    """The raw-atom37 ablation: {atom37 [B,T,L,37,3], seqres [B,L], mask
    [B,L,37]} -> latents [B,T,L,111] (the flattened coordinates), the loss
    mask of the present atoms, the residue mask (from the N atom), and frame
    0 given under ``sim_condition``; no frames."""
    B, T, L = batch["atom37"].shape[:3]
    latents = batch["atom37"].reshape(B, T, L, 111)
    mask = batch["mask"][:, None, :, 1].expand(B, T, L)
    loss_mask = batch["mask"][:, None, :, :, None].expand(B, T, L, 37, 3).reshape(B, T, L, 111)
    cond_mask = torch.zeros((B, T, L), dtype=torch.int32, device=latents.device)
    if cfg.sim_condition:
        cond_mask[:, 0] = 1
    model_kwargs = {
        "mask": mask,
        "aatype": batch["seqres"],
        "x_cond": torch.where(cond_mask[..., None].bool(), latents, 0.0),
        "x_cond_mask": cond_mask,
    }
    return PreparedBatch(latents, loss_mask, None, model_kwargs)


def build_upsampling_windows(tok: dict, num_frames: int, cond_interval: int):
    """Pack a low-framerate token trajectory into inpainting windows.

    Each window holds ``num_frames // cond_interval`` kept frames at every
    ``cond_interval``-th slot, zeros + identity rotations in between
    (reference `upsampling_inference.py:47-66`).

    tok: single-trajectory token dict {torsions [T0,L,7,2], torsion_mask,
    trans, rots, seqres, mask}. Returns a list of window dicts (numpy).
    """
    import numpy as np

    kept_per_window = num_frames // cond_interval
    T0, L = tok["torsions"].shape[:2]
    n_windows = T0 // kept_per_window
    out = []
    for w in range(n_windows):
        sel = slice(w * kept_per_window, (w + 1) * kept_per_window)
        torsions = np.zeros((num_frames, L, 7, 2), np.float32)
        trans = np.zeros((num_frames, L, 3), np.float32)
        rots = np.broadcast_to(
            np.eye(3, dtype=np.float32), (num_frames, L, 3, 3)
        ).copy()
        torsions[::cond_interval] = tok["torsions"][sel]
        trans[::cond_interval] = tok["trans"][sel]
        rots[::cond_interval] = tok["rots"][sel]
        out.append(
            {
                "torsions": torsions,
                "torsion_mask": np.asarray(tok["torsion_mask"], np.float32),
                "trans": trans,
                "rots": rots,
                "seqres": np.asarray(tok["seqres"]),
                "mask": np.asarray(tok["mask"], np.float32),
            }
        )
    return out


def pad_window_groups(windows: list, batch_size: int):
    """Split ``windows`` into full batches of ``batch_size``, padding the
    trailing partial group by repeating its last element. Yields
    ``(group, n_real)``; callers keep only the first ``n_real`` outputs of
    the padded group, so no trajectory tail is dropped."""
    for i in range(0, len(windows), batch_size):
        group = windows[i : i + batch_size]
        n_real = len(group)
        if n_real < batch_size:
            group = group + [group[-1]] * (batch_size - n_real)
        yield group, n_real


def decode_latents(cfg, samples: torch.Tensor, rigids: Rigid, seqres: torch.Tensor):
    """Sampled latents -> (atom14 [B,T,L,14,3], aa_out [B,T,L])."""
    B, T, L, _ = samples.shape
    offsets = samples[..., :7]
    if cfg.tps_condition or cfg.inpainting:
        torsions = samples[..., 14:28]
    else:
        torsions = samples[..., 7:21]
    if cfg.no_offsets:
        frames = Rigid.from_tensor_7(offsets, normalize_quats=True)
    else:
        frames = rigids[:, 0:1].compose(Rigid.from_tensor_7(offsets, normalize_quats=True))
    torsions = torsions.reshape(B, T, L, 7, 2)
    if not cfg.oracle:
        torsions = torsions / torch.linalg.norm(torsions, dim=-1, keepdim=True)
    aatype = seqres[:, None].expand(B, T, L)
    atom14 = frames_torsions_to_atom14(frames, torsions, aatype)
    aa_out = torch.argmax(samples[..., -20:], dim=-1) if cfg.design else aatype
    return atom14, aa_out
