"""Port checkpoints (``torch.save`` form of ``mdgen_tpu/runtime/checkpoint.py``).

Two layouts, both with ``config.json`` (the JSON of ``MDGenConfig.to_json``):

  * a training run: ``RUN/config.json`` + ``RUN/step_N/model.pt`` holding
    {"model", "ema", "optimizer", "step"} (:func:`save_train_checkpoint`).
    ``keep_last_n`` prunes the older ``step_*`` directories by write time,
    not by step number, and ``runtime/preempt.py`` reads the same mtimes to
    tell a consumed STOP sentinel from a queued one;
  * a flat weights directory: ``DIR/config.json`` + ``DIR/model.pt`` with
    {"model", "ema", "step"} (:func:`save_checkpoint`, the output of
    ``tools/jax_to_torch_ckpt.py``).

:func:`load_model` reads either: a flat directory, or a run's newest step.
"""
from __future__ import annotations

import os
import shutil
from typing import Optional

import torch

from ..config import MDGenConfig
from ..models import LatentMDGenModel

CONFIG_FILE = "config.json"
WEIGHTS_FILE = "model.pt"


def _write_config(ckpt_dir: str, cfg) -> None:
    os.makedirs(ckpt_dir, exist_ok=True)
    with open(os.path.join(ckpt_dir, CONFIG_FILE), "w") as fh:
        fh.write(cfg.to_json())


def save_checkpoint(ckpt_dir: str, cfg, state_dict: dict, step: int = 0,
                    ema_state_dict: dict | None = None) -> str:
    """Flat weights directory; returns the path of ``model.pt``."""
    _write_config(ckpt_dir, cfg)
    path = os.path.join(ckpt_dir, WEIGHTS_FILE)
    torch.save({"model": state_dict, "ema": ema_state_dict, "step": int(step)}, path)
    return path


def _step_dirs(run_dir: str) -> list[str]:
    if not os.path.isdir(run_dir):
        return []
    return [d for d in os.listdir(run_dir)
            if d.startswith("step_") and d.split("_", 1)[1].isdigit()]


def latest_step(run_dir: str) -> Optional[int]:
    steps = [int(d.split("_", 1)[1]) for d in _step_dirs(run_dir)]
    return max(steps) if steps else None


def save_train_checkpoint(run_dir: str, cfg, state, keep_last_n: int = 0) -> str:
    """Write ``step_{state.step}`` (model, EMA, optimizer state, step); with
    ``keep_last_n > 0`` keep only the newest N step directories by mtime
    (a reused run directory may hold stale higher steps). Returns the step
    directory."""
    _write_config(run_dir, cfg)
    path = os.path.join(run_dir, f"step_{state.step}")
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, WEIGHTS_FILE + ".tmp")
    torch.save({
        "model": state.model.state_dict(),
        "ema": state.ema.state_dict() if state.ema is not None else None,
        "optimizer": state.opt_state,
        "step": int(state.step),
    }, tmp)
    os.replace(tmp, os.path.join(path, WEIGHTS_FILE))  # also bumps the step dir's mtime
    if keep_last_n > 0:
        dirs = sorted(_step_dirs(run_dir),
                      key=lambda d: os.path.getmtime(os.path.join(run_dir, d)))
        for d in dirs[:-keep_last_n]:
            shutil.rmtree(os.path.join(run_dir, d))
    return path


def _load(path: str, device="cpu") -> dict:
    return torch.load(path, map_location=device, weights_only=True)


def load_train_checkpoint(run_dir: str, state, step: Optional[int] = None):
    """Restore ``step`` (default: the newest) into ``state`` in place, on the
    state's device. Returns (state, step)."""
    step = latest_step(run_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no step_* checkpoints under {run_dir}")
    device = next(state.model.parameters()).device
    blob = _load(os.path.join(run_dir, f"step_{step}", WEIGHTS_FILE), device)
    state.model.load_state_dict(blob["model"])
    if state.ema is not None:
        state.ema.load_state_dict(blob["ema"])
    state.opt_state = blob["optimizer"]
    state.step = int(blob["step"])
    return state, step


def load_config(ckpt_dir: str):
    with open(os.path.join(ckpt_dir, CONFIG_FILE)) as fh:
        return MDGenConfig.from_json(fh.read())


def weights_path(ckpt_dir: str) -> str:
    """``model.pt`` of a flat directory, else of a run's newest step."""
    flat = os.path.join(ckpt_dir, WEIGHTS_FILE)
    if os.path.exists(flat):
        return flat
    step = latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no {WEIGHTS_FILE} or step_* checkpoint under {ckpt_dir}")
    return os.path.join(ckpt_dir, f"step_{step}", WEIGHTS_FILE)


def load_model(ckpt_dir: str, cfg=None, device="cpu"):
    """Build the model and load the weights to evaluate with (the EMA copy
    when ``cfg.ema`` and one was saved). Returns (model, step)."""
    cfg = cfg or load_config(ckpt_dir)
    blob = _load(weights_path(ckpt_dir))
    sd = blob["ema"] if cfg.ema and blob.get("ema") is not None else blob["model"]
    model = LatentMDGenModel(cfg, cfg.latent_dim)
    model.load_state_dict(sd)
    return model.to(device).eval(), blob.get("step", 0)
