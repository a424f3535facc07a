"""Reference (PyTorch Lightning) MDGen checkpoint -> a port run directory.

    python -m mdgen_tpu_torch.port_checkpoint --ckpt epoch=313-step=704999.ckpt \\
        --out workdir/ported_sim

The port's counterpart of ``tools/port_checkpoint.py``, with no jax. The
output is the directory a training run writes (``runtime/checkpoint.py``):
``OUT/config.json`` and ``OUT/step_N/model.pt`` holding the model, the EMA,
a fresh optimizer state and the step, so every inference CLI
(``sim_inference --sim_ckpt OUT``, ...) and ``train --ckpt OUT`` read it as
one of their own.

What it reads from the ``.ckpt`` (``torch.load(weights_only=False)``: the
hyper-parameters hold an ``argparse.Namespace``):
  * ``hyper_parameters.args``: the training flags; their names are the
    config's fields, so ``config_from_args`` takes them as they are, and the
    Lightning precision string maps through ``interop.PRECISION_MAP``;
  * ``state_dict``: the wrapper's parameters under the ``model.`` prefix,
    mapped onto the port's layout by ``interop.reference_to_state_dict``
    and loaded strictly;
  * ``ema`` ({"params": the model's keys, "decay"}), required when the
    config says ``--ema``: inference then uses the EMA weights;
  * ``global_step``, kept as the checkpoint's step.
Adam's moments do not carry over: the optimizer state is fresh. Hyena
checkpoints raise (no reference layout of the Hyena operator is mapped).
"""
from __future__ import annotations

import argparse


def port_lightning_checkpoint(ckpt_path: str, out_dir: str, precision: str | None = None,
                              step: int | None = None) -> str:
    """Port one Lightning ``.ckpt`` into ``out_dir``; returns the written
    ``step_N`` directory."""
    import torch

    from .config import config_from_args
    from .interop import PRECISION_MAP, reference_to_state_dict
    from .runtime import TrainRuntime
    from .runtime.checkpoint import save_train_checkpoint

    ckpt = torch.load(ckpt_path, map_location="cpu", weights_only=False)
    args = ckpt["hyper_parameters"]["args"]
    cfg = config_from_args(args)
    lightning_prec = getattr(args, "precision", "32-true")
    cfg = cfg.replace(precision=precision or PRECISION_MAP.get(str(lightning_prec), "32-true"))

    prefix = "model."
    sd = {k[len(prefix):]: v for k, v in ckpt["state_dict"].items() if k.startswith(prefix)}
    state = TrainRuntime(cfg).init(state_dict=reference_to_state_dict(sd, cfg))
    if cfg.ema:
        if "ema" not in ckpt:
            raise ValueError(f"{ckpt_path}: config says --ema but no 'ema' entry in the "
                             "checkpoint (the reference's on_save_checkpoint always writes it)")
        state.ema.load_state_dict(reference_to_state_dict(ckpt["ema"]["params"], cfg))
    state.step = int(step if step is not None else ckpt.get("global_step", 0))
    return save_train_checkpoint(out_dir, cfg, state)


def main(argv=None) -> str:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--ckpt", required=True, help="reference Lightning .ckpt file")
    p.add_argument("--out", required=True, help="output run directory (config.json + step_N)")
    p.add_argument("--precision", choices=["32-true", "bf16-mixed"], default=None,
                   help="override the serving precision (default: mapped from the "
                        "checkpoint's Lightning precision string)")
    p.add_argument("--step", type=int, default=None,
                   help="override the stored step (default: global_step)")
    args = p.parse_args(argv)
    path = port_lightning_checkpoint(args.ckpt, args.out, precision=args.precision,
                                     step=args.step)
    print(f"ported {args.ckpt} -> {path}")
    return path


if __name__ == "__main__":
    main()
