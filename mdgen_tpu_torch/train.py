"""Training entry point: the repository's ``train.py`` on PyTorch.

    python -m mdgen_tpu_torch.train --sim_condition --train_split splits/4AA_train.csv \\
        --val_split splits/4AA_val.csv --data_dir data/4AA_sims --num_frames 1000 \\
        --prepend_ipa --abs_pos_emb --abs_time_emb --crop 4 --run_name my_run

The same flags and loop as the JAX trainer: epochs of shuffled batches
(``--train_batches`` / ``--val_batches`` cap them), validation with the EMA
weights every ``--val_epoch_freq`` epochs, ``--ckpt RUN`` resumes at epoch
step // steps per epoch, a SIGTERM or a ``RUN/STOP`` file ends the run with a
checkpoint, ``--keep_ckpts`` rotates ``RUN/step_*``, ``--check_grad`` reports
parameters without gradient. The run lives in ``WORKDIR/RUN_NAME``
(``config.json``, ``step_N/model.pt``, ``log.out`` and metric CSVs). It
needs a CUDA device unless ``--device cpu`` is given; ``--seed`` drives the
initialization, the window draws, the shuffles and the loss's noise.
One process, one device: the multi-host flags, ``--dp_size > 1`` and
``--wandb`` are refused, as is the designability probe
(``--inference_batches``).
"""
from __future__ import annotations

import argparse
import os
import time

import torch


def parse_args(argv=None):
    from .config import add_model_args

    p = argparse.ArgumentParser()
    p.add_argument("--ckpt", type=str, default=None)
    p.add_argument("--validate", action="store_true")
    p.add_argument("--num_workers", type=int, default=4)  # unused (device tokenization)
    p.add_argument("--train_split", type=str, required=True)
    p.add_argument("--val_split", type=str, required=True)
    p.add_argument("--data_dir", type=str, required=True)
    p.add_argument("--run_name", type=str, default="default")
    p.add_argument("--workdir", type=str, default="workdir",
                   help="runs live in WORKDIR/RUN_NAME")
    p.add_argument("--print_freq", type=int, default=100)
    p.add_argument("--ckpt_freq", type=int, default=1)
    p.add_argument("--wandb", action="store_true")
    p.add_argument("--train_batches", type=int, default=None)
    p.add_argument("--val_batches", type=int, default=None)
    p.add_argument("--val_repeat", type=int, default=1)
    p.add_argument("--val_freq", type=int, default=None,
                   help="also validate every N train steps")
    p.add_argument("--val_epoch_freq", type=int, default=1)
    p.add_argument("--no_validate", action="store_true")
    p.add_argument("--designability_freq", type=int, default=1)
    p.add_argument("--inference_batches", type=int, default=0)
    p.add_argument("--seed", type=int, default=137)
    p.add_argument("--check_grad", action="store_true",
                   help="after the first step, warn about parameters with zero gradient")
    p.add_argument("--profile_steps", type=int, default=0,
                   help="write a torch.profiler trace of N steps (starting at step 10) "
                        "to RUN/trace")
    p.add_argument("--stop_check_freq", type=int, default=20,
                   help="poll for SIGTERM / RUN/STOP every N steps; on stop, save a "
                        "checkpoint and exit 0 (0 or negative disables polling)")
    p.add_argument("--keep_ckpts", type=int, default=3,
                   help="retain only the newest N step_* checkpoints (0 = keep all)")
    p.add_argument("--coordinator_address", type=str, default=None)
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    p.add_argument("--device", type=str, default="cuda")
    add_model_args(p)
    return p.parse_args(argv)


def _refuse_unported(args, cfg) -> None:
    if args.coordinator_address or args.num_processes or args.process_id is not None:
        raise NotImplementedError("multi-host training is not ported (ROADMAP queue 1, item 15)")
    if cfg.dp_size > 1:
        raise NotImplementedError("--dp_size > 1 is not ported (ROADMAP queue 1, item 15)")
    if args.wandb:
        raise NotImplementedError("--wandb is not ported: metrics go to log.out and CSVs")
    if args.inference_batches:
        raise NotImplementedError(
            "--inference_batches (the designability probe) is not ported; sample with "
            "python -m mdgen_tpu_torch.sim_inference --sim_ckpt RUN"
        )


def _floats(metrics: dict) -> dict:
    return {k: float(v) for k, v in metrics.items()}


def main(argv=None) -> dict:
    """Returns {"model_dir", "step", "losses", "step_end": host clock after
    each train step, synchronized}."""
    args = parse_args(argv)
    from .config import config_from_args

    cfg = config_from_args(args)
    _refuse_unported(args, cfg)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass --device cpu to train on the CPU")

    from .data import Loader, MDGenDataset
    from .runtime import TrainRuntime, batch_to_device, checkpoint
    from .runtime.metrics import MetricLogger
    from .runtime.preempt import GracefulStop

    os.environ["MODEL_DIR"] = model_dir = os.path.join(args.workdir, args.run_name)
    os.makedirs(model_dir, exist_ok=True)
    logger = MetricLogger(model_dir=model_dir)
    log = logger.logger
    log.info(f"device: {device}" + (f" ({torch.cuda.get_device_name(device)})"
                                    if device.type == "cuda" else ""))
    log.info(f"config: {cfg.to_json()}")

    trainset = MDGenDataset(cfg, args.train_split, args.data_dir, seed=args.seed)
    valset = trainset if cfg.overfit else MDGenDataset(
        cfg, args.val_split, args.data_dir, repeat=args.val_repeat, seed=args.seed + 1)
    train_loader = Loader(trainset, cfg.batch_size, shuffle=True, seed=args.seed,
                          max_batches=args.train_batches)
    val_loader = Loader(valset, cfg.batch_size, shuffle=False, seed=args.seed,
                        max_batches=args.val_batches)
    if len(train_loader) == 0:
        raise ValueError(f"{len(trainset)} training items make no batch of {cfg.batch_size} "
                         "(the loader drops the last partial batch)")

    rt = TrainRuntime(cfg, device)
    state = rt.init(torch.Generator().manual_seed(args.seed))
    generator = torch.Generator(device=device).manual_seed(args.seed)
    log.info(f"model parameters: {sum(p.numel() for p in state.model.parameters()):,}")

    start_epoch = 0
    if args.ckpt:
        state, step = checkpoint.load_train_checkpoint(args.ckpt, state)
        start_epoch = step // len(train_loader)
        log.info(f"restored checkpoint at step {step} (resuming at epoch {start_epoch})")

    def run_validation(epoch):
        model = rt.eval_params(state)
        for batch in val_loader:
            batch.pop("name")
            metrics = rt.val_step(model, batch_to_device(batch, device), generator)
            logger.log_dict(_floats(metrics), "val")
        logger.flush("val", epoch=epoch, step=state.step, save=True)

    if args.validate:
        run_validation(0)
        return {"model_dir": model_dir, "step": state.step, "losses": [], "step_end": []}

    stopper = GracefulStop(os.path.join(model_dir, "STOP"))
    if stopper.clear_sentinel(model_dir):
        log.warning("removed stale STOP sentinel from a previous run")
    elif os.path.exists(stopper.sentinel_path):
        log.warning("pre-queued STOP sentinel present: this run will checkpoint and exit "
                    "within --stop_check_freq steps")

    def stop_requested(step):
        return args.stop_check_freq > 0 and step % args.stop_check_freq == 0 and stopper.poll()

    check_grad_pending = args.check_grad
    profiler = None
    losses, step_end = [], []
    stopped = False
    try:
        for epoch in range(start_epoch, cfg.epochs):
            for batch in train_loader:
                batch.pop("name", None)
                batch = batch_to_device(batch, device)
                if args.profile_steps and state.step == 10:
                    profiler = _start_profiler(device)
                t0 = time.perf_counter()
                state, metrics = rt.train_step(state, batch, generator)
                metrics = _floats(metrics)  # synchronizes
                step_end.append(time.perf_counter())
                losses.append(metrics["loss"])
                if check_grad_pending and state.step >= 2:
                    # after one optimizer step the adaLN-zero gates are nonzero,
                    # so every live parameter should receive gradient
                    norms = rt.grad_report(state, batch, generator)
                    dead = [k for k, v in norms.items() if v == 0.0]
                    for k in dead:
                        log.warning(f"param {k} has no grad")
                    log.info(f"check_grad: {len(dead)}/{len(norms)} zero-grad params")
                    check_grad_pending = False
                if profiler is not None and state.step == 10 + args.profile_steps:
                    _stop_profiler(profiler, model_dir, log)
                    profiler = None
                logger.log_dict(metrics, "train")
                if state.step % args.print_freq == 0:
                    logger.log("dur", step_end[-1] - t0, "train")
                    logger.flush("iter", epoch=epoch, step=state.step)
                if args.val_freq and state.step % args.val_freq == 0:
                    run_validation(epoch)
                if stop_requested(state.step):
                    stopped = True
                    break
            logger.flush("train", epoch=epoch, step=state.step, save=True)
            if stopped:
                log.info(f"graceful stop (SIGTERM or STOP sentinel) at step {state.step}; "
                         "saving final checkpoint")
                break
            if not args.no_validate and (epoch + 1) % args.val_epoch_freq == 0:
                run_validation(epoch)
            if (epoch + 1) % args.ckpt_freq == 0:
                path = checkpoint.save_train_checkpoint(model_dir, cfg, state, args.keep_ckpts)
                log.info(f"saved checkpoint: {path}")
        checkpoint.save_train_checkpoint(model_dir, cfg, state, args.keep_ckpts)
    finally:
        stopper.close()
        if profiler is not None:
            profiler.stop()
    return {"model_dir": model_dir, "step": state.step, "losses": losses, "step_end": step_end}


def _start_profiler(device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    return prof


def _stop_profiler(prof, model_dir, log):
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.stop()
    os.makedirs(os.path.join(model_dir, "trace"), exist_ok=True)
    path = os.path.join(model_dir, "trace", "trace.json")
    prof.export_chrome_trace(path)
    log.info(f"profiler trace written to {path}\n"
             + prof.key_averages().table(sort_by="self_device_time_total", row_limit=25))


if __name__ == "__main__":
    main()
