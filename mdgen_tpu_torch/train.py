"""Training entry point: the repository's ``train.py`` on PyTorch.

    python -m mdgen_tpu_torch.train --sim_condition --train_split splits/4AA_train.csv \\
        --val_split splits/4AA_val.csv --data_dir data/4AA_sims --num_frames 1000 \\
        --prepend_ipa --abs_pos_emb --abs_time_emb --crop 4 --run_name my_run

The same flags and loop as the JAX trainer: epochs of shuffled batches
(``--train_batches`` / ``--val_batches`` cap them), validation with the EMA
weights every ``--val_epoch_freq`` epochs, ``--ckpt RUN`` resumes at epoch
step // steps per epoch, a SIGTERM or a ``RUN/STOP`` file ends the run with a
checkpoint, ``--keep_ckpts`` rotates ``RUN/step_*``, ``--check_grad`` reports
parameters without gradient. Every ``--print_freq`` steps the log gets the
metrics' means and each span's host ms a step (``tracing``). The run lives
in ``WORKDIR/RUN_NAME`` (``config.json``, ``step_N/model.pt``, ``log.out``
and metric CSVs). It
needs a CUDA device unless ``--device cpu`` is given; ``--seed`` drives the
initialization, the window draws, the shuffles and the loss's noise.
Design runs log the argmax recoveries and both loss terms; the
designability probe (``--inference_batches N``, every
``--designability_freq`` validated epochs) samples the first N validation
batches with the evaluation weights, logs ``design_aa_recovery`` and
``cond_aa_recovery`` to the val CSV and writes ``RUN/epoch{E}_{name}.pdb``.

On a (dp, sp, tp) grid of ranks, as the JAX trainer's mesh: ``--dp_size``
data-parallel ranks (-1: the ranks left over by the model axes, every
visible card of each host; ``--device cpu``: one rank a host) share each
global batch of ``--batch_size`` rows, ``--sp_size`` ranks share its frames
and ``--tp_size`` ranks its projections' heads and hidden units, and the run
computes what one device computes (``parallel/``, ``TrainRuntime``). Each
host runs ``dp * sp * tp / --num_processes`` ranks, started by this one
command, sp * tp of them at least (the model axes stay inside one host);
rank ``process_id * local + i`` uses ``cuda:i`` (``--device cuda:K``: every
rank on card K, with ``--dist_backend gloo``; or the CPU) and meets the
others at ``--coordinator_address HOST:PORT`` (a free local port when one
host runs them all). NCCL joins CUDA ranks, gloo CPU ones. Each dp index's
Loader reads its rows, so the ranks of one sp x tp group read the same ones.
Rank 0 alone writes ``log.out``, the CSVs and the checkpoints (whole
tensors, gathered over tp: a grid's run loads in one process and the other
way round), and its STOP poll, broadcast every ``--stop_check_freq`` steps,
stops every rank. ``--wandb`` is refused. ``--record PATH`` writes what
``main`` returns, with the rank's kernel launches, as JSON (``{rank}`` in
PATH becomes the rank).
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from . import tracing


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
    p.add_argument("--dist_backend", type=str, default=None, choices=["nccl", "gloo"],
                   help="default: nccl on CUDA, gloo on the CPU; gloo lets ranks share a card")
    p.add_argument("--record", type=str, default=None,
                   help="write each rank's losses, grad norms, step times, validation means "
                        "and kernel launches as JSON ({rank} in the path becomes the rank)")
    p.add_argument("--device", type=str, default="cuda")
    add_model_args(p)
    return p.parse_args(argv)


def _refuse_unported(args) -> None:
    if args.wandb:
        raise NotImplementedError("--wandb is not ported: metrics go to log.out and CSVs")


def _floats(metrics: dict) -> dict:
    return {k: float(v) for k, v in metrics.items()}


def main(argv=None) -> dict:
    """Returns {"model_dir", "step", "losses", "grad_norms", "step_end": host
    clock after each train step, synchronized, "val": the means of each
    validation, "launches": the kernel launch counts at the end,
    "peak_device_bytes": the card's peak allocation (None on the CPU)} of
    this host's first rank."""
    args = parse_args(argv)
    from .config import config_from_args

    from .parallel import launch, plan_ranks

    cfg = config_from_args(args)
    plan = plan_ranks(cfg.dp_size, args.device, cfg.sp_size, cfg.tp_size, args.num_processes,
                      args.process_id, args.coordinator_address, args.dist_backend)
    _refuse_unported(args)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass --device cpu to train on the CPU")
    return launch(plan, _train_rank, args, cfg, plan)


def _train_rank(rank, device, args, cfg, plan) -> dict:
    """Rank ``rank`` of the run, on ``device``, in its process group."""
    from .parallel import make_grid

    rec = _train(args, cfg, device, rank, make_grid(plan.dp, plan.sp, plan.tp))
    if args.record:
        with open(args.record.replace("{rank}", str(rank)), "w") as fh:
            json.dump(rec, fh)
    return rec


def _train(args, cfg, device, rank, grid) -> dict:
    from .data import Loader, MDGenDataset
    from .ops import launch_counts
    from .parallel import broadcast_one_to_all
    from .runtime import TrainRuntime, batch_to_device, checkpoint
    from .runtime.metrics import MetricLogger
    from .runtime.preempt import GracefulStop

    if device.type == "cuda":
        torch.cuda.set_device(device)
    model_dir = os.path.join(args.workdir, args.run_name)
    if rank == 0:
        os.environ["MODEL_DIR"] = model_dir
        os.makedirs(model_dir, exist_ok=True)
    else:
        os.environ.pop("MODEL_DIR", None)  # no log.out of this rank
    logger = MetricLogger(model_dir=model_dir if rank == 0 else None)
    log = logger.logger
    if rank > 0:
        log.setLevel("WARNING")  # rank 0 logs the run
    log.info(f"device: {device}" + (f" ({torch.cuda.get_device_name(device)})"
                                    if device.type == "cuda" else "")
             + (f"; a grid of {grid.dp.size} x {grid.sp.size} x {grid.tp.size} (dp x sp x "
                f"tp) ranks" if grid.dp.size * grid.sp.size * grid.tp.size > 1 else ""))
    log.info(f"config: {cfg.to_json()}")

    trainset = MDGenDataset(cfg, args.train_split, args.data_dir, seed=args.seed)
    valset = trainset if cfg.overfit else MDGenDataset(
        cfg, args.val_split, args.data_dir, repeat=args.val_repeat, seed=args.seed + 1)
    dp = grid.dp
    train_loader = Loader(trainset, cfg.batch_size, shuffle=True, seed=args.seed,
                          max_batches=args.train_batches, num_shards=dp.size, shard_id=dp.index)
    val_loader = Loader(valset, cfg.batch_size, shuffle=False, seed=args.seed,
                        max_batches=args.val_batches, num_shards=dp.size, shard_id=dp.index)
    if len(train_loader) == 0:
        raise ValueError(f"{len(trainset)} training items make no batch of {cfg.batch_size} "
                         "(the loader drops the last partial batch)")

    rt = TrainRuntime(cfg, device, grid)
    state = rt.init(torch.Generator().manual_seed(args.seed))
    generator = torch.Generator(device=device).manual_seed(args.seed)
    log.info(f"model parameters: {sum(p.numel() for p in state.model.parameters()):,}")

    start_epoch = 0
    if args.ckpt:
        state, step = checkpoint.load_train_checkpoint(args.ckpt, state, shard=rt.shard_state)
        start_epoch = step // len(train_loader)
        log.info(f"restored checkpoint at step {step} (resuming at epoch {start_epoch})")

    val_means = []

    def run_validation(epoch):
        model = rt.eval_params(state)
        for batch_idx, batch in enumerate(val_loader):
            names = batch.pop("name")
            batch = batch_to_device(batch, device)
            metrics = rt.val_step(model, batch, generator)
            logger.log_dict(_floats(metrics), "val")
            if batch_idx < args.inference_batches and (
                    (epoch + 1) % args.designability_freq == 0 or args.validate):
                _designability_probe(cfg, rt.whole_model(model), batch, generator, logger,
                                     os.path.join(model_dir, f"epoch{epoch}_{names[0]}.pdb"),
                                     rank, dp)
        val_means.append(logger.flush("val", epoch=epoch, step=state.step, save=True))

    def record(losses, grad_norms, step_end):
        return {"model_dir": model_dir, "step": state.step, "losses": losses,
                "grad_norms": grad_norms, "step_end": step_end, "val": val_means,
                "launches": launch_counts(),
                "peak_device_bytes": torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else None}

    if args.validate:
        run_validation(0)
        return record([], [], [])

    # rank 0 alone reads and clears the sentinel; its poll stops every rank
    stopper = GracefulStop(os.path.join(model_dir, "STOP") if rank == 0 else None)
    if rank == 0 and stopper.clear_sentinel(model_dir):
        log.warning("removed stale STOP sentinel from a previous run")
    elif rank == 0 and os.path.exists(stopper.sentinel_path):
        log.warning("pre-queued STOP sentinel present: this run will checkpoint and exit "
                    "within --stop_check_freq steps")

    def stop_requested(step):
        if args.stop_check_freq <= 0 or step % args.stop_check_freq:
            return False
        return broadcast_one_to_all(stopper.poll() if rank == 0 else False)

    def save(state):
        """Every rank gathers the whole tensors (over tp); rank 0 writes them."""
        full = rt.full_state(state) if rt.specs else None
        if rank == 0:
            return checkpoint.save_train_checkpoint(model_dir, cfg, state, args.keep_ckpts, full)

    check_grad_pending = args.check_grad
    profiler = None
    losses, grad_norms, step_end = [], [], []
    stopped = False
    spans_since = (time.perf_counter_ns(), state.step)
    try:
        for epoch in range(start_epoch, cfg.epochs):
            for batch in train_loader:
                batch.pop("name", None)
                batch = batch_to_device(batch, device)
                if args.profile_steps and state.step == 10 and rank == 0:
                    profiler = _start_profiler(device)
                t0 = time.perf_counter()
                state, metrics = rt.train_step(state, batch, generator)
                metrics = _floats(metrics)  # synchronizes
                step_end.append(time.perf_counter())
                losses.append(metrics["loss"])
                grad_norms.append(metrics["grad_norm"])
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
                    spans_since = _log_spans(log, spans_since, state.step)
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
                path = save(state)
                log.info(f"saved checkpoint: {path}")
        save(state)
    finally:
        stopper.close()
        if profiler is not None:
            profiler.stop()
    return record(losses, grad_norms, step_end)


def _designability_probe(cfg, model, batch, generator, logger, pdb_path, rank=0, dp=None):
    """Sample one validation batch with the evaluation weights (a whole
    model): log the designed (1:-1) and conditioning residues' recovery,
    the sequences, and write the first sample's trajectory to ``pdb_path``.
    On data-parallel ranks (``dp``, a mesh axis) the noise is the global
    batch's and the samples are gathered before they are scored; rank 0
    writes the PDB."""
    from .geometry.constants import aatype_to_str_sequence
    from .protein import atom14_to_pdb
    from .runtime import MDGenRuntime

    B = batch["seqres"].shape[0]
    rows = (dp.index * B, dp.size * B) if dp is not None and dp.size > 1 else None
    atom14, aa_out = MDGenRuntime(cfg.replace(fused_block=False), model, dp).inference(
        batch, generator, rows=rows)
    if rows is not None:
        atom14, aa_out, seq = (dp.gather(x) for x in (atom14, aa_out, batch["seqres"]))
    else:
        seq = batch["seqres"]
    if rank > 0:
        return
    seq = seq.cpu().numpy()
    aa_out = aa_out.cpu().numpy()
    rec = aa_out == seq[:, None, :]
    logger.log("design_aa_recovery", float(rec[:, :, 1:-1].mean()), "val")
    logger.log("cond_aa_recovery",
               float(np.concatenate([rec[:, :, :1], rec[:, :, -1:]], 2).mean()), "val")
    logger.logger.info("seq_pred=" + ",".join(aatype_to_str_sequence(a) for a in aa_out[:, 0])
                       + " seq_true=" + ",".join(aatype_to_str_sequence(a) for a in seq))
    atom14_to_pdb(atom14[0].cpu().numpy(), seq[0], pdb_path)


def _log_spans(log, since, step):
    """Log each span's mean host ms a step (``tracing``) over the steps
    since ``since`` = (host clock in ns, step), in the order the spans
    first started; returns the new mark."""
    t_ns, step0 = since
    now = time.perf_counter_ns()
    took: dict = {}
    for name, _, _, _, t0, t1 in tracing.records():
        if t0 >= t_ns:
            took[name] = took.get(name, 0) + t1 - t0
    log.info(f"host ms a step, steps {step0}-{step}: "
             + ", ".join(f"{k} {v / 1e6 / (step - step0):.3f}" for k, v in took.items()))
    return now, step


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
