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
Design runs log the argmax recoveries and both loss terms; the
designability probe (``--inference_batches N``, every
``--designability_freq`` validated epochs) samples the first N validation
batches with the evaluation weights, logs ``design_aa_recovery`` and
``cond_aa_recovery`` to the val CSV and writes ``RUN/epoch{E}_{name}.pdb``.

Data parallel, as the JAX trainer: ``--dp_size`` ranks (-1: every visible
card of each host; ``--device cpu``: one rank a host) share each global
batch of ``--batch_size`` rows, and the run computes what one device
computes (``parallel/distributed.py``, ``TrainRuntime``). Each host runs
``dp_size / --num_processes`` ranks, started by this one command; rank
``process_id * local + i`` uses ``cuda:i`` (or the CPU) and meets the others
at ``--coordinator_address HOST:PORT`` (a free local port when one host runs
them all). NCCL joins CUDA ranks, gloo CPU ones; ``--dist_backend gloo`` lets
ranks share one card. Rank 0 alone writes ``log.out``, the CSVs and the
checkpoints, and its STOP poll, broadcast every ``--stop_check_freq`` steps,
stops every rank. ``--tp_size`` / ``--sp_size`` above 1 are refused with more
than one rank (one rank builds no mesh, as in JAX), and so is ``--wandb``.
``--record PATH`` writes what ``main`` returns, with the rank's kernel
launches, as JSON (``{rank}`` in PATH becomes the rank).
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from dataclasses import dataclass

import numpy as np
import torch

from .parallel import free_port


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


@dataclass
class RankPlan:
    """Where this host's ranks run: ``world`` ranks in all, ``local`` of them
    here, ranks ``base + i`` on ``devices[i]``, meeting at ``address``."""
    world: int
    local: int
    base: int
    devices: list
    backend: str
    address: str | None


def plan_ranks(args, cfg) -> RankPlan:
    """The rank layout of ``--dp_size``, ``--num_processes``,
    ``--process_id``, ``--coordinator_address`` and ``--device``."""
    device = torch.device(args.device)
    hosts = args.num_processes or 1
    if cfg.dp_size == -1:
        per_host = torch.cuda.device_count() if device.type == "cuda" and device.index is None \
            else 1
        world = max(per_host, 1) * hosts
    else:
        world = cfg.dp_size
    if world % hosts:
        raise ValueError(f"--dp_size {world} is not a multiple of --num_processes {hosts}")
    local = world // hosts
    pid = args.process_id or 0
    if not 0 <= pid < hosts:
        raise ValueError(f"--process_id {pid} outside [0, {hosts})")
    if device.type == "cuda":
        devices = [torch.device("cuda", (device.index or 0) + i) for i in range(local)]
    else:
        devices = [device] * local
    address = args.coordinator_address
    if world > 1 and address is None:
        if hosts > 1:
            raise ValueError("--num_processes > 1 needs --coordinator_address HOST:PORT")
        address = f"localhost:{free_port()}"
    backend = args.dist_backend or ("nccl" if device.type == "cuda" else "gloo")
    return RankPlan(world, local, pid * local, devices, backend, address)


def _refuse_unported(args, cfg, world: int) -> None:
    if world > 1 and (cfg.tp_size > 1 or cfg.sp_size > 1):
        raise NotImplementedError(
            "--tp_size / --sp_size > 1 with more than one rank: tensor and sequence "
            "parallelism are not ported (ROADMAP queue 1, item 1)")
    if args.wandb:
        raise NotImplementedError("--wandb is not ported: metrics go to log.out and CSVs")


def _floats(metrics: dict) -> dict:
    return {k: float(v) for k, v in metrics.items()}


def main(argv=None) -> dict:
    """Returns {"model_dir", "step", "losses", "grad_norms", "step_end": host
    clock after each train step, synchronized, "val": the means of each
    validation, "launches": the kernel launch counts at the end} of this
    host's first rank."""
    args = parse_args(argv)
    from .config import config_from_args

    cfg = config_from_args(args)
    plan = plan_ranks(args, cfg)
    _refuse_unported(args, cfg, plan.world)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass --device cpu to train on the CPU")
    if plan.local == 1:
        return _run_rank(0, args, cfg, plan)
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="mdgen_train_") as tmp:
        out = os.path.join(tmp, "record.json")
        mp.start_processes(_spawned_rank, args=(args, cfg, plan, out), nprocs=plan.local,
                           start_method="spawn")
        with open(out) as fh:
            return json.load(fh)


def _spawned_rank(i, args, cfg, plan, out):
    if plan.devices[i].type == "cpu":  # the host's cores, shared by its ranks
        torch.set_num_threads(max(1, torch.get_num_threads() // plan.local))
    rec = _run_rank(i, args, cfg, plan)
    if i == 0:
        with open(out, "w") as fh:
            json.dump(rec, fh)


def _run_rank(i, args, cfg, plan) -> dict:
    """Rank ``plan.base + i`` of the run, on ``plan.devices[i]``."""
    from .parallel import init_distributed, shutdown

    rank, device = plan.base + i, plan.devices[i]
    init_distributed(plan.address, plan.world, rank, plan.backend, device)
    try:
        rec = _train(args, cfg, device, rank, plan.world)
    finally:
        shutdown()
    if args.record:
        with open(args.record.replace("{rank}", str(rank)), "w") as fh:
            json.dump(rec, fh)
    return rec


def _train(args, cfg, device, rank, world) -> dict:
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
             + (f"; {world} data-parallel ranks" if world > 1 else ""))
    log.info(f"config: {cfg.to_json()}")

    trainset = MDGenDataset(cfg, args.train_split, args.data_dir, seed=args.seed)
    valset = trainset if cfg.overfit else MDGenDataset(
        cfg, args.val_split, args.data_dir, repeat=args.val_repeat, seed=args.seed + 1)
    train_loader = Loader(trainset, cfg.batch_size, shuffle=True, seed=args.seed,
                          max_batches=args.train_batches, num_shards=world, shard_id=rank)
    val_loader = Loader(valset, cfg.batch_size, shuffle=False, seed=args.seed,
                        max_batches=args.val_batches, num_shards=world, shard_id=rank)
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
                _designability_probe(cfg, model, batch, generator, logger,
                                     os.path.join(model_dir, f"epoch{epoch}_{names[0]}.pdb"),
                                     rank, world)
        val_means.append(logger.flush("val", epoch=epoch, step=state.step, save=True))

    def record(losses, grad_norms, step_end):
        return {"model_dir": model_dir, "step": state.step, "losses": losses,
                "grad_norms": grad_norms, "step_end": step_end, "val": val_means,
                "launches": launch_counts()}

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

    check_grad_pending = args.check_grad
    profiler = None
    losses, grad_norms, step_end = [], [], []
    stopped = False
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
            if (epoch + 1) % args.ckpt_freq == 0 and rank == 0:
                path = checkpoint.save_train_checkpoint(model_dir, cfg, state, args.keep_ckpts)
                log.info(f"saved checkpoint: {path}")
        if rank == 0:
            checkpoint.save_train_checkpoint(model_dir, cfg, state, args.keep_ckpts)
    finally:
        stopper.close()
        if profiler is not None:
            profiler.stop()
    return record(losses, grad_norms, step_end)


def _designability_probe(cfg, model, batch, generator, logger, pdb_path, rank=0, world=1):
    """Sample one validation batch with the evaluation weights: log the
    designed (1:-1) and conditioning residues' recovery, the sequences, and
    write the first sample's trajectory to ``pdb_path``. With more than one
    rank the noise is the global batch's and the samples are gathered
    before they are scored; rank 0 writes the PDB."""
    from .geometry.constants import aatype_to_str_sequence
    from .parallel import process_allgather
    from .protein import atom14_to_pdb
    from .runtime import MDGenRuntime

    B = batch["seqres"].shape[0]
    atom14, aa_out = MDGenRuntime(cfg.replace(fused_block=False), model).inference(
        batch, generator, rows=(rank * B, world * B))
    atom14, aa_out, seq = (process_allgather(x) for x in (atom14, aa_out, batch["seqres"]))
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
