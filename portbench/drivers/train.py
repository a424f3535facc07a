"""Training cells: ``TrainRuntime.train_step`` fed by the program's dataset
and ``Loader`` (its prefetch thread, as the train CLI runs it) over a pool
of synthetic trajectories written under ``TMPDIR``.

A unit is one step, ended as the train CLI ends it: ``train_step``, then a
host read of every metric it returns. The benchmark draws each step's t and
x0 on the device and passes them in, so the reference can be given the
same. Set-up builds the one training state, runs the first three steps
through the window's own call and feed, keeps their batches, draws and
losses, the first gradient as Adam's first moment holds it and each leaf's
change after step 3 (and the EMA's), then warms up; the window continues
that same state. After the window the reference runs those three steps
from the same weights in float32 and the gaps are compared.
"""
from __future__ import annotations

import math
import os
import time

import numpy as np

from .. import weights
from ..reference import precision as rprec
from ..reference import train as rtrain
from ..synthetic import synthetic_trajectory
from .common import Base, leaf_gap, leaf_gaps, read_split, subseed

CHECKED_STEPS = 3


class Driver(Base):
    keep_tensors = False  # also keep the first gradient and the change, leaf by leaf (calibrate)

    def setup(self):
        import torch
        from mdgen_tpu_torch.data import MDGenDataset

        tr = self.traffic
        self.cfg["batch_size"] = tr["batch_size"]
        self.pcfg = self.program_config()
        self.split = self._write_pool()
        self.mark("data")
        self.loader = self.make_loader(
            MDGenDataset(self.pcfg, self.split, self.workdir, seed=subseed(self.seed, "windows")))
        self.feed = epochs(self.loader)

        w = self._weights()
        self.rt = self.make_runtime()
        self.state = self.rt.init(state_dict=w)
        self.names = [n for n, _ in self.state.model.named_parameters()]
        self.mark("weights and state")
        self.draws = torch.Generator(device=self.device).manual_seed(subseed(self.seed, "draws"))
        self.data_wait, self.kept = [], []
        for i in range(CHECKED_STEPS):
            self.unit(keep=True)
            if i == 0:  # Adam's first moment after one step: (1 - b1) g
                self.prog_grad = self._norms(m / 0.1 for m in self.state.opt_state["mu"])
                if self.keep_tensors:
                    self.prog_grad_t = [(m / 0.1).float().cpu() for m in self.state.opt_state["mu"]]
        params = dict(self.state.model.named_parameters())
        self.prog_change = self._norms(params[n].detach() - w[n] for n in self.names)
        if self.keep_tensors:
            self.prog_change_t = [(params[n].detach() - w[n]).float().cpu() for n in self.names]
        if self.state.ema is not None:
            ema = dict(self.state.ema.named_parameters())
            self.prog_ema = self._norms(ema[n].detach() - w[n] for n in self.names)
        del w, params
        self.mark("checked steps")
        for _ in range(int(tr.get("warm_steps", 2))):
            self.unit()
        self.sync()
        self.mark("warm-up")
        self.data_wait = []
        self.attempted = self.failed = 0

    def _write_pool(self) -> str:
        """The pool: ``pool`` sequences of the split drawn from the seed, each
        as ``replicas`` trajectories of ``frames`` frames (ATLAS items read
        ``{name}_R1..3``)."""
        tr, d = self.traffic, self.make_workdir()
        seqs = read_split(tr["split"])
        rng = np.random.default_rng(subseed(self.seed, "pool"))
        keys = list(seqs)
        names = [keys[i] for i in rng.choice(len(keys), tr["pool"], replace=False)]
        reps = tr.get("replicas", 0)
        for i, name in enumerate(names):
            for r in (range(1, reps + 1) if reps else [None]):
                key = name if r is None else f"{name}_R{r}"
                traj = synthetic_trajectory(seqs[name], tr["frames"],
                                            subseed(self.seed, "traj", i, r or 0))
                np.save(os.path.join(d, key + ".npy"), traj)
        path = os.path.join(d, "pool.csv")
        with open(path, "w") as fh:
            fh.write("name,seqres\n" + "".join(f"{n},{seqs[n]}\n" for n in names))
        return path

    def make_loader(self, ds):
        from mdgen_tpu_torch.data import Loader

        return Loader(ds, self.traffic["batch_size"], shuffle=True,
                      seed=subseed(self.seed, "order"))

    def make_runtime(self):
        from mdgen_tpu_torch.runtime import TrainRuntime

        return TrainRuntime(self.pcfg, self.device)

    def draw(self, B, T, L):
        """This step's t and x0."""
        import torch

        t = torch.rand((B,), generator=self.draws, device=self.device)
        x0 = torch.randn((B, T, L, self.cfg["latent_dim"]), generator=self.draws,
                         device=self.device)
        return t, x0

    def _weights(self):
        import torch

        g = torch.Generator(device=self.device).manual_seed(subseed(self.seed, "weights"))
        return weights.make(self.cfg, g, self.device)

    @staticmethod
    def _norms(tensors) -> list:
        import torch

        return torch.stack([torch.linalg.vector_norm(t.float()) for t in tensors]).tolist()

    def unit(self, keep: bool = False) -> int:
        import torch
        from mdgen_tpu_torch.runtime import batch_to_device

        t0 = time.perf_counter()
        with torch.profiler.record_function("portbench.data"):
            batch = next(self.feed)
            batch.pop("name", None)
            dev = batch_to_device(batch, self.device)
        self.data_wait.append(time.perf_counter() - t0)
        B, T, L = batch["atom14"].shape[:3]
        if self.cfg.get("atlas") and L == self.cfg["crop"] + 1:
            L -= 1  # the left-context column is dropped by the tokenizer
        t, x0 = self.draw(B, T, L)
        self.shape = (B, T, L)
        with torch.profiler.record_function("portbench.train_step"):
            self.state, metrics = self.rt.train_step(self.state, dev, None, t, x0)
            metrics = {k: float(v) for k, v in metrics.items()}
        self.attempted += 1
        self.failed += not math.isfinite(metrics["loss"])
        if keep:
            self.kept.append((batch, t, x0, metrics["loss"]))
        return B

    def release(self):
        import torch

        self.state = self.rt = self.feed = self.loader = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, prec=None, rows=None, keep=False) -> dict:
        """The reference's three steps from the run's weights, batches and
        draws (``rows``: only the first rows of each, for a planted fault;
        ``keep``: with the tensors, ``rtrain.train_steps``)."""
        import torch

        w = self._weights()
        sl = slice(None) if rows is None else slice(0, rows)
        batches = [{"atom14": torch.as_tensor(b["atom14"][sl], dtype=torch.float32,
                                              device=self.device),
                    "seqres": torch.as_tensor(b["seqres"][sl], device=self.device).long(),
                    "mask": torch.as_tensor(b["mask"][sl], dtype=torch.float32,
                                            device=self.device)}
                   for b, _, _, _ in self.kept]
        draws = [(t[sl], x0[sl]) for _, t, x0, _ in self.kept]
        if prec is None:
            prec = rprec.Precision("f32", low=self.cfg["precision"] == "bf16-mixed")
        return rtrain.train_steps(self.cfg, w, batches, draws, prec,
                                  drop_left_context=bool(self.cfg.get("atlas")), keep=keep)

    def readings(self) -> dict:
        """The program's readings in the reference's form."""
        out = {"losses": [loss for _, _, _, loss in self.kept],
               "grad": dict(zip(self.names, self.prog_grad)),
               "change": dict(zip(self.names, self.prog_change))}
        if hasattr(self, "prog_ema"):
            out["ema_change"] = dict(zip(self.names, self.prog_ema))
        return out

    def check(self) -> list:
        return self.numbers(gaps(self.readings(), self.reference()))

    def shapes(self):
        return self.shape


def epochs(loader):
    """The loader's batches, epoch after epoch (each shuffled anew)."""
    while True:
        yield from loader


def gaps(prog: dict, ref: dict) -> dict:
    """The compared numbers: the widest relative gap of the three losses,
    and the worst leaf of the first gradient's norm, of the change after
    the three steps and of the EMA's change; and the median leaf's gap of
    the change. Leaves whose reference gradient is under a thousandth of the
    median leaf's (nought to rounding, as a key's bias under softmax) are
    left out."""
    med = float(np.median(list(ref["grad"].values())))
    counted = [n for n, v in ref["grad"].items() if v >= 1e-3 * med]
    out = {
        "loss_gap": max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"])),
        "grad_gap": leaf_gap(prog["grad"], ref["grad"], counted),
        "update_gap": leaf_gap(prog["change"], ref["change"], counted),
        "update_gap_median": float(np.median(list(
            leaf_gaps(prog["change"], ref["change"], counted).values()))),
    }
    if "ema_change" in ref and "ema_change" in prog:
        out["ema_gap"] = leaf_gap(prog["ema_change"], ref["ema_change"], counted)
    return out
