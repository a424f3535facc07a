"""The general part of a run: find a cell's files by name, set up its
driver, measure the window, read the trace, decide ``correct`` and print the
result line.

Everything that belongs to one configuration, traffic mix, driver or metric
sits in a file of its own, found by the name that ``BENCHMARK.json`` gives:

    portbench/configs/<config>.json     sizes and recipe, as run
    portbench/workloads/<traffic>.json  the mix: driver, batch, pool, limits
    portbench/drivers/<driver>.py       a ``Driver`` class (set-up, unit, check)
    portbench/metrics/<metric>.py       a ``read(ctx)`` returning a number or None
    portbench/metrics/<metric>.json     its unit, layer, peaks and kernel names
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from types import SimpleNamespace

PKG = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PKG)
FORBIDDEN = ("jax", "jaxlib", "flax", "mdgen_tpu")  # top-level module names, whole


class Refused(Exception):
    """A run that cannot give a result; the message says why."""


def _json(path):
    with open(path) as fh:
        return json.load(fh)


def _module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def flat_config(conf: dict) -> dict:
    """The model's keys with the training recipe's over them."""
    out = dict(conf["model"])
    out.update(conf["train"])
    out["latent_dim"] = 21
    return out


def load_cell(name: str, root: str = ROOT) -> SimpleNamespace:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its configuration,
    traffic, driver class and metrics (each with its reader and its file)."""
    path = os.path.join(root, "BENCHMARK.json")
    if not os.path.exists(path):
        raise Refused(f"no {path}")
    bench = _json(path)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise Refused(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    conf_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    conf = _json(os.path.join(root, conf_entry["file"]))
    pkg = os.path.join(root, "portbench")
    traffic = _json(os.path.join(pkg, "workloads", cell["traffic"] + ".json"))
    driver = importlib.import_module(f"portbench.drivers.{traffic['driver']}").Driver
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if name in m.get("workloads", [name] if m["moves"] in names else [])]
    metrics = {}
    for m in e2e + layer:
        base = os.path.join(pkg, "metrics", m["name"])
        meta = _json(base + ".json") if os.path.exists(base + ".json") else {}
        metrics[m["name"]] = SimpleNamespace(
            entry=m, meta=meta, read=_module(base + ".py", "portbench_metric_" + m["name"]).read)
    return SimpleNamespace(name=name, root=root, chips=cell["chips"], config=conf, traffic=traffic,
                           driver=driver, e2e=e2e, per_layer=layer, metrics=metrics,
                           run_seconds=bench.get("run_seconds"))


def cache_dirs(root: str = ROOT) -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    base = os.path.join(root, "build", "portbench")
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(base, sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().replace("\n", "; ") or "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def measure(cell, seed: int, seconds: float, trace: bool, t_start: float, device: str = "cuda",
            log=print) -> dict:
    """Set up, run the window, read it, check the output. Returns the
    result's fields and the compared numbers."""
    import torch

    drv = cell.driver(cell, seed, device)
    drv.trace = trace
    try:
        drv.setup()
        if device != "cpu":
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - t_start
        log(f"set-up {setup_s:.3f} s: " + ", ".join(
            f"{what} at {at - t_start:.3f}" for what, at in drv.marks))
        ends, work, traced, done = [], [], 0, None
        n_trace = int(cell.traffic.get("trace_units", 3))
        counts0 = drv.counters()
        prof = _profiler(device) if trace else None
        if prof is not None:
            prof.start()
        t0 = time.perf_counter()
        while True:
            with torch.profiler.record_function("portbench.unit"):
                work.append(drv.unit())
            ends.append(time.perf_counter())
            stop = ends[-1] - t0 >= seconds
            if prof is not None and (len(ends) == n_trace or stop):
                prof.stop()
                traced, done, prof = len(ends), prof, None
            if stop:
                break
        counts1 = drv.counters()
        peak = drv.memory_peak()
        drv.release()
        summary = None
        if done is not None:
            from .trace import summarize

            summary = summarize(done)
            del done
        t_check = time.perf_counter()
        numbers = drv.check()
        d = sorted(b - a for a, b in zip([t0] + ends, ends))
        log(f"window {ends[-1] - t0:.3f} s, {len(ends)} units (ms: min {1e3 * d[0]:.1f}, median "
            f"{1e3 * d[len(d) // 2]:.1f}, p90 {1e3 * d[int(0.9 * (len(d) - 1))]:.1f}, max "
            f"{1e3 * d[-1]:.1f}); check {time.perf_counter() - t_check:.3f} s")
        ctx = SimpleNamespace(t0=t0, ends=ends, work=work, setup_s=setup_s, trace=summary,
                              traced_units=traced, driver=drv, cfg=drv.cfg, traffic=cell.traffic,
                              counters={k: counts1[k] - counts0.get(k, 0) for k in counts1},
                              meta=None)
        wanted = cell.per_layer if trace else cell.e2e
        metrics = {}
        for m in wanted:
            ctx.meta = cell.metrics[m["name"]].meta
            value = cell.metrics[m["name"]].read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_info = drv.device_info(peak)
        if summary is not None:
            device_info.update(busy_s=summary.busy_s, window_s=summary.window_s)
        return {"attempted": drv.attempted, "failed": drv.failed, "metrics": metrics,
                "device": device_info, "summary": summary, "numbers": numbers,
                "counters": ctx.counters}
    finally:
        drv.close()


def _profiler(device):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device != "cpu" else [])
    return profile(activities=acts)


def verdict(numbers: list) -> bool:
    """Every compared number is finite and within its limit."""
    return all(math.isfinite(v) and v <= lim for _, v, lim in numbers)


def result_line(res: dict, correct: bool) -> str:
    line = {"correct": correct, "attempted": res["attempted"], "failed": res["failed"],
            "metrics": res["metrics"], "device": res["device"]}
    if res.get("summary") is not None:
        line["breakdown"] = res["summary"].breakdown()
    line["counters"] = res["counters"]
    # a number that is not finite goes out as a string: the line stays JSON
    line["checks"] = {n: {"value": v if math.isfinite(v) else str(v), "limit": lim}
                      for n, v, lim in res["numbers"]}
    return json.dumps(line)
