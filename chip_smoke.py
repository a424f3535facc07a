#!/usr/bin/env python3
"""Smoke run of the PyTorch port (mdgen_tpu_torch) on one CUDA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the exit code is not 0:
  1. device: the card's name, count, and `nvidia-smi` name and power limit;
  2. build: compile the hand-written CUDA kernels from mdgen_tpu_torch/csrc
     with nvcc for sm_90a (-Xptxas -v; registers, shared memory, spills);
  3. kernel parity: each kernel against its plain PyTorch version on the
     card, at the main path's shapes (B=1, T=100, L=4, C=384, 16 heads), in
     f32 and in bf16 operands, with a masked residue; times both with CUDA
     events;
  4. model parity: one 5 x 384 x 16 LatentMDGenModel forward with the fused
     kernels against the dense plain path, and a short fused-vs-dense
     rollout, on seeded weights (noise on the zero-init adaLN and output
     head, which would otherwise hide every trunk sublayer);
  5. main path: 4AA forward simulation through
     `mdgen_tpu_torch.sim_inference.main(... --fused_block)` at the bench
     configuration (T=100, 100 Euler steps, bf16-mixed), 5 rollouts; checks
     the PDB (500 frames x 4 residues, finite) and that each fused kernel
     ran exactly 5 layers x 99 steps x 5 rollouts = 2475 times;
  6. flash kernel parity: kernels 4-7 against their plain twins at the
     training recipe's frame attention (N=512, Tq=1000, Tk=1001, d=24) with
     a masked residue, f32 and bf16 operands; times both with CUDA events;
  7. model gradient parity: one training loss and backward of the 5 x 384 x
     16 model at the recipe shape (B=8, T=1000, L=4, f32) through the flash
     kernels against dense attention: loss, every gradient, the grad norm;
  8. the training path: `mdgen_tpu_torch.train.main` at the 4AA recipe
     (batch 8, T=1000, crop 4, Adam 1e-4, clip 1, EMA) on 8 synthetic
     tetrapeptides of 1100 frames, 20 epochs of one step; checks 20 finite
     losses, each of kernels 5-7 launched exactly 5 layers x 20 steps = 100
     times and kernel 4 5 times (one validation batch), and the step_20
     checkpoint; prints ms per train step over steps 5-20;
  9. sampling from that run: `sim_inference --fused_block` restores the run
     directory and rolls out once at T=1000 with 2 Euler steps;
  10. the kernels JSON line, the nvidia-smi line, and the result line.
Needs no network and one card. Without a CUDA device, or outside a checkout
of the repository, it exits non-zero and prints no result.
"""
import importlib
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SEQ = "ACDE"
NUM_FRAMES, EULER_STEPS, ROLLOUTS = 100, 100, 5
B, T, L, C, H = 1, NUM_FRAMES, len(SEQ), 384, 16
# kernel vs plain on the card: f32 sums of 384..1536 products in another
# order (|y| ~ 1..10); bf16: the same bf16-rounded operands, but a float that
# lands next to a rounding boundary can round the other way in one of them
# (one bf16 ulp is 2^-8 of the operand)
TOL = {"f32": 1e-4, "bf16": 1e-2}
# the training path: the 4AA recipe at full width (batch 8, T=1000 frames)
B_TRAIN, TRAIN_FRAMES, TRAIN_EPOCHS = 8, 1000, 20
# flash kernels vs plain twins: o and lse absolute, gradients relative to
# their largest entry; f32 sums of 1001 keys (or 1000 queries) in another
# order; bf16 operands: the outputs are rounded to bf16 (one ulp is 2^-8)
FLASH_TOL = {"f32": {"abs": 1e-4, "rel": 1e-3}, "bf16": {"abs": 1e-2, "rel": 1e-2}}
FLASH_SRC = "mdgen_tpu_torch/csrc/flash_attention.cu"
KERNELS = {
    "fused_l_sublayer": ("mdgen_tpu_torch/csrc/fused_l_sublayer.cu", "mdgen_tpu/ops/fused_block.py:238"),
    "fused_t_sublayer": ("mdgen_tpu_torch/csrc/fused_t_sublayer.cu", "mdgen_tpu/ops/fused_t_block.py:201"),
    "fused_ffn_sublayer": ("mdgen_tpu_torch/csrc/fused_ffn.cu", "mdgen_tpu/ops/fused_ffn.py:98"),
    "flash_fwd": (FLASH_SRC, "mdgen_tpu/ops/flash_attention.py:130"),
    "flash_fwd_lse": (FLASH_SRC, "mdgen_tpu/ops/flash_attention.py:284"),
    "flash_bwd_dq": (FLASH_SRC, "mdgen_tpu/ops/flash_attention.py:329"),
    "flash_bwd_dkv": (FLASH_SRC, "mdgen_tpu/ops/flash_attention.py:346"),
}
FLASH_KERNELS = tuple(k for k in KERNELS if k.startswith("flash_"))


def log(*a):
    print(*a, flush=True)


def phase_device(torch):
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false")
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"[device] {name} x{count}; torch {torch.__version__} cuda {torch.version.cuda}; {smi}")
    return name, count, smi


def phase_build():
    from mdgen_tpu_torch.ops import _build

    _build.build(verbose=True)
    info = _build.build_info
    log(f"[build] nvcc {' '.join(_build.NVCC_FLAGS)}: {info['seconds']:.1f} s -> {info['path']}")
    for line in info.get("log", "").splitlines():
        if "Used" in line or "spill" in line or "Compiling entry" in line:
            log("[ptxas]", line.strip())


def _time_ms(torch, fn, iters=20):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_kernel_parity(torch):
    from mdgen_tpu_torch import ops

    g = torch.Generator().manual_seed(0)
    rnd = lambda *s, sc=1.0: (torch.randn(*s, generator=g) * sc).cuda()  # noqa: E731
    base = dict(
        x=rnd(B, T, L, C), shift=rnd(B, 1, C, sc=0.1), scale=rnd(B, 1, C, sc=0.1),
        gate=rnd(B, 1, C, sc=0.5), qkv_w=rnd(3 * C, C, sc=C**-0.5), qkv_b=rnd(3 * C, sc=0.05),
        bias_k=rnd(C, sc=0.3), bias_v=rnd(C, sc=0.3), out_w=rnd(C, C, sc=C**-0.5),
        out_b=rnd(C, sc=0.05), w1=rnd(4 * C, C, sc=C**-0.5), b1=rnd(4 * C, sc=0.05),
        w2=rnd(C, 4 * C, sc=(4 * C) ** -0.5), b2=rnd(C, sc=0.05),
    )
    mask = torch.ones(B, L, device="cuda")
    mask[0, -1] = 0.0  # a masked residue
    attn = ["shift", "scale", "gate", "qkv_w", "qkv_b", "bias_k", "bias_v", "out_w", "out_b"]
    ffn = ["shift", "scale", "gate", "w1", "b1", "w2", "b2"]
    fns = {
        "fused_l_sublayer": (ops.fused_l_sublayer, ops.fused_l_sublayer_plain, attn, True),
        "fused_t_sublayer": (ops.fused_t_sublayer, ops.fused_t_sublayer_plain, attn, True),
        "fused_ffn_sublayer": (ops.fused_ffn_sublayer, ops.fused_ffn_sublayer_plain, ffn, False),
    }
    results = {}
    for name, (kern, plain, names, is_attn) in fns.items():
        res = {"max_abs_err": 0.0}
        for dname, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            # serving style: parameters and adaLN chunks in the compute dtype
            args = [base["x"]] + [base[n].to(dt) for n in names]
            if is_attn:
                args.insert(4, mask)
                kw = dict(num_heads=H, compute_dtype=dt)
            else:
                kw = dict(compute_dtype=dt)
            y = kern(*args, **kw)
            ref = plain(*args, **kw)
            torch.cuda.synchronize()
            err = (y - ref).abs().max().item()
            rel = err / ref.abs().max().item()
            ok = torch.isfinite(y).all().item() and err <= TOL[dname]
            log(f"[parity] {name} {dname}: max_abs_err {err:.3e} (rel {rel:.3e}), tol {TOL[dname]:g} -> {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{name} {dname} disagrees with its plain version: {err}")
            res["max_abs_err"] = max(res["max_abs_err"], err)
            if dname == "bf16":  # the main path's dtype
                res["ms"] = _time_ms(torch, lambda: kern(*args, **kw))
                res["plain_ms"] = _time_ms(torch, lambda: plain(*args, **kw))
                log(f"[time] {name} bf16: kernel {res['ms']:.4f} ms, plain {res['plain_ms']:.4f} ms (CUDA events, 20 calls)")
        results[name] = res
    return results


def _rel_err(a, ref):
    """max |a - ref| / max |ref| in f32."""
    return ((a.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


def phase_flash_parity(torch):
    """Kernels 4-7 against their plain twins at the training recipe's frame
    attention (N = B*L*H = 512 rows, Tq = 1000 frames, Tk = 1001 with the
    bias token, d = 24), with one masked residue's 16 rows (every frame key
    finfo.min, only the bias key valid), in f32 and with bf16 operands. The
    backward kernels take the twin's (o, lse) so that each is held alone."""
    fa = importlib.import_module("mdgen_tpu_torch.ops.flash_attention")  # not the function

    N, Tq, Tk, d = B_TRAIN * L * H, TRAIN_FRAMES, TRAIN_FRAMES + 1, C // H
    g = torch.Generator().manual_seed(0)
    q = (torch.randn(N, Tq, d, generator=g) * d**-0.5).cuda()
    k, v = torch.randn(N, Tk, d, generator=g).cuda(), torch.randn(N, Tk, d, generator=g).cuda()
    do = torch.randn(N, Tq, d, generator=g).cuda()
    bias = torch.zeros(N, Tk, device="cuda")
    bias[(L - 1) * H:L * H, :-1] = fa.NEG_INF  # batch 0, last residue: its frames masked
    results = {n: {"max_abs_err": 0.0} for n in FLASH_KERNELS}
    for dname, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        qd, kd, vd, dod = (t.to(dt) for t in (q, k, v, do))
        o_ref, lse_ref = fa.flash_attention_plain(qd, kd, vd, bias)
        delta = fa.attention_delta(o_ref, dod)
        bwd = (qd, kd, vd, bias, dod, lse_ref, delta)
        o4 = fa.flash_fwd(qd, kd, vd, bias)
        o5, lse5 = fa.flash_fwd_lse(qd, kd, vd, bias)
        dq = fa.flash_bwd_dq(*bwd)
        dk, dv, db = fa.flash_bwd_dkv(*bwd)
        dq_r = fa.flash_bwd_dq_plain(*bwd)
        dk_r, dv_r, db_r = fa.flash_bwd_dkv_plain(*bwd)
        torch.cuda.synchronize()
        # o and lse: absolute; gradients: relative to their largest entry
        errs = {
            "flash_fwd": [("o", (o4.float() - o_ref.float()).abs().max().item(), "abs")],
            "flash_fwd_lse": [("o", (o5.float() - o_ref.float()).abs().max().item(), "abs"),
                              ("lse", (lse5 - lse_ref).abs().max().item(), "abs")],
            "flash_bwd_dq": [("dq", _rel_err(dq, dq_r), "rel")],
            "flash_bwd_dkv": [("dk", _rel_err(dk, dk_r), "rel"), ("dv", _rel_err(dv, dv_r), "rel"),
                              ("dbias", _rel_err(db, db_r), "rel")],
        }
        outs = {"flash_fwd": [o4], "flash_fwd_lse": [o5, lse5], "flash_bwd_dq": [dq],
                "flash_bwd_dkv": [dk, dv, db]}
        refs = {"flash_fwd": [o_ref], "flash_fwd_lse": [o_ref, lse_ref], "flash_bwd_dq": [dq_r],
                "flash_bwd_dkv": [dk_r, dv_r, db_r]}
        for name, checks in errs.items():
            for what, err, kind in checks:
                tol = FLASH_TOL[dname][kind]
                ok = err <= tol and all(bool(torch.isfinite(t).all()) for t in outs[name])
                log(f"[flash] {name} {dname}: {what} {kind} err {err:.3e}, tol {tol:g} -> "
                    f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"{name} {dname} {what} disagrees with its plain twin: {err}")
            abs_err = max((a.float() - b.float()).abs().max().item()
                          for a, b in zip(outs[name], refs[name]))
            results[name]["max_abs_err"] = max(results[name]["max_abs_err"], abs_err)
        if dname == "f32":  # the recipe's precision (32-true)
            timed = {
                "flash_fwd": (lambda: fa.flash_fwd(qd, kd, vd, bias),
                              lambda: fa.flash_attention_plain(qd, kd, vd, bias)[0]),
                "flash_fwd_lse": (lambda: fa.flash_fwd_lse(qd, kd, vd, bias),
                                  lambda: fa.flash_attention_plain(qd, kd, vd, bias)),
                "flash_bwd_dq": (lambda: fa.flash_bwd_dq(*bwd), lambda: fa.flash_bwd_dq_plain(*bwd)),
                "flash_bwd_dkv": (lambda: fa.flash_bwd_dkv(*bwd),
                                  lambda: fa.flash_bwd_dkv_plain(*bwd)),
            }
            for name, (kern, plain) in timed.items():
                results[name]["ms"] = _time_ms(torch, kern, iters=10)
                results[name]["plain_ms"] = _time_ms(torch, plain, iters=10)
                log(f"[time] {name} f32 N={N} Tq={Tq} Tk={Tk} d={d}: kernel "
                    f"{results[name]['ms']:.4f} ms, plain {results[name]['plain_ms']:.4f} ms "
                    f"(CUDA events, 10 calls)")
        del o_ref, lse_ref, dq_r, dk_r, dv_r, db_r, refs
        torch.cuda.empty_cache()
    return results


def bench_config(**kw):
    from mdgen_tpu_torch.config import MDGenConfig

    base = dict(sim_condition=True, prepend_ipa=True, abs_pos_emb=True, abs_time_emb=True,
                crop=L, num_frames=NUM_FRAMES, sampling_method="euler",
                inference_steps=EULER_STEPS, batch_size=B, precision="bf16-mixed")
    base.update(kw)
    return MDGenConfig(**base)


def seeded_model(torch, cfg):
    """Seeded weights; the zero-init adaLN producers and output head get
    N(0, 0.05) noise so every trunk sublayer and the head contribute."""
    from mdgen_tpu_torch.models import LatentMDGenModel

    g = torch.Generator().manual_seed(0)
    model = LatentMDGenModel(cfg, cfg.latent_dim).reset_parameters(g)
    with torch.no_grad():
        for lin in (model.trunk_adaln, model.ipa_adaln, model.emb_to_latent.dense_0,
                    model.emb_to_latent.dense_1):
            lin.weight.add_(torch.randn(lin.weight.shape, generator=g) * 0.05)
    return model


def phase_model_parity(torch, state_dict):
    import numpy as np

    from mdgen_tpu_torch.data import synthetic_trajectory
    from mdgen_tpu_torch.geometry import constants as rc
    from mdgen_tpu_torch.models import LatentMDGenModel
    from mdgen_tpu_torch.runtime import MDGenRuntime, tokenize_atom14
    from mdgen_tpu_torch.tasks import prep_batch

    start = torch.from_numpy(synthetic_trajectory(SEQ, 1, seed=0)[0].astype(np.float32))[None].cuda()
    seqres = torch.from_numpy(rc.str_sequence_to_aatype(SEQ)[None]).long().cuda()
    mask = torch.ones(B, L, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(1)
    # relative to max(|out|, 1): f32 sums in another order; under bf16-mixed
    # the dense path rounds q, k, logits and probs to bf16 where the fused
    # residue kernel keeps f32, as in the JAX package
    for precision, tol in (("32-true", 1e-4), ("bf16-mixed", 1e-2)):
        outs = {}
        for fused in (False, True):
            cfg = bench_config(precision=precision, fused_block=fused)
            model = LatentMDGenModel(cfg, cfg.latent_dim)
            model.load_state_dict(state_dict)
            rt = MDGenRuntime(cfg, model.cuda())
            tok = tokenize_atom14({"atom14": start[:, None].expand(B, T, L, 14, 3),
                                   "seqres": seqres, "mask": mask})
            prep = prep_batch(cfg, tok)
            x = torch.randn(B, T, L, cfg.latent_dim, device="cuda", generator=g.manual_seed(1))
            t = torch.full((B,), 0.4, device="cuda")
            with torch.inference_mode():
                out = rt.model_inf(x, t, **prep.model_kwargs).float()
            outs[fused] = out
        err = (outs[True] - outs[False]).abs().max().item()
        scale = outs[False].abs().max().item()
        ok = bool(torch.isfinite(outs[True]).all()) and scale > 1e-2 and err <= tol * max(scale, 1.0)
        log(f"[model] 5x384x16 forward {precision}: fused vs dense max_abs_err {err:.3e} "
            f"(|out| max {scale:.3f}), tol {tol:g} x max(|out|,1) -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"fused and dense forwards disagree ({precision}): {err}")

    # a short rollout (T=100, 4 Euler steps, 2 rollouts, f32), same noise
    trajs = {}
    noise = torch.randn(2, B, T, L, 21, device="cuda", generator=g.manual_seed(2))
    for fused in (False, True):
        cfg = bench_config(precision="32-true", fused_block=fused, inference_steps=4)
        model = LatentMDGenModel(cfg, cfg.latent_dim)
        model.load_state_dict(state_dict)
        trajs[fused] = MDGenRuntime(cfg, model.cuda()).rollout(start, seqres, mask, 2, noise=noise)
    err = (trajs[True] - trajs[False]).abs().max().item()
    ok = bool(torch.isfinite(trajs[True]).all()) and err <= 1e-3
    log(f"[model] rollout 2 x 100 frames, 4 Euler steps, f32: fused vs dense max_abs_err "
        f"{err:.3e} A, tol 1e-3 A -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"fused and dense rollouts disagree: {err} A")


def phase_main_path(state_dict, smi):
    with tempfile.TemporaryDirectory(prefix="mdgen_smoke_") as work:
        return _main_path(state_dict, smi, work)


def _main_path(state_dict, smi, work):
    import numpy as np

    from mdgen_tpu_torch import ops, sim_inference
    from mdgen_tpu_torch.data import synthetic_trajectory
    from mdgen_tpu_torch.runtime import checkpoint

    np.save(os.path.join(work, "ACDE.npy"), synthetic_trajectory(SEQ, NUM_FRAMES, seed=0))
    split = os.path.join(work, "split.csv")
    with open(split, "w") as fh:
        fh.write(f"name,seqres\nACDE,{SEQ}\n")
    ckpt = os.path.join(work, "ckpt")
    checkpoint.save_checkpoint(ckpt, bench_config(), state_dict)
    argv = ["--sim_ckpt", ckpt, "--data_dir", work, "--split", split, "--out_dir",
            os.path.join(work, "out"), "--fused_block", "--device", "cuda"]

    sim_inference.main(argv + ["--num_rollouts", "1"])  # warm-up (allocator, caches)
    ops.reset_launch_counts()
    rec = sim_inference.main(argv + ["--num_rollouts", str(ROLLOUTS)])[0]
    counts = ops.launch_counts()

    want = 5 * (EULER_STEPS - 1) * ROLLOUTS
    with open(rec["paths"][0]) as fh:
        text = fh.read()
    models = text.count("\nENDMDL") + text.startswith("ENDMDL")
    residues = {line[22:26] for line in text.splitlines() if line.startswith("ATOM")}
    coords = np.array([[float(line[30:38]), float(line[38:46]), float(line[46:54])]
                       for line in text.splitlines() if line.startswith("ATOM")])
    fps = rec["frames"] / rec["seconds"]
    log(f"[main] sim_inference --fused_block: {rec['frames']} frames in {rec['seconds']:.3f} s "
        f"= {fps:.1f} frames/s ({smi}); PDB {models} models x {len(residues)} residues, "
        f"launches {counts}")
    if models != ROLLOUTS * NUM_FRAMES or len(residues) != L or not np.isfinite(coords).all():
        raise AssertionError(f"bad trajectory PDB: {models} models, {len(residues)} residues")
    bad = {k: v for k, v in counts.items() if v != (0 if k.startswith("flash_") else want)}
    if bad:
        raise AssertionError(f"launch counts {bad}, expected {want} for each fused kernel "
                             "and 0 for the flash kernels (T=100: 101 keys, dense)")
    return counts


TRAIN_SEQS = ("ACDE", "FGHI", "KLMN", "PQRS", "TVWY", "AGDK", "EWRL", "YHMC")


def train_config(**kw):
    """The 4AA training recipe: --sim_condition --num_frames 1000
    --prepend_ipa --abs_pos_emb --abs_time_emb --crop 4, 5 x 384 x 16,
    batch 8, 32-true, Adam 1e-4, grad_clip 1."""
    from mdgen_tpu_torch.config import MDGenConfig

    base = dict(sim_condition=True, prepend_ipa=True, abs_pos_emb=True, abs_time_emb=True,
                crop=L, num_frames=TRAIN_FRAMES, batch_size=B_TRAIN)
    base.update(kw)
    return MDGenConfig(**base)


def phase_grad_parity(torch, state_dict):
    """One training loss and backward at the recipe shape with the flash
    kernels (attn_impl auto: 1001 keys) and with dense attention, the same
    weights, batch, t and x0. Loss 1e-5 relative; each parameter's gradient
    1e-3 relative to its norm; the global grad norm 1e-4 relative (f32 sums
    of 1001 keys, and the backward's over 1000 queries, in another order)."""
    import numpy as np

    from mdgen_tpu_torch import ops
    from mdgen_tpu_torch.data import synthetic_trajectory
    from mdgen_tpu_torch.geometry import constants as rc
    from mdgen_tpu_torch.runtime import TrainRuntime, batch_to_device
    from mdgen_tpu_torch.runtime.optim import global_norm

    raw = {"atom14": np.stack([synthetic_trajectory(s, TRAIN_FRAMES, seed=i)
                               for i, s in enumerate(TRAIN_SEQS)]).astype(np.float32),
           "seqres": np.stack([rc.str_sequence_to_aatype(s) for s in TRAIN_SEQS]),
           "mask": np.ones((B_TRAIN, L), np.float32)}
    raw["mask"][-1, -1] = 0.0  # a padded residue
    batch = batch_to_device(raw, "cuda")
    g = torch.Generator(device="cuda").manual_seed(3)
    t = torch.rand(B_TRAIN, device="cuda", generator=g)
    x0 = torch.randn(B_TRAIN, TRAIN_FRAMES, L, 21, device="cuda", generator=g)
    res = {}
    for impl in ("auto", "dense"):
        rt = TrainRuntime(train_config(attn_impl=impl), "cuda")
        model = rt.init(state_dict=state_dict).model
        names = [n for n, _ in model.named_parameters()]
        ops.reset_launch_counts()
        _, grads, metrics = rt._grads(model, batch, t=t, x0=x0)
        torch.cuda.synchronize()
        res[impl] = (float(metrics["loss"]), grads, float(global_norm(grads)),
                     ops.launch_counts())
        del model
    (loss_f, g_f, n_f, c_f), (loss_d, g_d, n_d, c_d) = res["auto"], res["dense"]
    if c_f["flash_fwd_lse"] != 5 or c_f["flash_bwd_dkv"] != 5 or c_d["flash_fwd_lse"] != 0:
        raise AssertionError(f"the flash run did not take the flash kernels: {c_f}, {c_d}")
    # each gradient relative to its norm (absolute where the norm is 0)
    rels = [((a - b).norm() / (b.norm() if b.norm() > 0 else 1.0)).item() for a, b in zip(g_f, g_d)]
    worst = max(range(len(rels)), key=rels.__getitem__)
    loss_rel, norm_rel = abs(loss_f - loss_d) / abs(loss_d), abs(n_f - n_d) / n_d
    ok = (loss_rel <= 1e-5 and rels[worst] <= 1e-3 and norm_rel <= 1e-4
          and all(bool(torch.isfinite(x).all()) for x in g_f))
    log(f"[grad] recipe B={B_TRAIN} T={TRAIN_FRAMES} L={L} 5x384x16 f32, flash vs dense: loss "
        f"{loss_f:.6f} vs {loss_d:.6f} (rel {loss_rel:.2e}, tol 1e-5); worst gradient rel "
        f"{rels[worst]:.2e} ({names[worst]}, tol 1e-3); grad norm {n_f:.6f} vs {n_d:.6f} "
        f"(rel {norm_rel:.2e}, tol 1e-4) -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("flash and dense training gradients disagree")
    torch.cuda.empty_cache()


def phase_training(torch, smi):
    with tempfile.TemporaryDirectory(prefix="mdgen_train_") as work:
        return _training(torch, smi, work)


def _training(torch, smi, work):
    import numpy as np

    from mdgen_tpu_torch import ops, sim_inference, train
    from mdgen_tpu_torch.data import synthetic_trajectory
    from mdgen_tpu_torch.runtime import checkpoint

    for i, s in enumerate(TRAIN_SEQS):
        np.save(os.path.join(work, f"{s}.npy"), synthetic_trajectory(s, 1100, seed=i))
    split = os.path.join(work, "split.csv")
    with open(split, "w") as fh:
        fh.write("name,seqres\n" + "".join(f"{s},{s}\n" for s in TRAIN_SEQS))
    argv = ["--sim_condition", "--num_frames", str(TRAIN_FRAMES), "--prepend_ipa",
            "--abs_pos_emb", "--abs_time_emb", "--crop", str(L), "--sampling_method", "euler",
            "--inference_steps", "2", "--ema", "--epochs", str(TRAIN_EPOCHS), "--val_batches",
            "1", "--val_epoch_freq", str(TRAIN_EPOCHS), "--ckpt_freq", str(TRAIN_EPOCHS),
            "--train_split", split, "--val_split", split, "--data_dir", work,
            "--workdir", work, "--run_name", "run", "--device", "cuda"]

    ops.reset_launch_counts()
    rec = train.main(argv)
    counts = ops.launch_counts()
    steps = len(rec["losses"])
    ms = (rec["step_end"][-1] - rec["step_end"][4]) / (steps - 5) * 1e3
    log(f"[train] python -m mdgen_tpu_torch.train (4AA recipe, batch {B_TRAIN}, T={TRAIN_FRAMES}, "
        f"f32): {steps} steps, loss {rec['losses'][0]:.4f} -> {rec['losses'][-1]:.4f}; "
        f"{ms:.1f} ms per train step over steps 5-{steps} ({smi}); launches {counts}")
    want = {"flash_fwd_lse": 5 * TRAIN_EPOCHS, "flash_bwd_dq": 5 * TRAIN_EPOCHS,
            "flash_bwd_dkv": 5 * TRAIN_EPOCHS, "flash_fwd": 5, "fused_l_sublayer": 0,
            "fused_t_sublayer": 0, "fused_ffn_sublayer": 0}
    if steps != TRAIN_EPOCHS or rec["step"] != TRAIN_EPOCHS or not np.isfinite(rec["losses"]).all():
        raise AssertionError(f"expected {TRAIN_EPOCHS} finite steps, got {rec['losses']}")
    if counts != want:
        raise AssertionError(f"launch counts {counts}, expected {want}")
    run = rec["model_dir"]
    blob = torch.load(os.path.join(run, f"step_{TRAIN_EPOCHS}", "model.pt"), weights_only=True)
    if checkpoint.latest_step(run) != TRAIN_EPOCHS or blob["ema"] is None or \
            blob["optimizer"]["count"] != TRAIN_EPOCHS or blob["step"] != TRAIN_EPOCHS:
        raise AssertionError(f"bad checkpoint in {run}: {sorted(os.listdir(run))}")

    ops.reset_launch_counts()
    out = sim_inference.main(["--sim_ckpt", run, "--data_dir", work, "--split", split,
                              "--pdb_id", TRAIN_SEQS[0], "--num_rollouts", "1", "--out_dir",
                              os.path.join(work, "out"), "--fused_block", "--device", "cuda"])[0]
    sample_counts = ops.launch_counts()
    with open(out["paths"][0]) as fh:
        text = fh.read()
    models = text.count("\nENDMDL") + text.startswith("ENDMDL")
    coords = np.array([[float(line[30:38]), float(line[38:46]), float(line[46:54])]
                       for line in text.splitlines() if line.startswith("ATOM")])
    log(f"[sample] sim_inference --fused_block from {os.path.basename(run)}/step_{TRAIN_EPOCHS} "
        f"(EMA): {models} frames in {out['seconds']:.3f} s; launches {sample_counts}")
    fused = {k: v for k, v in sample_counts.items() if k.startswith("fused_")}
    if models != TRAIN_FRAMES or not np.isfinite(coords).all() or set(fused.values()) != {5} \
            or any(v for k, v in sample_counts.items() if k.startswith("flash_")):
        raise AssertionError(f"bad rollout from the trained run: {models} models, {sample_counts}")
    return counts, ms


def main():
    if not os.path.isdir(os.path.join(HERE, "mdgen_tpu_torch")):
        raise RuntimeError("run chip_smoke.py from a checkout of the repository")
    sys.path.insert(0, HERE)
    import torch

    name, count, smi = phase_device(torch)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    phase_build()
    parity = phase_kernel_parity(torch)
    state_dict = seeded_model(torch, bench_config()).state_dict()
    phase_model_parity(torch, state_dict)
    counts = phase_main_path(state_dict, smi)
    parity.update(phase_flash_parity(torch))
    phase_grad_parity(torch, state_dict)
    train_counts, _ = phase_training(torch, smi)
    log(f"[done] all phases passed in {time.perf_counter() - t0:.1f} s")
    kernels = [
        {"name": k, "route": "cuda", "source": src, "replaces": rep,
         "launches": (train_counts if k in FLASH_KERNELS else counts)[k],
         "max_abs_err": parity[k]["max_abs_err"], "ms": parity[k]["ms"],
         "plain_ms": parity[k]["plain_ms"]}
        for k, (src, rep) in KERNELS.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))


if __name__ == "__main__":
    main()  # any failure raises: traceback, exit code 1, no result line
