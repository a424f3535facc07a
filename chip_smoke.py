#!/usr/bin/env python3
"""Smoke run of the PyTorch port (mdgen_tpu_torch) on one CUDA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the exit code is not 0:
  1. device: the card's name, count, and `nvidia-smi` name and power limit;
  2. build: compile the hand-written CUDA kernels from mdgen_tpu_torch/csrc
     with nvcc for sm_90a (-Xptxas -v; registers, shared memory, spills);
  3. kernel parity: each kernel against its plain PyTorch version on the
     card, at the main path's shapes (B=1, T=100, L=4, C=384, 16 heads), in
     f32 and in bf16 operands, with a masked residue; all three (tensor
     cores) also at token counts that are no multiple of their tiles, and
     kernel 2 at the edges of its 64-frame tiles (T = 1, 63, 64, 65, 129),
     at the model's gate (T = 1024), at head widths 8, 32 and 64 and with a
     batch entry whose residues are all masked, each twice on the same
     inputs (bit-equal, `[edge]` lines); times kernel and plain version with
     CUDA events eagerly through the wrapper (`ms`, what a caller waits for)
     and around a CUDA graph of 20 calls (`device_ms`: the wrappers' host
     time is not counted), and the wrapper's host time per call; kernel 2
     also at T = 1000, where the sampling path of phase 11 calls it;
  3a. `[optim]`: the optimizer pass (kernel 8: `sum_of_squares`, then
     `fused_adam`) against its plain twins at the 4AA model's 193
     parameter tensors (34.15M f32), a state some steps in, with an EMA and
     the clip engaged and without either: p, mu, nu and the EMA bit-equal to
     the eager loop given the kernel's norm, the norm within OPT_NORM_TOL
     relative of the loop's and bit-equal twice; each wrapper's eager ms,
     device ms (a CUDA graph of 20 calls), host µs and bound (bytes), the
     twins' eager ms, and the library calls beside them (the norm by
     `torch._foreach_norm`; `torch.optim.Adam(fused=True)`, which neither
     clips nor keeps an EMA);
  4. model parity: one 5 x 384 x 16 LatentMDGenModel forward with the fused
     kernels against the dense plain path, and a short fused-vs-dense
     rollout (each fused rollout from the dense one's start), on seeded
     weights (noise on the zero-init adaLN and output head, which would
     otherwise hide every trunk sublayer);
  5. main path: 4AA forward simulation through
     `mdgen_tpu_torch.sim_inference.main(... --fused_block)` at the bench
     configuration (T=100, 100 Euler steps, bf16-mixed), 5 rollouts; checks
     the PDB (500 frames x 4 residues, finite) and that each fused kernel
     ran exactly 5 layers x 99 steps x 5 rollouts = 2475 times;
  6. dopri5 at full width: one adaptive dopri5 rollout (T=100) of the bench
     model through MDGenRuntime, in 32-true fused (kernels 1-3) and dense
     from the same start and noise, then in bf16-mixed fused; checks that
     the f32 fused solve reaches t1, that kernels 1-3 ran 5 layers x its
     drift evaluations times, and that its atoms are within DOPRI5_TOL of
     the dense solve's; prints attempts, accepted, rejected, evaluations, ms
     per solve and frames/s beside phase 5's Euler rollout (a bf16 solve
     that spends max_steps is printed, not failed);
  7. the quality chain: `mdgen_tpu_torch.quality_run` on the card at a small
     budget (the default 128 x 3 model, QUALITY_MD_FRAMES MD frames,
     QUALITY_EPOCHS steps, 2 dopri5 rollouts, --xtc): out.pkl, every JSD
     finite and in [0, 1], each XTC read back with its frame-0 PDB topology
     and within XTC precision (1e-3 nm) of the sampled atoms superposed onto
     frame 0, and the printed JSON (its JSDs mean nothing at this budget);
     then `[eval-protocol]`: `python -m mdgen_tpu_torch.eval_protocol
     --fused_block` on that run (EVAL_FRAMES eval frames, EVAL_ROLLOUTS
     rollouts a peptide, the noise floor): its table finite, its drift
     evaluations per solve and kernel launches (kernels 1-3, no flash kernel);
  7a. TPS: `mdgen_tpu_torch.tps_inference.main(... --fused_block)` with a
     seeded full-width TPS checkpoint (the IPA tower from both endpoints) on
     a synthetic rotamer tetrapeptide's MD (TPS_MD_FRAMES frames, the MSM at
     lags TPS_TICA_LAG / TPS_MSM_LAG): one batch of TPS_PATHS paths, T=100,
     bf16-mixed, dopri5; checks 100 frames per path PDB, kernels 1-3 at 5
     layers x the solve's drift evaluations, then the same endpoints and
     noise fused vs dense in 32-true within DOPRI5_TOL; prints paths/s and ms
     per evaluation;
  7b. upsampling: `mdgen_tpu_torch.upsampling_inference.main(... --fused_block
     --xtc)` at the reference recipe (T=1000, cond_interval 100, batch 1,
     bf16-mixed, dopri5) on the 30 kept frames of a 3000-frame synthetic
     trajectory (3 windows); checks 3000 frames read back, kernels 1-3 at 5 x
     the evaluations of the 3 solves, kernel 2 at T=1000 only, the kept
     frames' backbones decoded from the windows' conditioning latents within
     KEPT_TOL, and window 1 fused vs dense (flash kernel 4 on its frame axis)
     from the same noise in 32-true within DOPRI5_TOL; prints frames/s, ms
     per evaluation and (not held: random weights) how far the sampled kept
     frames lie from their inputs;
  7c. design: `mdgen_tpu_torch.design_inference.main(... --fused_block)` with a
     seeded full-width design checkpoint (the reference recipe: inpainting +
     design, no aatype embedding, no torsions; latent 48) on a synthetic
     rotamer tetrapeptide's MD (DESIGN_MD_FRAMES frames, its MSM at the TPS
     lags): one batch of DESIGN_BATCH windows of 100 frames starting in the
     highest-flux transition's start state (12,800 tokens per sublayer),
     bf16-mixed, dopri5 with the Dirichlet flow; checks 32 PDBs of 100
     frames, valid designed sequences, kernels 1-3 at 5 layers x the solve's
     drift evaluations, then the same windows and noise fused vs dense in
     32-true: atoms within DOPRI5_TOL, the simplex channels within
     SIMPLEX_TOL, the designed sequences' agreement printed; prints
     samples/s, ms per evaluation and evaluations per solve;
  7d. mpnn: one full-width forward of each mpnn mode (`mpnn`: the first
     frame; `dynamic_mpnn`: the first and last) on DESIGN_BATCH windows,
     fused vs dense in 32-true: logits [32, 1, 4, 20] within TOL["f32"] x
     max(|logits|, 1), kernel 2 at T = 1 and T = 2, 5 launches of each
     fused kernel;
  7e. `quality_run --task tps`, `--task upsampling` and `--task design` at
     the budget of 7: the pickle's peptides and every metric finite (design:
     each peptide's 32 designs and every recovery in [0, 1]), the printed
     JSON;
  7f. the last model options and samplers, at full width on seeded weights:
     `[hyena]`: one --hyena --fused_block rollout at the bench shape
     (frames/s; kernels 1 and 3 at 5 x 99 launches, kernel 2 at none: the
     frame sublayer is the Hyena operator), then fused vs dense in 32-true
     (one forward within TOL["f32"] x max(|out|, 1), a 4-step rollout from
     the same start and noise within 1e-3 A); `[sde]`: Sampler.sample_sde,
     Euler-Maruyama and stochastic Heun (SDE_STEPS grid points, SBDM from
     t0 = 1e-3, Mean last step) on the bench sim model, fused vs dense from
     the same start and per-step noise in 32-true (atoms within
     SDE_TOL, kernels 1-3 at 5 launches a model evaluation);
     `[likelihood]`: sample_ode_likelihood (euler) on the dense route, log p
     finite and repeatable, the JVP divergence against the VJP one within
     LIK_TOL, and forward-mode AD refused by the fused model and by each of
     the 7 kernel wrappers given a dual CUDA tensor; `[options: ...]`:
     interleave_ipa and no_frames fused vs dense as `[hyena]`;
     `[quality-hyena]`: the quality chain of 7 with --hyena;
  8. flash kernel parity: kernels 4-7 against their plain twins at the
     training recipe's frame attention (N=512, Tq=1000, Tk=1001, d=24) with
     a masked residue, f32 and bf16 operands, each twice on the same inputs
     (bit-equal); all four (tensor cores) also at edge shapes (Tq below one
     MMA tile, one past two 64-row tiles, N=1, d = 7, 8, 40, 64), twice
     (bit-equal, `[edge]` lines); times kernel, plain twin and the library
     call (PyTorch's memory-efficient attention: forward, forward with
     logsumexp, and its backward, one call for kernels 6 and 7) with CUDA
     events, in both dtypes, and kernel and library device time around a
     CUDA graph of 5 calls, each beside its bound (f32: split TF32; bf16
     operands: bf16 tensor cores);
  9. model gradient parity: one training loss and backward of the 5 x 384 x
     16 model at the recipe shape (B=8, T=1000, L=4, f32) through the flash
     kernels against dense attention: loss, every gradient, the grad norm;
  10. the training path: `mdgen_tpu_torch.train.main` at the 4AA recipe
     (batch 8, T=1000, crop 4, Adam 1e-4, clip 1, EMA) on 8 synthetic
     tetrapeptides of 1100 frames, 20 epochs of one step; checks 20 finite
     losses, each of kernels 5-7 launched exactly 5 layers x 20 steps = 100
     times, kernel 4 5 times (one validation batch) and the optimizer's two
     (norm; clip, Adam and EMA) once a step, and the step_20 checkpoint;
     prints ms per train step over steps 5-20;
  11. sampling from that run: `sim_inference --fused_block` restores the run
     directory and rolls out once at T=1000 with 2 Euler steps;
  11a. the ATLAS recipe (`[atlas]`): `mdgen_tpu_torch.train --atlas` at crop
     256, T = 250, B = 1, bf16-mixed, grad_checkpointing, dropout 0.1 on
     7lao_A's 271-residue sequence (synthetic replicas; ms a step, peak
     device memory; all dense, no model kernel, the optimizer's two once a
     step); one Euler solve of an ATLAS item
     with the trained weights; the residue-axis attention at 6sms_A's 724
     residues (T = 250) through kernel 4 against dense; REMAT_STEPS steps of
     the 4AA recipe (T = 1000) with grad_checkpointing against the same
     steps without (losses, grad norms, gradients; kernel 5 launched again
     in each recompute);
  11b. data-parallel training (`[dp]`): `python -m mdgen_tpu_torch.train`
     at the 4AA recipe (T = 1000, global batch 8, 32-true, --ema) for
     DP_STEPS steps with the multi-host flags, as one rank and as two gloo
     ranks in two processes sharing the card (batch 4 each) on trajectories
     of exactly T frames; each step's loss and grad norm and the validation
     loss of the two runs within DP_TOL relative; ms a step of each; each
     rank's launches (kernels 5-7 at 5 x DP_STEPS, kernel 4 at 5); the
     checkpoint written once;
  11c. tensor and sequence parallelism (`[mp]`): the same recipe and steps
     through `python -m mdgen_tpu_torch.train --dp_size 1 --sp_size 2` and
     `--tp_size 2`, each one command whose two gloo ranks share the card;
     each rank's losses, grad norms and val loss within DP_TOL of `[dp]`'s
     one rank, its launches (tp: kernels 5-7 at 5 x DP_STEPS on H/2 heads,
     4 at 5; sp: none, the frame attention dense as JAX keeps it), ms a
     step and peak device memory beside one rank's, the checkpoint loaded
     whole within 2 lr a step of one rank's; then the ATLAS recipe at sp = 2
     for ATLAS_MP_STEPS steps against `[atlas]`'s first ones (bf16 TOL),
     each rank's peak memory beside one rank's;
  11d. data-parallel sampling (`[dp-infer]`): `sim_inference --fused_block`
     on one rank and `--dp_size 2` (two gloo ranks on the card), 2 peptides
     x ROLLOUTS rollouts of the main path: the written PDBs' first rollout
     within DP_INFER_TOL, equal evaluations, kernels 1-3 at 2475 on every
     rank; one dopri5 batch of `tps_inference` (3 paths, padded to 4) on
     one and two ranks: equal evaluation counts, the paths within
     DP_INFER_TOL;
  11e. reference checkpoints (`[port-ckpt]`): a Lightning .ckpt of the
     seeded bench model in the reference layout with its `ema` entry,
     ported by `python -m mdgen_tpu_torch.port_checkpoint`; the ported
     run's model against the seeded one (f32 forward, PORT_CKPT_TOL); one
     `sim_inference --fused_block` rollout from the run (kernels 1-3 at 5 x
     99 launches);
  11f. the native writers (`[native-io]`): the g++ version and a build of
     mdgen_tpu_torch/native/*.cpp; the main path's 500-frame PDB, the
     upsampling path's 3000-frame XTC and frame-0 PDB and the design batch's
     32 PDBs, as those phases' CLIs wrote them, written again by the C++ and
     by the Python writers: the PDBs byte-equal, the XTC byte-equal except at
     coordinates where float32 and float64 quantization round apart (each
     file then holds its own encoder's integers); each writer's seconds and
     its share of the path's wall time;
  11g. `[micro-fwd]`: `mdgen_tpu_torch.micro_fwd` at the 4AA sampling shape
     (B = 8, bf16-mixed, seeded weights), MICRO_STEPS chained forwards, fused
     and dense: kernels 1-3 at 5 launches each a step, the forwards' summed
     drift (out - x0) within MICRO_TOL x its own max, ms a step eagerly and
     as CUDA-graph replays;
  11h. `[e2e]`: `mdgen_tpu_torch.e2e_smoke` at E2E_STEPS steps (dataset,
     training with a falling fixed-draw loss, checkpoint round trip, 3
     rollouts, PDB, torsion JSDs);
  12. profiles, last because a torch.profiler session slows the host work
      of the rest of the process: each launch's device µs of the fused
      kernels (one CUDA-graph replay under torch.profiler; kernel 2 also at
      T = 1000), then one more
      main-path rollout under torch.profiler: device ms per kernel name,
      the optimizer's eager loop (kernel 8's plain twin) in device ms,
      the device's busy share, launches per evaluation, frames/s; and one
      upsampling window of 7b (T=1000): the same, and kernel 2's device µs
      per launch there;
  13. the kernels JSON line (with each kernel's bound: the larger of the
      bytes it must move over 3.35 TB/s and its operations over the peak of
      their type; each adds its worst `[edge]` error by dtype; kernel 2 its
      T = 1000 times and bound and its µs per launch on the upsampling path;
      the flash kernels their bf16 device, library and bound times and the
      f32 bound on CUDA cores; every kernel its launches on the TPS,
      upsampling, design and mpnn paths, and on the Hyena, SDE, likelihood,
      options, ATLAS training, ATLAS residue-attention and checkpointed 4AA
      runs, on each rank of `[dp]`, `[mp]` and `[dp-infer]`, and on
      `[port-ckpt]`, `[eval-protocol]` and `[micro-fwd]`),
      the nvidia-smi line, and the result line.
Needs no network and one card. Without a CUDA device, or outside a checkout
of the repository, it exits non-zero and prints no result.

    python3 chip_smoke.py --dp_ranks N

runs the device phase, the build and `[dp]` alone, with N NCCL ranks on N
cards of the host (one command, --dp_size N, DP_SCALING_STEPS steps)
against one rank: data-parallel scaling across cards. It needs N cards.

    python3 chip_smoke.py --mesh DP,SP,TP

runs `[mp]` alone on that grid of NCCL ranks, one card each
(DP_SCALING_STEPS steps of the 4AA recipe; the ATLAS recipe too where sp
divides its 250 frames), against one rank: ms a step and peak device memory
per rank. It needs DP x SP x TP cards.
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
# order, which split TF32 keeps to about 2e-5 (a split that lost a term
# reads 1e-4 and more: tools/split_tf32_check.py); bf16 operands: the
# outputs are rounded to bf16 (one ulp is 2^-8)
FLASH_TOL = {"f32": {"abs": 1e-4, "rel": 1e-4}, "bf16": {"abs": 1e-2, "rel": 1e-2}}
FLASH_SRC = "mdgen_tpu_torch/csrc/flash_attention.cu"
OPT_SRC = "mdgen_tpu_torch/csrc/fused_adam.cu"
# the tensor-core flash kernels (4-7): (N, Tq, Tk, d) at their tile edges,
# Tq below one 16-row MMA tile, one past two 64-row tiles, N = 1, the widths
# they pad to a whole MMA step, and d = 7 (rows of no whole 16 bytes, loaded
# element by element)
FLASH_EDGE_SHAPES = {"tq5": (2, 5, 6, 24), "tile_plus_one": (2, 129, 129, 24),
                     "n1": (1, 65, 200, 32), "d8": (2, 300, 301, 8), "d40": (2, 70, 65, 40),
                     "d64": (2, 64, 64, 64), "d7": (2, 33, 70, 7)}
KERNELS = {
    "fused_l_sublayer": ("mdgen_tpu_torch/csrc/fused_l_sublayer.cu", "mdgen_tpu/ops/fused_block.py:238"),
    "fused_t_sublayer": ("mdgen_tpu_torch/csrc/fused_t_sublayer.cu", "mdgen_tpu/ops/fused_t_block.py:201"),
    "fused_ffn_sublayer": ("mdgen_tpu_torch/csrc/fused_ffn.cu", "mdgen_tpu/ops/fused_ffn.py:98"),
    "flash_fwd": (FLASH_SRC, "mdgen_tpu/ops/flash_attention.py:130"),
    "flash_fwd_lse": (FLASH_SRC, "mdgen_tpu/ops/flash_attention.py:284"),
    "flash_bwd_dq": (FLASH_SRC, "mdgen_tpu/ops/flash_attention.py:329"),
    "flash_bwd_dkv": (FLASH_SRC, "mdgen_tpu/ops/flash_attention.py:346"),
    "sum_of_squares": (OPT_SRC, "none (optax)"),
    "fused_adam": (OPT_SRC, "none (optax)"),
}
FLASH_KERNELS = tuple(k for k in KERNELS if k.startswith("flash_"))
FUSED_KERNELS = tuple(k for k in KERNELS if k.endswith("_sublayer"))
# the fused kernels (1-3): edge shapes (B, T, L), token counts no multiple of
# their 32-token tiles
EDGE_SHAPES = {"tokens4": (1, 1, 4), "batch3": (3, 37, 4), "L1": (2, 20, 1), "L7": (2, 19, 7),
               "L16": (1, 20, 16)}
# kernel 2 also at (B, T, L, heads): T at the edges of its 64-frame tiles and
# at the model's gate (1024), head widths 8, 32 and 64 at C = 384, and a batch
# entry whose residues are all masked (every query sees the bias token alone)
FRAME_EDGE_SHAPES = {"T1": (2, 1, 4, H), "T63": (1, 63, 4, H), "T64": (1, 64, 4, H),
                     "T65": (2, 65, 3, H), "T129": (1, 129, 4, H), "T1024": (1, 1024, 4, H),
                     "hd8": (1, 100, 4, 48), "hd32": (1, 100, 4, 12), "hd64": (1, 100, 4, 6),
                     "all_masked": (2, 37, 4, H)}
# dopri5 at full width: the f32 fused solve against the dense one from the
# same start and noise, max |atoms| difference in Angstrom. The adaptive
# solver amplifies f32 rounding (its error estimate is a difference of two
# nearly equal states, so the last digit of one evaluation moves every later
# step size): 1.75e-3 A on the H100 with the seeded bench model (97
# evaluations each, PERF.md), held with margin; Euler's 4 steps in phase 4
# read 6e-6 A
DOPRI5_TOL = 1e-2
# the optimizer pass (kernel 8) against its eager loop: the norm in f64
# across blocks against f32 sums in another order (the card tests read
# under 1e-7); p, mu, nu and the EMA are held bit-equal
OPT_NORM_TOL = 1e-6
# the quality chain at a small budget (its JSDs mean nothing)
QUALITY_MD_FRAMES, QUALITY_EPOCHS, QUALITY_ROLLOUTS = 300, 40, 2
# the TPS path: one batch of TPS_PATHS endpoint-conditioned paths (T = 100)
# between the lowest-flux states of a synthetic rotamer tetrapeptide's MD of
# TPS_MD_FRAMES frames (its MSM at these lags)
TPS_PATHS, TPS_MD_FRAMES, TPS_TICA_LAG, TPS_MSM_LAG = 10, 600, 10, 2
# the upsampling path, the reference recipe: T = 1000 with every 100th frame
# given, on a synthetic trajectory of 3000 frames (30 kept frames, 3 windows)
UPS_FRAMES, UPS_INTERVAL, UPS_MD_FRAMES = 1000, 100, 3000
# the kept frames' backbone atoms (N, CA, C) decoded from the windows'
# conditioning latents against the kept input: the input is stored in
# float16 and the rebuild uses ideal geometry (7.3e-3 A on the CPU)
KEPT_TOL = 2e-2
# the design path (the reference recipe: inpainting + design, no aatype
# embedding, no torsions): one batch of DESIGN_BATCH windows of 100 frames
# (12,800 tokens per trunk sublayer) of a synthetic rotamer tetrapeptide's MD
# of DESIGN_MD_FRAMES frames, starting in the highest-flux transition's start
# state (its MSM at the TPS lags)
DESIGN_BATCH, DESIGN_MD_FRAMES = 32, 2000
# the 20 simplex channels of the fused (32-true) design solve against the
# dense one, max |difference|: the channels lie in [0, 1] and the dopri5
# solve carries f32 rounding as the atoms do (DOPRI5_TOL)
SIMPLEX_TOL = 1e-2
# [micro-fwd]: chained denoiser forwards a run; [e2e]: train steps
MICRO_STEPS, E2E_STEPS = 10, 40
# [micro-fwd]: fused against dense drift, relative to the dense drift's max.
# On the seeded weights (5 x 384, B = 2, the plain twins on the CPU) a
# sublayer that drops its residual branch in every layer moves the drift by
# 0.9% (the MLP) to 1.5% (the frame attention) of that max, one that halves
# it by 0.4% to 0.7%; fused and dense differ by 1e-4
MICRO_TOL = 2e-3
# the card's published peaks (H100 SXM, at 700 W): memory, and operations
# by type (f32 outside the tensor cores; split TF32, three TF32 products per
# f32 product, shown beside it)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12, "3xtf32": 495e12 / 3}
PEAK_NAMES = {"bf16": "bf16 tensor cores", "f32": "f32 CUDA cores", "3xtf32": "split TF32"}


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


def _graph_ms(torch, fn, iters=20, split=None):
    """Device ms per call: CUDA events around one replay of a CUDA graph of
    ``iters`` calls, so that the wrapper's host time is not counted. With a
    dict ``split``, one more replay runs under torch.profiler and fills it
    with device µs per call of each kernel name (left empty if the profiler
    sees no device activity)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    if split is not None:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            graph.replay()
            torch.cuda.synchronize()
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                n = _short(e.name)
                split[n] = split.get(n, 0.0) + e.time_range.elapsed_us() / iters
    del graph
    return start.elapsed_time(end) / iters


def _host_us(torch, fn, iters=200):
    """Host µs per call: the Python wrapper and its launches, timed on the
    host clock with no sync inside the loop (200 calls of two or three
    launches stay inside the stream's launch queue, so the device never
    holds the loop back)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host = (time.perf_counter() - t0) / iters * 1e6
    torch.cuda.synchronize()
    return host


def _probe_host_us(torch, call, args, iters=2000):
    """The forward-mode refusal's host cost on a fused wrapper: its host µs
    per call with ``refuse_tangent`` switched off (the wrapper as it was
    before the refusal), and the probe alone on the same arguments."""
    from mdgen_tpu_torch.ops import _common

    probe = _common.refuse_tangent
    _common.refuse_tangent = lambda *a: None
    try:
        without = _host_us(torch, call)
    finally:
        _common.refuse_tangent = probe
    t0 = time.perf_counter()
    for _ in range(iters):
        probe("probe", *args)
    return without, (time.perf_counter() - t0) / iters * 1e6


def _bound(n_bytes, flops, kind):
    """(ms, what bounds it): the least time for the work on this card."""
    t_mem, t_ops = n_bytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[kind]
    return max(t_mem, t_ops) * 1e3, "bytes" if t_mem >= t_ops else "operations"


def _nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def _sublayer_bound(torch, name, args, y, mask):
    """Bytes: each input read once, y written once. Operations: the
    projections (2 per multiply-add) and the attention the mask leaves
    (q.k and p.v over the valid keys and the bias token, 4 per channel)."""
    x = args[0]
    Bx, Tx, Lx, Cx = x.shape
    n_tok = Bx * Tx * Lx
    if name == "fused_ffn_sublayer":
        flops = 2 * n_tok * Cx * args[4].shape[0] * 2
    else:
        flops = 2 * n_tok * Cx * 4 * Cx
        valid = mask.float()  # [B, L]
        if name == "fused_l_sublayer":  # each query: its row's valid residues
            keys = (valid.sum(1, keepdim=True) + 1).expand(Bx, Lx) * Tx
        else:  # each query of residue l: T frames if l is valid, + the bias key
            keys = (valid * Tx + 1) * Tx
        flops += int(4 * Cx * keys.sum().item())
    return _bound(_nbytes(*[a for a in args if torch.is_tensor(a)], y), flops, "bf16")


def _sublayer_inputs(torch, b, t, l, seed):
    """Seeded f32 inputs of the fused sublayers at [b, t, l, C], and a mask
    with the last batch entry's last residue masked."""
    g = torch.Generator().manual_seed(seed)
    rnd = lambda *s, sc=1.0: (torch.randn(*s, generator=g) * sc).cuda()  # noqa: E731
    base = dict(
        x=rnd(b, t, l, C), shift=rnd(b, 1, C, sc=0.1), scale=rnd(b, 1, C, sc=0.1),
        gate=rnd(b, 1, C, sc=0.5), qkv_w=rnd(3 * C, C, sc=C**-0.5), qkv_b=rnd(3 * C, sc=0.05),
        bias_k=rnd(C, sc=0.3), bias_v=rnd(C, sc=0.3), out_w=rnd(C, C, sc=C**-0.5),
        out_b=rnd(C, sc=0.05), w1=rnd(4 * C, C, sc=C**-0.5), b1=rnd(4 * C, sc=0.05),
        w2=rnd(C, 4 * C, sc=(4 * C) ** -0.5), b2=rnd(C, sc=0.05),
    )
    mask = torch.ones(b, l, device="cuda")
    mask[-1, -1] = 0.0
    return base, mask


def _fused_fns():
    """name: (kernel, plain twin, parameter names, takes the mask)."""
    from mdgen_tpu_torch import ops

    attn = ["shift", "scale", "gate", "qkv_w", "qkv_b", "bias_k", "bias_v", "out_w", "out_b"]
    ffn = ["shift", "scale", "gate", "w1", "b1", "w2", "b2"]
    return {
        "fused_l_sublayer": (ops.fused_l_sublayer, ops.fused_l_sublayer_plain, attn, True),
        "fused_t_sublayer": (ops.fused_t_sublayer, ops.fused_t_sublayer_plain, attn, True),
        "fused_ffn_sublayer": (ops.fused_ffn_sublayer, ops.fused_ffn_sublayer_plain, ffn, False),
    }


def _fused_args(base, mask, names, is_attn, dt, heads=H):
    """(args, kwargs) of a fused sublayer, serving style: parameters and
    adaLN chunks in the compute dtype ``dt``, x in f32."""
    args = [base["x"]] + [base[n].to(dt) for n in names]
    kw = dict(compute_dtype=dt)
    if is_attn:
        args.insert(4, mask)
        kw["num_heads"] = heads
    return args, kw


def phase_kernel_parity(torch):
    base, mask = _sublayer_inputs(torch, B, T, L, seed=0)
    results = {}
    for name, (kern, plain, names, is_attn) in _fused_fns().items():
        res = {"max_abs_err": 0.0}
        for dname, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            args, kw = _fused_args(base, mask, names, is_attn, dt)
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
            call, twin = (lambda: kern(*args, **kw)), (lambda: plain(*args, **kw))
            device_ms, plain_device_ms = _graph_ms(torch, call), _graph_ms(torch, twin)
            if dname == "f32":
                log(f"[time] {name} f32: device: kernel {device_ms:.4f} ms, plain "
                    f"{plain_device_ms:.4f} ms (CUDA graph of 20 calls)")
                continue
            # bf16, the main path's dtype: eagerly through the wrapper (`ms`)
            # and as device time
            res.update(ms=_time_ms(torch, call), plain_ms=_time_ms(torch, twin),
                       device_ms=device_ms, host_us=_host_us(torch, call))
            res["host_us_no_tangent_probe"], res["tangent_probe_us"] = _probe_host_us(
                torch, call, args)
            res["bound_ms"], res["bound_by"] = _sublayer_bound(torch, name, args, y, mask)
            log(f"[time] {name} bf16: eager through the wrapper (CUDA events, 20 calls): kernel "
                f"{res['ms']:.4f} ms, plain {res['plain_ms']:.4f} ms; device: kernel "
                f"{device_ms:.4f} ms, plain {plain_device_ms:.4f} ms (CUDA graph of 20 calls); "
                f"the wrapper's host time {res['host_us']:.1f} us per call "
                f"({res['host_us_no_tangent_probe']:.1f} us with the forward-mode refusal off, "
                f"the refusal alone {res['tangent_probe_us']:.2f} us); bound "
                f"{res['bound_ms']:.5f} ms ({res['bound_by']}), {res['bound_ms'] / res['ms']:.2%} "
                f"of it reached eagerly, {res['bound_ms'] / device_ms:.2%} in device time")
        results[name] = res
    results["fused_t_sublayer"].update(_time_frame_long(torch))
    results.update(phase_optimizer_parity(torch))
    for name, dname, err in _check_tensor_core_edges(torch):
        worst = results[name].setdefault("edge_err", {})
        worst[dname] = max(worst.get(dname, 0.0), err)
    return results


def _time_frame_long(torch):
    """Kernel 2 at T = 1000, L = 4 (the sampling path of a run trained at the
    recipe's frame count, phase 11), bf16: parity, then times as at the main
    shape. Returns its numbers for the kernels line."""
    b, t = 1, TRAIN_FRAMES
    base, mask = _sublayer_inputs(torch, b, t, L, seed=0)
    kern, plain, names, _ = _fused_fns()["fused_t_sublayer"]
    args, kw = _fused_args(base, mask, names, True, torch.bfloat16)
    y, ref = kern(*args, **kw), plain(*args, **kw)
    torch.cuda.synchronize()
    err = (y - ref).abs().max().item()
    if not (bool(torch.isfinite(y).all()) and err <= TOL["bf16"]):
        raise AssertionError(f"fused_t_sublayer bf16 at T={t} disagrees with its plain version: {err}")
    call, twin = (lambda: kern(*args, **kw)), (lambda: plain(*args, **kw))
    ms, plain_ms = _time_ms(torch, call), _time_ms(torch, twin)
    device_ms, plain_device_ms = _graph_ms(torch, call), _graph_ms(torch, twin)
    bound_ms, bound_by = _sublayer_bound(torch, "fused_t_sublayer", args, y, mask)
    log(f"[time] fused_t_sublayer bf16 B={b} T={t} L={L}: max_abs_err {err:.3e} (tol "
        f"{TOL['bf16']:g}); eager through the wrapper (CUDA events, 20 calls): kernel {ms:.4f} "
        f"ms, plain {plain_ms:.4f} ms; device: kernel {device_ms:.4f} ms, plain "
        f"{plain_device_ms:.4f} ms (CUDA graph of 20 calls); bound {bound_ms:.5f} ms "
        f"({bound_by}), {bound_ms / device_ms:.2%} of it in device time")
    return {"t1000_max_abs_err": err, "t1000_ms": ms, "t1000_device_ms": device_ms,
            "t1000_plain_ms": plain_ms, "t1000_plain_device_ms": plain_device_ms,
            "t1000_bound_ms": bound_ms, "t1000_bound_by": bound_by}


def _check_tensor_core_edges(torch):
    """The fused kernels (1-3) at token counts that are no multiple of their
    tiles, and kernel 2 at FRAME_EDGE_SHAPES; f32 and bf16, a masked residue;
    two calls on the same inputs bit-equal. Returns [(kernel, dtype, err)]."""
    fns = _fused_fns()
    cases = [(shape, (*dims, H), list(fns)) for shape, dims in EDGE_SHAPES.items()]
    cases += [(shape, dims, ["fused_t_sublayer"]) for shape, dims in FRAME_EDGE_SHAPES.items()]
    rows = []
    for shape, (b, t, l, heads), kernels in cases:
        base, mask = _sublayer_inputs(torch, b, t, l, seed=1)
        if shape == "all_masked":
            mask[0] = 0.0
        for name in kernels:
            kern, plain, names, is_attn = fns[name]
            for dname, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
                args, kw = _fused_args(base, mask, names, is_attn, dt, heads)
                y1, y2, ref = kern(*args, **kw), kern(*args, **kw), plain(*args, **kw)
                torch.cuda.synchronize()
                err = (y1 - ref).abs().max().item()
                same = torch.equal(y1, y2)
                ok = bool(torch.isfinite(y1).all()) and err <= TOL[dname] and same
                log(f"[edge] {name} {dname} B={b} T={t} L={l} heads={heads} ({shape}, "
                    f"{b * t * l} tokens): max_abs_err {err:.3e}, tol {TOL[dname]:g}, bit-equal "
                    f"twice {same} -> {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"{name} {dname} at {shape}: {err}, bit-equal {same}")
                rows.append((name, dname, err))
        del base
        torch.cuda.empty_cache()
    return rows


def _launch_split(torch):
    """Each fused kernel's launches at the main shape, and kernel 2's at T =
    1000 in bf16: device µs per call of each kernel name, from one
    CUDA-graph replay under torch.profiler."""
    fns = _fused_fns()
    runs = [(name, dname, dt, T) for name in fns
            for dname, dt in (("f32", torch.float32), ("bf16", torch.bfloat16))]
    runs.append(("fused_t_sublayer", "bf16", torch.bfloat16, TRAIN_FRAMES))
    for name, dname, dt, t in runs:
        kern, _, names, is_attn = fns[name]
        base, mask = _sublayer_inputs(torch, B, t, L, seed=0)
        args, kw = _fused_args(base, mask, names, is_attn, dt)
        split = {}
        _graph_ms(torch, lambda: kern(*args, **kw), split=split)
        per_launch = ", ".join(f"{n} {us:.2f} us" for n, us in split.items())
        log(f"[profile] {name} {dname} T={t} (CUDA graph replay of 20 calls): per launch "
            f"{per_launch or 'not measured: the profiler saw no device activity'}")


def _optimizer_rows(torch, ema, seed=0):
    """[params, grads, mu, nu, ema or None] at the 4AA model's parameter
    shapes on the card, a state some steps in: random p, g, mu and EMA, a
    positive nu."""
    from mdgen_tpu_torch.models import LatentMDGenModel

    cfg = bench_config(num_frames=TRAIN_FRAMES)
    shapes = [p.shape for p in LatentMDGenModel(cfg, cfg.latent_dim).parameters()]
    g = torch.Generator(device="cuda").manual_seed(seed)
    row = lambda sc: [torch.randn(s, generator=g, device="cuda") * sc for s in shapes]  # noqa: E731
    p = row(0.05)
    e = [x + y for x, y in zip(p, row(1e-3))] if ema else None
    return [p, row(1e-3), row(1e-3), [t.abs() for t in row(1e-6)], e]


def _optimizer_kw(count, clip):
    """The 4AA recipe's Adam (lr 1e-4, no weight decay, EMA 0.999)."""
    return dict(count=count, lr=1e-4, grad_clip=clip, b1=0.9, b2=0.999, eps=1e-8,
                weight_decay=0.0, ema_decay=0.999)


def phase_optimizer_parity(torch):
    """[optim]: kernel 8 against its plain twins, with an EMA and the clip
    engaged (the 4AA path) and with neither; times and bounds. Returns its
    numbers for the kernels line (the EMA case; the other under
    ``no_ema``)."""
    from mdgen_tpu_torch import ops

    res = {"sum_of_squares": {}, "fused_adam": {}}
    for ema in (True, False):
        rows = _optimizer_rows(torch, ema)
        n = sum(t.numel() for t in rows[0])
        ref = [None if r is None else [t.clone() for t in r] for r in rows]
        norm = ops.sum_of_squares(rows[1], root=True)
        again = ops.sum_of_squares(rows[1], root=True)
        plain_norm = ops.sum_of_squares_plain(rows[1], root=True)
        torch.cuda.synchronize()
        norm_err = abs(norm.item() - plain_norm.item())
        clip = norm.item() / 2 if ema else norm.item() * 2
        kw = _optimizer_kw(10, clip)
        ops.fused_adam(*rows, norm, **kw)
        ops.fused_adam_plain(*ref, norm, **kw)
        torch.cuda.synchronize()
        names = ("p", "g", "mu", "nu", "ema")
        err = max(_abs_err(a, b) for r, q in zip(rows, ref) if r is not None
                  for a, b in zip(r, q))
        differ = [nm for nm, r, q in zip(names, rows, ref) if r is not None
                  and not all(torch.equal(a, b) for a, b in zip(r, q))]
        ok = (torch.equal(norm, again) and bool(torch.isfinite(norm))
              and norm_err <= OPT_NORM_TOL * plain_norm.item() and not differ)
        what = "EMA, clip engaged" if ema else "no EMA, clip not engaged"
        log(f"[optim] {len(rows[0])} tensors, {n:,} f32 ({what}): norm {norm.item():.9e}, plain "
            f"{plain_norm.item():.9e}, rel err {norm_err / plain_norm.item():.3e} (tol "
            f"{OPT_NORM_TOL:g}), bit-equal twice {torch.equal(norm, again)}; fused_adam vs the "
            f"eager loop given that norm: max_abs_err {err:.3e}, rows not bit-equal {differ} -> "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"optimizer pass ({what}): norm err {norm_err}, rows {differ}")
        del ref
        grads = rows[1]
        sq = lambda: ops.sum_of_squares(grads, root=True)  # noqa: E731
        sq_plain = lambda: ops.sum_of_squares_plain(grads, root=True)  # noqa: E731
        sq_lib = lambda: torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))  # noqa: E731
        adam = lambda: ops.fused_adam(*rows, norm, **kw)  # noqa: E731
        adam_plain = lambda: ops.fused_adam_plain(*rows, norm, **kw)  # noqa: E731
        leaves = [t.clone().requires_grad_() for t in rows[0]]
        for q, g in zip(leaves, grads):
            q.grad = g
        adam_lib = torch.optim.Adam(leaves, lr=1e-4, fused=True).step
        n_adam = n * 4 * (1 + 2 * (4 if ema else 3))  # g read; p, mu, nu (EMA) read and written
        out = {}
        for name, call, twin, lib, nbytes, e in (
                ("sum_of_squares", sq, sq_plain, sq_lib, n * 4, norm_err),
                ("fused_adam", adam, adam_plain, adam_lib, n_adam, err)):
            t = {"max_abs_err": e, "ms": _time_ms(torch, call), "device_ms": _graph_ms(torch, call),
                 "host_us": _host_us(torch, call, iters=50),
                 "plain_ms": _time_ms(torch, twin, iters=5), "library_ms": _time_ms(torch, lib)}
            t["bound_ms"], t["bound_by"] = _bound(nbytes, 0, "f32")
            out[name] = t
        pass_bound = out["sum_of_squares"]["bound_ms"] + out["fused_adam"]["bound_ms"]
        pass_ms = out["sum_of_squares"]["device_ms"] + out["fused_adam"]["device_ms"]
        log(f"[time] optimizer pass ({what}): " + "; ".join(
            f"{k} eager {v['ms']:.4f} ms, device {v['device_ms']:.4f} ms (CUDA graph of 20 "
            f"calls), the wrapper's host time {v['host_us']:.1f} us, bound {v['bound_ms']:.4f} "
            f"ms (bytes), plain {v['plain_ms']:.3f} ms eager, library {v['library_ms']:.4f} ms"
            for k, v in out.items())
            + f"; the pass {pass_ms:.4f} device ms against a bound of {pass_bound:.4f} "
            f"({pass_bound / pass_ms:.1%}) (library: the norm by torch._foreach_norm; "
            f"torch.optim.Adam(fused=True), no clip, no EMA)")
        for name, t in out.items():
            if ema:
                res[name].update(t)
            else:
                res[name]["no_ema"] = t
        del rows, grads, leaves, adam_lib
        torch.cuda.empty_cache()
    return res


def _profile_optimizer(torch):
    """The optimizer's eager loop (kernel 8's plain twins) with an EMA:
    device ms a pass, the profiler's sum over its kernels and copies."""
    from mdgen_tpu_torch import ops

    rows = _optimizer_rows(torch, True)
    kw = _optimizer_kw(10, 1.0)

    def plain():
        ops.fused_adam_plain(*rows, ops.sum_of_squares_plain(rows[1], root=True), **kw)

    plain()
    torch.cuda.synchronize()
    res = _profiled(torch, plain)
    if res is None:
        log("[profile] optimizer eager loop: torch.profiler saw no device activity: not measured")
        return {}
    per, spans, _ = res
    ms = sum(v for v, _ in per.values())
    log(f"[profile] the optimizer's eager loop (kernel 8's plain twins, EMA, 193 tensors): "
        f"device {ms:.3f} ms a pass in {len(spans)} launches")
    del rows
    torch.cuda.empty_cache()
    return {"plain_device_ms": ms, "plain_launches": len(spans)}


def _abs_err(a, ref):
    """max |a - ref| in f32."""
    return (a.float() - ref.float()).abs().max().item()


def _rel_err(a, ref):
    """max |a - ref| / max |ref| in f32."""
    return _abs_err(a, ref) / ref.float().abs().max().item()


def phase_flash_parity(torch):
    """Kernels 4-7 against their plain twins at the training recipe's frame
    attention (N = B*L*H = 512 rows, Tq = 1000 frames, Tk = 1001 with the
    bias token, d = 24), with one masked residue's 16 rows (every frame key
    finfo.min, only the bias key valid), in f32 and with bf16 operands. The
    backward kernels take the twin's (o, lse) so that each is held alone;
    each kernel runs twice and must give the same bits. Then all four at the
    edge shapes."""
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
        o4, o4b = fa.flash_fwd(qd, kd, vd, bias), fa.flash_fwd(qd, kd, vd, bias)
        (o5, lse5), fwd2 = fa.flash_fwd_lse(qd, kd, vd, bias), fa.flash_fwd_lse(qd, kd, vd, bias)
        dq, dq2 = fa.flash_bwd_dq(*bwd), fa.flash_bwd_dq(*bwd)
        (dk, dv, db), dkv2 = fa.flash_bwd_dkv(*bwd), fa.flash_bwd_dkv(*bwd)
        dq_r = fa.flash_bwd_dq_plain(*bwd)
        dk_r, dv_r, db_r = fa.flash_bwd_dkv_plain(*bwd)
        torch.cuda.synchronize()
        same = {"flash_fwd": torch.equal(o4, o4b),
                "flash_fwd_lse": torch.equal(o5, fwd2[0]) and torch.equal(lse5, fwd2[1]),
                "flash_bwd_dq": torch.equal(dq, dq2),
                "flash_bwd_dkv": all(torch.equal(a, b) for a, b in zip((dk, dv, db), dkv2))}
        del o4b, fwd2, dq2, dkv2
        # o and lse: absolute; gradients: relative to their largest entry
        errs = {
            "flash_fwd": [("o", _abs_err(o4, o_ref), "abs")],
            "flash_fwd_lse": [("o", _abs_err(o5, o_ref), "abs"),
                              ("lse", _abs_err(lse5, lse_ref), "abs")],
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
                ok = (err <= tol and same[name]
                      and all(bool(torch.isfinite(t).all()) for t in outs[name]))
                log(f"[flash] {name} {dname}: {what} {kind} err {err:.3e}, tol {tol:g}, bit-equal "
                    f"twice {same[name]} -> {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"{name} {dname} {what} disagrees with its plain twin: "
                                         f"{err}, bit-equal twice {same[name]}")
            abs_err = max(_abs_err(a, b) for a, b in zip(outs[name], refs[name]))
            results[name]["max_abs_err"] = max(results[name]["max_abs_err"], abs_err)
        del o_ref, dq_r, dk_r, dv_r, db_r, refs, outs, o4, o5, dq, dk, dv, db
        timed = {
            "flash_fwd": (lambda: fa.flash_fwd(qd, kd, vd, bias),
                          lambda: fa.flash_attention_plain(qd, kd, vd, bias)[0]),
            "flash_fwd_lse": (lambda: fa.flash_fwd_lse(qd, kd, vd, bias),
                              lambda: fa.flash_attention_plain(qd, kd, vd, bias)),
            "flash_bwd_dq": (lambda: fa.flash_bwd_dq(*bwd), lambda: fa.flash_bwd_dq_plain(*bwd)),
            "flash_bwd_dkv": (lambda: fa.flash_bwd_dkv(*bwd),
                              lambda: fa.flash_bwd_dkv_plain(*bwd)),
        }
        library = _library_calls(torch, qd, kd, vd, bias, dod)
        lib_device = {}  # one graph per library call (6 and 7 share the backward)
        bounds = _flash_bounds(torch, qd, kd, vd, bias, dod, lse_ref, delta)
        for name, (kern, plain) in timed.items():
            ms, lib_ms = _time_ms(torch, kern, iters=10), _time_ms(torch, library[name], iters=10)
            device_ms = _graph_ms(torch, kern, iters=5)
            if library[name] not in lib_device:
                lib_device[library[name]] = _graph_ms(torch, library[name], iters=5)
            lib_device_ms = lib_device[library[name]]
            # the plain twins only in f32, the recipe's precision (32-true)
            plain_ms = _time_ms(torch, plain, iters=10) if dname == "f32" else None
            (bound_ms, bound_by, peak), cuda_core_ms = bounds[name]
            lib_what = ("one backward call for kernels 6 and 7: dq, dk, dv"
                        if name.startswith("flash_bwd") else "memory-efficient attention")
            log(f"[time] {name} {dname} N={N} Tq={Tq} Tk={Tk} d={d}: kernel {ms:.4f} ms, "
                + (f"plain {plain_ms:.4f} ms, " if plain_ms is not None else "")
                + f"library {lib_ms:.4f} ms ({lib_what}) (CUDA events, 10 calls); device: "
                f"kernel {device_ms:.4f} ms, library {lib_device_ms:.4f} ms (CUDA graph of 5 "
                f"calls); bound {bound_ms:.4f} ms ({bound_by}, {peak}), {bound_ms / ms:.1%} of it "
                f"reached, {bound_ms / device_ms:.1%} in device time"
                + (f"; {cuda_core_ms:.4f} ms at the f32 CUDA-core peak of "
                   f"{PEAK_FLOPS['f32'] / 1e12:g} TFLOP/s, {cuda_core_ms / device_ms:.1%} of it"
                   if dname == "f32" else ""))
            if dname == "f32":
                results[name].update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                                     device_ms=device_ms, library_device_ms=lib_device_ms,
                                     bound_ms=bound_ms, bound_by=bound_by, bound_peak=peak,
                                     cuda_core_bound_ms=cuda_core_ms)
            else:
                results[name].update(bf16_ms=ms, bf16_device_ms=device_ms, bf16_library_ms=lib_ms,
                                     bf16_library_device_ms=lib_device_ms,
                                     bf16_bound_ms=bound_ms, bf16_bound_by=bound_by)
        del lse_ref, library, lib_device, bwd, timed
        torch.cuda.empty_cache()
    for name, dname, _, err, _, _ in _check_flash_edges(torch, fa):
        worst = results[name].setdefault("edge_err", {})
        worst[dname] = max(worst.get(dname, 0.0), err)
    return results


def _check_flash_edges(torch, fa, shapes=FLASH_EDGE_SHAPES, dtypes=("f32", "bf16"), strict=True):
    """Kernels 4-7 at ``shapes``, in ``dtypes`` (f32, bf16 operands), keys
    of the middle third masked (and, with N > 1, row 0 with its last key
    alone); against the plain twins within FLASH_TOL (o and lse absolute,
    the backward kernels' outputs relative to their largest entry, with the
    twin's o and lse as inputs), and twice bit-equal. Returns [(kernel,
    dtype, shape, err, bit-equal, ok)]; ``strict`` raises at the first that
    is not ok."""
    rows = []
    for shape, (N, Tq, Tk, d) in shapes.items():
        g = torch.Generator().manual_seed(1)
        q = torch.randn(N, Tq, d, generator=g) * d**-0.5
        k, v = torch.randn(N, Tk, d, generator=g), torch.randn(N, Tk, d, generator=g)
        do = torch.randn(N, Tq, d, generator=g)
        mask = torch.ones(N, Tk)
        mask[:, Tk // 3: Tk // 2] = 0.0
        if N > 1:  # its dq, dk, dbias are 0 up to rounding: only beside other rows
            mask[0, :-1] = 0.0
        bias = torch.where(mask > 0, 0.0, fa.NEG_INF).cuda()
        for dname in dtypes:
            dt = {"f32": torch.float32, "bf16": torch.bfloat16}[dname]
            qd, kd, vd, dod = (t.to(dt).cuda() for t in (q, k, v, do))
            o, lse = fa.flash_attention_plain(qd, kd, vd, bias)
            bwd = (qd, kd, vd, bias, dod, lse, fa.attention_delta(o, dod))
            runs = [(fa.flash_fwd(qd, kd, vd, bias), *fa.flash_fwd_lse(qd, kd, vd, bias),
                     fa.flash_bwd_dq(*bwd), *fa.flash_bwd_dkv(*bwd)) for _ in range(2)]
            refs = (o, o, lse, fa.flash_bwd_dq_plain(*bwd), *fa.flash_bwd_dkv_plain(*bwd))
            torch.cuda.synchronize()
            for name, idx, kind in (("flash_fwd", (0,), "abs"), ("flash_fwd_lse", (1, 2), "abs"),
                                    ("flash_bwd_dq", (3,), "rel"),
                                    ("flash_bwd_dkv", (4, 5, 6), "rel")):
                tol, diff = FLASH_TOL[dname][kind], {"abs": _abs_err, "rel": _rel_err}[kind]
                err = max(diff(runs[0][i], refs[i]) for i in idx)
                same = all(torch.equal(runs[0][i], runs[1][i]) for i in idx)
                ok = (err <= tol and same
                      and all(bool(torch.isfinite(runs[0][i]).all()) for i in idx))
                log(f"[edge] {name} {dname} N={N} Tq={Tq} Tk={Tk} d={d} ({shape}): {kind} err "
                    f"{err:.3e}, tol {tol:g}, bit-equal twice {same} -> {'ok' if ok else 'FAIL'}")
                rows.append((name, dname, shape, err, same, ok))
                if strict and not ok:
                    raise AssertionError(f"{name} {dname} at {shape}: {err}, bit-equal {same}")
            del runs, refs, o, lse, bwd
        torch.cuda.empty_cache()
    return rows


def _library_calls(torch, q, k, v, bias, do):
    """One PyTorch call per kernel that computes the same function on the
    same inputs (timed beside the kernels, never called by the port):
    PyTorch's memory-efficient attention, forced with sdpa_kernel so that it
    raises rather than falls back to the math backend, q as [N, 1, Tq, d]
    with scale 1 (q arrives pre-scaled) and the 0 / finfo.min key bias as
    the mask (kernel 4); its aten op with the logsumexp (kernel 5); and its
    backward, one call for dq, dk and dv (kernels 6 and 7; no dbias)."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    N, Tq, _ = q.shape
    Tk = k.shape[1]
    q4, k4, v4, do4 = (t[:, None] for t in (q, k, v, do))
    mask = bias[:, None, None, :].to(q.dtype)
    # the aten op takes the bias [N, 1, Tq, Tk] with rows 16-element aligned,
    # as scaled_dot_product_attention prepares it
    aligned = F.pad(mask, (0, (-Tk) % 16))[..., :Tk].expand(N, 1, Tq, Tk)
    eff = torch.ops.aten._scaled_dot_product_efficient_attention
    eff_bwd = torch.ops.aten._scaled_dot_product_efficient_attention_backward

    def fwd():
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            return F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask, scale=1.0)

    def fwd_lse():
        return eff(q4, k4, v4, aligned, True, 0.0, False, scale=1.0)

    o, lse, seed, offset = fwd_lse()[:4]

    def bwd():
        return eff_bwd(do4, q4, k4, v4, aligned, o, lse, seed, offset, 0.0,
                       [True, True, True, False], False, scale=1.0)

    return {"flash_fwd": fwd, "flash_fwd_lse": fwd_lse, "flash_bwd_dq": bwd, "flash_bwd_dkv": bwd}


def _flash_bounds(torch, q, k, v, bias, do, lse, delta):
    """Per flash kernel ((bound ms, by, peak), f32 CUDA-core bound ms): each
    input read once and each output written once, in the operands' dtype;
    operations over the (query, key) pairs that the mask leaves valid, d
    channels each: 4 flops (q.k, p.v) for the forward, 6 for dq (s, dp,
    ds.k), 8 for dk/dv (s, dv, dp, dk). The peak is that of the least costly
    route to the same result on this card: f32 operands at split TF32 (three
    TF32 products per f32 product, 495 / 3 TFLOP/s: the f32-exact tensor-core
    route of kernels 1, 3, 6 and 7 and of the library), with the f32
    CUDA-core peak (67 TFLOP/s) beside it; bf16 operands at the bf16 tensor
    cores' 989 TFLOP/s."""
    Tq, d = q.shape[1], q.shape[2]
    pairs = Tq * int((bias == 0).sum().item())
    fwd_in = _nbytes(q, k, v, bias)
    bwd_in = _nbytes(q, k, v, bias, do, lse, delta)
    work = {"flash_fwd": (fwd_in + _nbytes(q), 4),
            "flash_fwd_lse": (fwd_in + _nbytes(q, lse), 4),
            "flash_bwd_dq": (bwd_in + _nbytes(q), 6),
            "flash_bwd_dkv": (bwd_in + _nbytes(k, v, bias), 8)}
    kind = "3xtf32" if q.dtype == torch.float32 else "bf16"
    peak = f"{PEAK_NAMES[kind]} at {PEAK_FLOPS[kind] / 1e12:g} TFLOP/s"
    return {name: ((*_bound(n_bytes, per * pairs * d, kind), peak),
                   _bound(n_bytes, per * pairs * d, "f32")[0])
            for name, (n_bytes, per) in work.items()}


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
    from mdgen_tpu_torch.micro_fwd import seeded_model

    return seeded_model(cfg)


def _start(torch):
    """The main path's start frame, sequence and residue mask on the card."""
    import numpy as np

    from mdgen_tpu_torch.data import synthetic_trajectory
    from mdgen_tpu_torch.geometry import constants as rc

    start = torch.from_numpy(synthetic_trajectory(SEQ, 1, seed=0)[0].astype(np.float32))[None]
    seqres = torch.from_numpy(rc.str_sequence_to_aatype(SEQ)[None]).long()
    return start.cuda(), seqres.cuda(), torch.ones(B, L, device="cuda")


def _runtime(torch, cfg, state_dict):
    """An MDGenRuntime for ``cfg`` with ``state_dict`` loaded, on the card."""
    from mdgen_tpu_torch.models import LatentMDGenModel
    from mdgen_tpu_torch.runtime import MDGenRuntime

    model = LatentMDGenModel(cfg, cfg.latent_dim)
    model.load_state_dict(state_dict)
    return MDGenRuntime(cfg, model.cuda())


def phase_model_parity(torch, state_dict, cfg=None, tag="model", tols=None, rollouts=2,
                       frame_kernel=True):
    """Fused against dense from the same inputs, for the bench model or for
    ``cfg`` (another configuration at the bench shape): one forward at
    t = 0.4 in each precision of ``tols`` (its tolerance relative to
    max(|out|, 1)), then ``rollouts`` f32 rollouts of 4 Euler steps (T = 100),
    each fused rollout from the dense one's start, within 1e-3 A; the fused
    rollouts launch kernels 1 and 3 (and 2 when ``frame_kernel``) once a layer
    and an evaluation and no flash kernel, the dense ones nothing. Returns the
    fused rollouts' launch counts."""
    from mdgen_tpu_torch import ops
    from mdgen_tpu_torch.runtime import tokenize
    from mdgen_tpu_torch.tasks import prep_batch

    cfg = cfg or bench_config()
    # relative to max(|out|, 1): f32 sums in another order; under bf16-mixed
    # the dense path rounds q, k, logits and probs to bf16 where the fused
    # residue kernel keeps f32, as in the JAX package
    tols = tols or {"32-true": TOL["f32"], "bf16-mixed": TOL["bf16"]}
    start, seqres, mask = _start(torch)
    g = torch.Generator(device="cuda")
    for precision, tol in tols.items():
        outs = {}
        for fused in (False, True):
            c = cfg.replace(precision=precision, fused_block=fused)
            rt = _runtime(torch, c, state_dict)
            prep = prep_batch(c, tokenize(c, {"atom14": start[:, None].expand(B, T, L, 14, 3),
                                              "seqres": seqres, "mask": mask}))
            x = torch.randn(B, T, L, c.latent_dim, device="cuda", generator=g.manual_seed(1))
            with torch.inference_mode():
                outs[fused] = rt.model_inf(x, torch.full((B,), 0.4, device="cuda"),
                                           **prep.model_kwargs).float()
            del rt
        err = (outs[True] - outs[False]).abs().max().item()
        scale = outs[False].abs().max().item()
        ok = bool(torch.isfinite(outs[True]).all()) and scale > 1e-2 and err <= tol * max(scale, 1.0)
        log(f"[{tag}] 5x384x16 forward {precision}: fused vs dense max_abs_err {err:.3e} "
            f"(|out| max {scale:.3f}), tol {tol:g} x max(|out|,1) -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{tag}: fused and dense forwards disagree ({precision}): {err}")

    # Re-encoding a start is ill-conditioned at residue 0: its pre-omega
    # torsion comes from a frame whose two padding atoms (the absent previous
    # residue) coincide, so it is rounding noise that enters x_cond (as in the
    # JAX package). A difference of an f32 ulp at the end of rollout 1 then
    # gives rollout 2 another conditioning torsion, on either path: the
    # chained figure is printed, not held.
    noise = torch.randn(rollouts, B, T, L, cfg.latent_dim, device="cuda",
                        generator=g.manual_seed(2))
    rts = {fused: _runtime(torch, cfg.replace(precision="32-true", fused_block=fused,
                                              sampling_method="euler", inference_steps=4),
                           state_dict)
           for fused in (False, True)}
    ops.reset_launch_counts()
    dense = rts[False].rollout(start, seqres, mask, rollouts, noise=noise)
    torch.cuda.synchronize()
    dense_counts = ops.launch_counts()
    starts = [start] + [dense[:, r * T - 1] for r in range(1, rollouts)]
    ops.reset_launch_counts()
    fused = torch.cat([rts[True].rollout(s, seqres, mask, 1, noise=noise[r:r + 1])
                       for r, s in enumerate(starts)], dim=1)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    chained = ""
    if rollouts > 1:
        diff = (rts[True].rollout(start, seqres, mask, rollouts, noise=noise) - dense).abs().max()
        chained = f" (chained from its own start: {diff.item():.3e} A, not held)"
    del rts
    err = (fused - dense).abs().max().item()
    n = rollouts * 3 * cfg.num_layers  # 4 Euler steps: 3 evaluations
    want = {"fused_l_sublayer": n, "fused_t_sublayer": n if frame_kernel else 0,
            "fused_ffn_sublayer": n}
    ok = (bool(torch.isfinite(fused).all()) and err <= 1e-3
          and all(counts[k] == v for k, v in want.items())
          and not any(counts[k] for k in FLASH_KERNELS) and not any(dense_counts.values()))
    log(f"[{tag}] rollout {rollouts} x {T} frames, 4 Euler steps, f32, each fused rollout from "
        f"the dense one's start: fused vs dense max_abs_err {err:.3e} A, tol 1e-3 A; launches "
        f"fused {counts} (want {want}), dense {dense_counts} -> {'ok' if ok else 'FAIL'}{chained}")
    if not ok:
        raise AssertionError(f"{tag}: fused and dense rollouts disagree: {err} A, {counts}, "
                             f"{dense_counts}")
    return counts


def phase_main_path(state_dict, smi):
    with tempfile.TemporaryDirectory(prefix="mdgen_smoke_") as work:
        return _main_path(state_dict, smi, work)


def _main_path(state_dict, smi, work):
    import numpy as np

    from mdgen_tpu_torch import ops, sim_inference
    from mdgen_tpu_torch.data import synthetic_trajectory
    from mdgen_tpu_torch.geometry import constants as rc
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
    rec = sim_inference.main(argv + ["--num_rollouts", str(ROLLOUTS)], keep_trajectories=True)[0]
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
    bad = {k: v for k, v in counts.items() if v != (want if k in FUSED_KERNELS else 0)}
    if bad:
        raise AssertionError(f"launch counts {bad}, expected {want} for each fused kernel "
                             "and 0 for the flash kernels (T=100: 101 keys, dense)")
    aatype = rc.str_sequence_to_aatype(SEQ)
    writes = _writes(rec, [(rec["traj"][0], aatype, f"{SEQ}.pdb", None)])
    return counts, rec["seconds"] / ROLLOUTS, writes


def _writes(rec, items):
    """What [native-io] writes again: the path's trajectories as its CLI
    wrote them (atom14, aatype, PDB name, XTC name or None), the path's
    seconds and its CLI's writer seconds."""
    return {"items": items, "solve_s": rec["seconds"], "cli_write_s": rec["write_seconds"]}


def phase_dopri5(torch, state_dict, euler_rollout_s, smi):
    """One dopri5 rollout (T=100 frames) of the bench model: 32-true fused
    and dense from the same start and noise, then bf16-mixed fused. Returns
    the f32 fused solve's stats."""
    from mdgen_tpu_torch import ops

    start, seqres, mask = _start(torch)
    noise = torch.randn(1, B, T, L, 21, device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(7))
    euler_fps = NUM_FRAMES / euler_rollout_s
    runs = {}
    for name, precision, fused in (("f32 fused", "32-true", True), ("f32 dense", "32-true", False),
                                   ("bf16 fused", "bf16-mixed", True)):
        cfg = bench_config(precision=precision, fused_block=fused, sampling_method="dopri5")
        rt = _runtime(torch, cfg, state_dict)
        solves = []
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        atoms = rt.rollout(start, seqres, mask, 1, noise=noise, stats=solves)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        counts = ops.launch_counts()
        st = solves[0]
        runs[name] = (atoms, st, counts)
        log(f"[dopri5] {name} ({precision}), one rollout of {NUM_FRAMES} frames: "
            f"{st['attempts']} attempts, {st['accepted']} accepted, {st['rejected']} rejected, "
            f"{st['evals']} drift evaluations, t1 {'reached' if st['reached_t1'] else 'NOT reached'}"
            f" (t = {st['t_final']:.6f}); {sec * 1e3:.1f} ms per solve = "
            f"{NUM_FRAMES / sec:.1f} frames/s (Euler, {EULER_STEPS - 1} evaluations, phase 5: "
            f"{euler_rollout_s * 1e3:.1f} ms = {euler_fps:.1f} frames/s); "
            f"{sec * 1e3 / st['evals']:.2f} ms per evaluation; launches {counts} ({smi})")
        if not bool(torch.isfinite(atoms).all()):
            raise AssertionError(f"dopri5 {name}: non-finite atoms")
        if name == "bf16 fused" and not st["reached_t1"]:
            log(f"[dopri5] finding: the bf16-mixed fused solve spent max_steps "
                f"({st['attempts']} attempts) and stopped at t = {st['t_final']:.6f} < 1")
        del rt
    (fused, st, counts), (dense, _, dense_counts) = runs["f32 fused"], runs["f32 dense"]
    err = (fused - dense).abs().max().item()
    want = 5 * st["evals"]
    ok = (st["reached_t1"] and err <= DOPRI5_TOL and all(
        counts[k] == want for k in ("fused_l_sublayer", "fused_t_sublayer", "fused_ffn_sublayer"))
        and not any(dense_counts.values()))
    log(f"[dopri5] f32 fused vs dense, same start and noise: max_abs_err {err:.3e} A, tol "
        f"{DOPRI5_TOL:g} A; dense {runs['f32 dense'][1]['evals']} evaluations; each fused "
        f"kernel {want} launches expected -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"dopri5 f32 fused solve: t1 reached {st['reached_t1']}, "
                             f"err {err} A, launches {counts} (want {want})")
    torch.cuda.empty_cache()
    return st


def phase_quality(torch, smi, tag="quality", train_extra="", eval_protocol=False):
    """The quality chain; with ``eval_protocol``, then the noise-floor
    protocol on its run (returns that phase's launches)."""
    with tempfile.TemporaryDirectory(prefix="mdgen_quality_") as work:
        res = _quality(torch, smi, work, tag, train_extra)
        return _eval_protocol(smi, work, res) if eval_protocol else None


def _quality(torch, smi, work, tag, train_extra):
    """quality_run at a small budget on the card (``train_extra``: more
    flags of its train invocation); checks its outputs."""
    import pickle

    import numpy as np

    from mdgen_tpu_torch import quality_run
    from mdgen_tpu_torch.geometry import constants as rc
    from mdgen_tpu_torch.protein import load_pdb_trajectory, load_trajectory
    from mdgen_tpu_torch.xtc import read_xtc, superpose

    t0 = time.perf_counter()
    res = quality_run.main(["--out", work, "--md_frames", str(QUALITY_MD_FRAMES), "--epochs",
                            str(QUALITY_EPOCHS), "--num_rollouts", str(QUALITY_ROLLOUTS),
                            "--device", "cuda", f"--train_extra={train_extra}"],
                           keep_trajectories=True)
    sec = time.perf_counter() - t0
    pkl = os.path.join(res["samp_dir"], "out.pkl")
    with open(pkl, "rb") as fh:
        out = pickle.load(fh)
    jsds = [v for d in out.values() for v in d["JSD"].values()]
    if sorted(out) != sorted(quality_run.PEPTIDES) or not jsds or \
            not all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in jsds):
        raise AssertionError(f"bad out.pkl: {sorted(out)}, JSDs {jsds}")
    worst, solves = 0.0, []
    for rec in res["samples"]:
        solves += rec["solves"]
        for j, (name, pdb) in enumerate(zip(rec["names"], rec["paths"])):
            traj = rec["traj"][j]
            topo, aatype = load_pdb_trajectory(pdb)
            coords_nm = read_xtc(os.path.splitext(pdb)[0] + ".xtc")[0]
            atoms, aat2 = load_trajectory(pdb)  # raises if the XTC's atoms are not the PDB's
            if topo.shape[0] != 1 or rc.aatype_to_str_sequence(aatype) != name or \
                    not np.array_equal(aatype, aat2) or atoms.shape != traj.shape or \
                    coords_nm.shape[0] != traj.shape[0]:
                raise AssertionError(f"{name}: topology {topo.shape}, XTC {coords_nm.shape}, "
                                     f"read back {atoms.shape}, sampled {traj.shape}")
            T_, L_ = traj.shape[:2]
            mask14 = rc.RESTYPE_ATOM14_MASK[aatype].astype(bool) & (np.abs(traj[0]).sum(-1) > 1e-7)
            aligned = superpose(traj.reshape(T_, L_ * 14, 3), mask14.reshape(-1)).reshape(traj.shape)
            worst = max(worst, float(np.abs(atoms - aligned * mask14[..., None]).max()),
                        float(np.abs(topo[0] - atoms[0]).max()))
    s = res["summary"]
    ok = (worst <= 1e-2 and set(s) == {"per_peptide_mean_torsion_jsd", "mean_torsion_jsd",
                                       "mean_all_jsd"}
          and all(np.isfinite(v) for v in (s["mean_torsion_jsd"], s["mean_all_jsd"])))
    evals = [x["evals"] for x in solves]
    log(f"[{tag}] quality_run {train_extra} on the card ({QUALITY_EPOCHS} steps of the 128 x 3 model, "
        f"{QUALITY_MD_FRAMES} MD frames, {QUALITY_ROLLOUTS} dopri5 rollouts x 8 peptides, --xtc): "
        f"{sec:.1f} s; {res['ms_per_step']:.2f} ms per train step (median); "
        f"{sum(evals) / len(evals):.1f} drift evaluations per solve (min {min(evals)}, max "
        f"{max(evals)}, {sum(not x['reached_t1'] for x in solves)} short of t1); XTC read back vs "
        f"the sampled atoms superposed onto frame 0: max {worst:.3e} A, tol 1e-2 A (1e-3 nm); "
        f"{len(jsds)} JSDs finite in [0, 1]; printed {json.dumps(s)} ({smi}) -> "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{tag} chain: XTC err {worst} A, summary {s}")
    return res


def task_config(**kw):
    """The bench model's widths (5 x 384 x 16, IPA 4 x 32, qk 8, v 8) in a
    task configuration; bf16-mixed and the default sampler, dopri5."""
    from mdgen_tpu_torch.config import MDGenConfig

    base = dict(prepend_ipa=True, abs_pos_emb=True, abs_time_emb=True, crop=L,
                precision="bf16-mixed")
    base.update(kw)
    return MDGenConfig(**base)


def _count_models(path):
    with open(path) as fh:
        text = fh.read()
    return text.count("\nENDMDL") + text.startswith("ENDMDL")


def _fused_vs_dense(torch, cfg, state_dict, batch, noise):
    """One dopri5 solve of ``batch`` from ``noise`` in 32-true, fused and
    dense: {fused: (atoms, solver stats, launch counts)}."""
    from mdgen_tpu_torch import ops

    runs = {}
    for fused in (True, False):
        rt = _runtime(torch, cfg.replace(precision="32-true", fused_block=fused), state_dict)
        st = {}
        ops.reset_launch_counts()
        atoms, _ = rt.inference(batch, noise=noise, stats=st)
        torch.cuda.synchronize()
        runs[fused] = (atoms, st, ops.launch_counts())
        del rt
    return runs


def _check_fused_vs_dense(torch, tag, runs, dense_flash):
    """fused vs dense atoms within DOPRI5_TOL, both solves at t1, kernels 1-3
    at 5 launches per evaluation of the fused solve, and the dense solve's
    frame attention through ``dense_flash`` flash launches per evaluation."""
    (fused, st, counts), (dense, st_d, counts_d) = runs[True], runs[False]
    err = (fused.float() - dense.float()).abs().max().item()
    ok = (bool(torch.isfinite(fused).all()) and err <= DOPRI5_TOL
          and st["reached_t1"] and st_d["reached_t1"]
          and all(counts[k] == 5 * st["evals"] for k in FUSED_KERNELS)
          and counts_d["flash_fwd"] == dense_flash * st_d["evals"]
          and not any(counts_d[k] for k in FUSED_KERNELS))
    log(f"[{tag}] fused vs dense, 32-true dopri5, same inputs and noise: max_abs_err {err:.3e} "
        f"A, tol {DOPRI5_TOL:g} A; {st['evals']} / {st_d['evals']} drift evaluations; launches "
        f"fused {counts}, dense {counts_d} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{tag}: fused and dense solves disagree: {err} A, {st}, {st_d}")
    return err


def phase_tps(torch, smi):
    with tempfile.TemporaryDirectory(prefix="mdgen_tps_") as work:
        return _tps(torch, smi, work)


def _tps(torch, smi, work):
    """TPS through `mdgen_tpu_torch.tps_inference.main(... --fused_block)`:
    the MSM of a synthetic rotamer tetrapeptide, one batch of TPS_PATHS
    paths (T = 100, bf16-mixed, dopri5) of the seeded full-width TPS model;
    then the same endpoints and noise fused and dense in 32-true."""
    import shutil

    import numpy as np

    from mdgen_tpu_torch import ops, tps_inference
    from mdgen_tpu_torch.data import synthetic_rotamer_trajectory
    from mdgen_tpu_torch.geometry import constants as rc
    from mdgen_tpu_torch.runtime import checkpoint

    cfg = task_config(tps_condition=True, num_frames=NUM_FRAMES)
    state_dict = seeded_model(torch, cfg).state_dict()
    md = synthetic_rotamer_trajectory(SEQ, TPS_MD_FRAMES, seed=0)
    np.save(os.path.join(work, f"{SEQ}.npy"), md)
    split = os.path.join(work, "split.csv")
    with open(split, "w") as fh:
        fh.write(f"name,seqres\n{SEQ},{SEQ}\n")
    ckpt = os.path.join(work, "ckpt")
    checkpoint.save_checkpoint(ckpt, cfg, state_dict)
    argv = ["--sim_ckpt", ckpt, "--data_dir", work, "--split", split, "--num_batches", "1",
            "--batch_size", str(TPS_PATHS), "--tica_lag", str(TPS_TICA_LAG), "--msm_lag",
            str(TPS_MSM_LAG), "--fused_block", "--device", "cuda"]
    warm, out = os.path.join(work, "warm"), os.path.join(work, "out")
    tps_inference.main(argv + ["--out_dir", warm])  # warm-up (allocator, caches, the MSM)
    os.makedirs(out)
    shutil.copy(os.path.join(warm, f"{SEQ}_metadata.pkl"), out)
    ops.reset_launch_counts()
    rec = tps_inference.main(argv + ["--out_dir", out])[0]
    counts = ops.launch_counts()

    st = rec["solves"][0]
    want = 5 * st["evals"]
    frames = [_count_models(p) for p in rec["paths"]]
    with open(os.path.join(out, f"{SEQ}_metadata.json")) as fh:
        meta = json.load(fh)
    paths_s, ms_eval = TPS_PATHS / rec["seconds"], rec["seconds"] * 1e3 / st["evals"]
    ok = (frames == [NUM_FRAMES] * TPS_PATHS and len(meta) == TPS_PATHS and st["reached_t1"]
          and all(counts[k] == want for k in FUSED_KERNELS)
          and not any(counts[k] for k in FLASH_KERNELS))
    log(f"[tps] tps_inference --fused_block (5x384x16, bf16-mixed, dopri5): {TPS_PATHS} paths x "
        f"{NUM_FRAMES} frames between states {meta[0]['start_state']} and "
        f"{meta[0]['end_state']} in {rec['seconds']:.3f} s = {paths_s:.2f} paths/s; "
        f"{st['evals']} drift evaluations ({st['attempts']} attempts, {st['rejected']} "
        f"rejected), {ms_eval:.2f} ms per evaluation; PDB frames {frames}; launches {counts}, "
        f"want {want} of each fused kernel ({smi}) -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"TPS path: frames {frames}, solve {st}, launches {counts}")

    atom14 = np.empty((TPS_PATHS, NUM_FRAMES, L, 14, 3), np.float32)
    for j, (si, ei) in enumerate(zip(rec["start_idx"], rec["end_idx"])):
        atom14[j, :] = md[si]
        atom14[j, -1] = md[ei]
    batch = {"atom14": torch.from_numpy(atom14).cuda(),
             "seqres": torch.from_numpy(rc.str_sequence_to_aatype(SEQ)).long().cuda()
             .expand(TPS_PATHS, L),
             "mask": torch.ones(TPS_PATHS, L, device="cuda")}
    noise = torch.randn(TPS_PATHS, NUM_FRAMES, L, cfg.latent_dim, device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(11))
    err = _check_fused_vs_dense(torch, "tps", _fused_vs_dense(torch, cfg, state_dict, batch, noise),
                                0)
    torch.cuda.empty_cache()
    return counts, {"paths_per_s": paths_s, "ms_per_eval": ms_eval, "evals": st["evals"],
                    "fused_vs_dense_A": err}


def phase_upsampling(torch, smi):
    with tempfile.TemporaryDirectory(prefix="mdgen_ups_") as work:
        return _upsampling(torch, smi, work)


def _upsampling(torch, smi, work):
    """Upsampling through `mdgen_tpu_torch.upsampling_inference.main(...
    --fused_block)` at the reference recipe (T = 1000, cond_interval 100,
    batch 1, bf16-mixed, dopri5) of the seeded full-width model: 30 kept
    frames of a 3000-frame synthetic trajectory, 3 windows; then window 1
    fused and dense (its frame attention: flash kernel 4, 1001 keys) from
    the same noise in 32-true. Returns (launch counts, numbers, what the
    profile phase needs)."""
    import numpy as np

    from mdgen_tpu_torch import ops, upsampling_inference
    from mdgen_tpu_torch.data import synthetic_trajectory
    from mdgen_tpu_torch.geometry import constants as rc
    from mdgen_tpu_torch.protein import load_trajectory
    from mdgen_tpu_torch.runtime import checkpoint, tokenize_atom14
    from mdgen_tpu_torch.tasks import build_upsampling_windows, decode_latents, prep_batch

    cfg = task_config(sim_condition=True, cond_interval=UPS_INTERVAL, num_frames=UPS_FRAMES)
    state_dict = seeded_model(torch, cfg).state_dict()
    kept = synthetic_trajectory(SEQ, UPS_MD_FRAMES, seed=0)[::UPS_INTERVAL]
    per_window = UPS_FRAMES // UPS_INTERVAL
    np.save(os.path.join(work, f"{SEQ}_i{UPS_INTERVAL}.npy"), kept)
    np.save(os.path.join(work, f"WARM_i{UPS_INTERVAL}.npy"), kept[:per_window])  # one window
    splits = {}
    for name in (SEQ, "WARM"):
        splits[name] = os.path.join(work, f"{name}.csv")
        with open(splits[name], "w") as fh:
            fh.write(f"name,seqres\n{name},{SEQ}\n")
    ckpt = os.path.join(work, "ckpt")
    checkpoint.save_checkpoint(ckpt, cfg, state_dict)
    argv = ["--ckpt", ckpt, "--data_dir", work, "--suffix", f"_i{UPS_INTERVAL}", "--batch_size",
            "1", "--xtc", "--fused_block", "--device", "cuda"]
    upsampling_inference.main(argv + ["--split", splits["WARM"], "--out_dir",
                                      os.path.join(work, "warm")])  # warm-up
    # the frame kernel's T on this path, seen through its wrapper
    seen_t, kernel_2 = set(), ops.fused_t_sublayer

    def frame_kernel(x, *args, **kw):
        seen_t.add(x.shape[1])
        return kernel_2(x, *args, **kw)

    ops.fused_t_sublayer = frame_kernel  # the model looks it up at each call
    try:
        ops.reset_launch_counts()
        rec = upsampling_inference.main(argv + ["--split", splits[SEQ], "--out_dir",
                                                os.path.join(work, "out")],
                                        keep_trajectories=True)[0]
        counts = ops.launch_counts()
    finally:
        ops.fused_t_sublayer = kernel_2
    evals = [x["evals"] for x in rec["solves"]]
    want = 5 * sum(evals)
    atoms, _ = load_trajectory(rec["path"])  # the frame-0 PDB and its XTC
    fps, ms_eval = rec["frames"] / rec["seconds"], rec["seconds"] * 1e3 / sum(evals)
    ok = (rec["frames"] == UPS_MD_FRAMES and rec["windows"] == 3 and atoms.shape[0] ==
          UPS_MD_FRAMES and bool(np.isfinite(atoms).all()) and seen_t == {UPS_FRAMES}
          and all(x["reached_t1"] for x in rec["solves"])
          and all(counts[k] == want for k in FUSED_KERNELS)
          and not any(counts[k] for k in FLASH_KERNELS))
    log(f"[upsampling] upsampling_inference --fused_block (5x384x16, T={UPS_FRAMES}, "
        f"cond_interval {UPS_INTERVAL}, bf16-mixed, dopri5, --xtc): {rec['frames']} frames "
        f"({rec['windows']} windows) in {rec['seconds']:.3f} s = {fps:.1f} frames/s; drift "
        f"evaluations per window {evals}, {ms_eval:.2f} ms per evaluation; frame kernel at "
        f"T = {sorted(seen_t)}; XTC read back {atoms.shape}; launches {counts}, want {want} of "
        f"each fused kernel; sampled kept frames vs their inputs (seeded random weights, not "
        f"held): backbone max {rec['kept_err'][0]:.3f} A, mean {rec['kept_err'][1]:.3f} A "
        f"({smi}) -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"upsampling path: {rec['frames']} frames, T {seen_t}, launches "
                             f"{counts}, solves {rec['solves']}")

    # the kept frames reach the conditioning at their slots: the windows'
    # conditioning latents, decoded, give back the kept backbones
    aatype = torch.from_numpy(rc.str_sequence_to_aatype(SEQ)[None]).long().cuda()
    tok = tokenize_atom14({"atom14": torch.from_numpy(kept.astype(np.float32)[None]).cuda(),
                           "seqres": aatype, "mask": torch.ones(1, L, device="cuda")})
    windows = build_upsampling_windows({k: v[0].cpu().numpy() for k, v in tok.items()},
                                       UPS_FRAMES, UPS_INTERVAL)
    batch = {k: torch.from_numpy(np.stack([w[k] for w in windows])).cuda() for k in windows[0]}
    batch["seqres"] = batch["seqres"].long()
    prep = prep_batch(cfg, batch)
    lat = prep.model_kwargs["x_cond"].clone()
    tors = lat[..., 7:21].reshape(*lat.shape[:3], 7, 2)  # undefined torsions: angle 0
    tors = torch.where(tors.norm(dim=-1, keepdim=True) < 0.5, torch.tensor([0.0, 1.0]).cuda(), tors)
    lat[..., 7:21] = tors.reshape(*lat.shape[:3], 14)
    back = decode_latents(cfg, lat, prep.rigids, batch["seqres"])[0][:, ::UPS_INTERVAL]
    kept_err = float(np.abs(back.reshape(-1, L, 14, 3)[:, :, :3].cpu().numpy()
                            - kept[:, :, :3]).max())
    cond_slots = prep.model_kwargs["x_cond_mask"][0, :, 0].nonzero().flatten().tolist()
    ok = kept_err <= KEPT_TOL and cond_slots == list(range(0, UPS_FRAMES, UPS_INTERVAL))
    log(f"[upsampling] the kept frames' backbones decoded from the windows' conditioning latents: "
        f"max |diff| {kept_err:.3e} A, tol {KEPT_TOL:g} A; conditioned slots "
        f"{cond_slots[:3]}..{cond_slots[-1]} ({len(cond_slots)}) -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"kept frames: {kept_err} A, slots {cond_slots}")

    window = {k: v[:1] for k, v in batch.items()}
    noise = torch.randn(1, UPS_FRAMES, L, cfg.latent_dim, device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(13))
    err = _check_fused_vs_dense(torch, "upsampling",
                                _fused_vs_dense(torch, cfg, state_dict, window, noise), 5)
    torch.cuda.empty_cache()
    writes = _writes(rec, [(rec["traj"], rc.str_sequence_to_aatype(SEQ), f"{SEQ}.pdb",
                            f"{SEQ}.xtc")])
    return counts, {"frames_per_s": fps, "ms_per_eval": ms_eval, "evals": evals,
                    "fused_vs_dense_A": err, "writes": writes}, (cfg, state_dict, window)


def design_config(**kw):
    return task_config(inpainting=True, design=True, no_aa_emb=True, no_torsion=True,
                       num_frames=NUM_FRAMES, **kw)


def _design_md(work):
    """The synthetic rotamer MD in ``work`` and its split."""
    import numpy as np

    from mdgen_tpu_torch.data import synthetic_rotamer_trajectory

    md = synthetic_rotamer_trajectory(SEQ, DESIGN_MD_FRAMES, seed=0)
    np.save(os.path.join(work, f"{SEQ}.npy"), md)
    split = os.path.join(work, "split.csv")
    with open(split, "w") as fh:
        fh.write(f"name,seqres\n{SEQ},{SEQ}\n")
    return md, split


def _design_batch(torch, md, starts):
    import numpy as np

    from mdgen_tpu_torch.geometry import constants as rc

    n = len(starts)
    return {"atom14": torch.from_numpy(np.stack([md[s:s + NUM_FRAMES] for s in starts])
                                       .astype(np.float32)).cuda(),
            "seqres": torch.from_numpy(rc.str_sequence_to_aatype(SEQ)).long().cuda().expand(n, L),
            "mask": torch.ones(n, L, device="cuda")}


def phase_design(torch, smi):
    with tempfile.TemporaryDirectory(prefix="mdgen_design_") as work:
        return _design(torch, smi, work)


def _design(torch, smi, work):
    """Design through `mdgen_tpu_torch.design_inference.main(... --fused_block)`:
    the MSM of a synthetic rotamer tetrapeptide, one batch of DESIGN_BATCH
    windows (T = 100, bf16-mixed, dopri5) of the seeded full-width design
    model; then the same windows and noise fused and dense in 32-true:
    atoms, simplex channels and designed sequences."""
    import shutil

    from mdgen_tpu_torch import design_inference, ops
    from mdgen_tpu_torch.geometry import constants as rc
    from mdgen_tpu_torch.runtime import checkpoint

    from mdgen_tpu_torch.transport import dirichlet

    cfg = design_config()
    dirichlet._cfactor_table.cache_clear()
    t0 = time.perf_counter()
    dirichlet.DirichletConditionalFlow(K=20, alpha_spacing=0.001, alpha_max=cfg.alpha_max)
    table_s = time.perf_counter() - t0
    log(f"[design] the c-factor table (SciPy betainc over 7001 x 1000 points, on the host): "
        f"{table_s:.2f} s, once per process")
    state_dict = seeded_model(torch, cfg).state_dict()
    md, split = _design_md(work)
    ckpt = os.path.join(work, "ckpt")
    checkpoint.save_checkpoint(ckpt, cfg, state_dict)
    argv = ["--sim_ckpt", ckpt, "--data_dir", work, "--split", split, "--num_batches", "1",
            "--batch_size", str(DESIGN_BATCH), "--tica_lag", str(TPS_TICA_LAG), "--msm_lag",
            str(TPS_MSM_LAG), "--fused_block", "--device", "cuda"]
    warm, out = os.path.join(work, "warm"), os.path.join(work, "out")
    t0 = time.perf_counter()
    design_inference.main(argv + ["--out_dir", warm])  # warm-up; builds the c-factor table, the MSM
    warm_s = time.perf_counter() - t0
    os.makedirs(out)
    shutil.copy(os.path.join(warm, f"{SEQ}_metadata.pkl"), out)
    ops.reset_launch_counts()
    rec = design_inference.main(argv + ["--out_dir", out], keep_trajectories=True)[0]
    counts = ops.launch_counts()

    st = rec["solves"][0]
    want = 5 * st["evals"]
    frames = [_count_models(p) for p in rec["paths"]]
    with open(os.path.join(out, f"{SEQ}_metadata.json")) as fh:
        meta = json.load(fh)
    valid = all(len(m["aa_out"]) == L and set(m["aa_out"]) <= set(rc.restypes) for m in meta)
    samples_s, ms_eval = DESIGN_BATCH / rec["seconds"], rec["seconds"] * 1e3 / st["evals"]
    ok = (frames == [NUM_FRAMES] * DESIGN_BATCH and len(meta) == DESIGN_BATCH and valid
          and st["reached_t1"] and all(counts[k] == want for k in FUSED_KERNELS)
          and not any(counts[k] for k in FLASH_KERNELS))
    log(f"[design] design_inference --fused_block (5x384x16, latent 48, bf16-mixed, dopri5): "
        f"{DESIGN_BATCH} designs x {NUM_FRAMES} frames ({DESIGN_BATCH * NUM_FRAMES * L} tokens) "
        f"from state {meta[0]['start_state']} to {meta[0]['end_state']} in {rec['seconds']:.3f} s "
        f"= {samples_s:.2f} samples/s; {st['evals']} drift evaluations ({st['attempts']} "
        f"attempts, {st['rejected']} rejected), {ms_eval:.2f} ms per evaluation; first call "
        f"(c-factor table, MSM, allocator) {warm_s:.1f} s; PDB frames {set(frames)}; designed "
        f"{sorted(set(m['aa_out'] for m in meta))[:4]}...; launches {counts}, want {want} of "
        f"each fused kernel ({smi}) -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"design path: frames {frames}, solve {st}, launches {counts}")

    # the same windows and noise, fused and dense, 32-true
    from mdgen_tpu_torch.runtime import tokenize_atom14
    from mdgen_tpu_torch.tasks import decode_latents, prep_batch
    from mdgen_tpu_torch.transport.dirichlet import sample_dirichlet

    batch = _design_batch(torch, md, [m["start_idx"] for m in meta])
    g = torch.Generator(device="cuda").manual_seed(17)
    noise = torch.cat([torch.randn(DESIGN_BATCH, NUM_FRAMES, L, cfg.latent_dim - 20, device="cuda",
                                   generator=g),
                       sample_dirichlet(torch.ones(DESIGN_BATCH, L, 20, device="cuda"), g)[:, None]
                       .expand(DESIGN_BATCH, NUM_FRAMES, L, 20)], dim=-1)
    runs = {}
    for fused in (True, False):
        c = cfg.replace(precision="32-true", fused_block=fused)
        rt = _runtime(torch, c, state_dict)
        prep = prep_batch(c, tokenize_atom14(batch))
        solve = {}
        ops.reset_launch_counts()
        with torch.inference_mode():
            samples = rt.sampler.sample_ode(rt.model_inf.forward_inference,
                                            sampling_method=c.sampling_method,
                                            stats=solve)(noise, **prep.model_kwargs)
            atoms, aa = decode_latents(c, samples, prep.rigids, batch["seqres"])
        torch.cuda.synchronize()
        runs[fused] = (atoms, samples[..., -20:], aa, solve, ops.launch_counts())
        del rt
    (fa, fs, faa, fst, fc), (da, ds, daa, dst, dc) = runs[True], runs[False]
    err = (fa - da).abs().max().item()
    serr = (fs - ds).abs().max().item()
    agree = (faa[:, 0] == daa[:, 0]).all(dim=-1).float().mean().item()
    ok = (bool(torch.isfinite(fa).all() and torch.isfinite(fs).all()) and err <= DOPRI5_TOL
          and serr <= SIMPLEX_TOL and fst["reached_t1"] and dst["reached_t1"]
          and all(fc[k] == 5 * fst["evals"] for k in FUSED_KERNELS)
          and not any(dc[k] for k in FUSED_KERNELS + FLASH_KERNELS))
    log(f"[design] fused vs dense, 32-true dopri5, same windows and noise: atoms max_abs_err "
        f"{err:.3e} A, tol {DOPRI5_TOL:g} A; simplex channels max_abs_err {serr:.3e}, tol "
        f"{SIMPLEX_TOL:g}; designed sequences equal in {agree:.3f} of {DESIGN_BATCH} (not held); "
        f"{fst['evals']} / {dst['evals']} drift evaluations; launches fused {fc} -> "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"design: fused and dense solves disagree: {err} A, simplex {serr}, "
                             f"{fst}, {dst}")
    torch.cuda.empty_cache()
    return counts, {"samples_per_s": samples_s, "ms_per_eval": ms_eval, "evals": st["evals"],
                    "fused_vs_dense_A": err, "simplex_err": serr, "sequence_agreement": agree,
                    "table_s": table_s,
                    "writes": _writes(rec, [(rec["traj"][j], rec["aatype"][j], f"{SEQ}_{j}.pdb",
                                             None) for j in range(len(rec["traj"]))])}


def phase_mpnn(torch, smi):
    """One full-width forward of each mpnn mode on DESIGN_BATCH windows
    (T = 100, of which the model keeps the first frame, or the first and
    last), fused and dense in 32-true: the logits [B, 1, L, 20], and kernel 2
    at T = 1 and 2, seen through its wrapper."""
    from mdgen_tpu_torch import ops
    from mdgen_tpu_torch.data import synthetic_trajectory
    from mdgen_tpu_torch.runtime import tokenize_atom14
    from mdgen_tpu_torch.tasks import prep_batch

    md = synthetic_trajectory(SEQ, NUM_FRAMES + DESIGN_BATCH, seed=0)
    batch = _design_batch(torch, md, list(range(DESIGN_BATCH)))
    seen_t, kernel_2 = [], ops.fused_t_sublayer

    def frame_kernel(x, *args, **kw):
        seen_t.append(x.shape[1])
        return kernel_2(x, *args, **kw)

    all_counts = {}
    for mode, flags, frames in (("mpnn", dict(sim_condition=True, mpnn=True), 1),
                                ("dynamic_mpnn", dict(inpainting=True, dynamic_mpnn=True), 2)):
        cfg = task_config(design=True, num_frames=NUM_FRAMES, **flags)
        state_dict = seeded_model(torch, cfg).state_dict()
        outs, counts = {}, {}
        for fused in (True, False):
            c = cfg.replace(precision="32-true", fused_block=fused)
            rt = _runtime(torch, c, state_dict)
            prep = prep_batch(c, tokenize_atom14(batch))
            x = torch.cat([prep.latents, prep.latents.new_zeros(*prep.latents.shape[:3], 20)], -1)
            seen_t.clear()
            ops.fused_t_sublayer = frame_kernel  # the model looks it up at each call
            ops.reset_launch_counts()
            try:
                with torch.inference_mode():
                    outs[fused] = rt.model_inf.forward_inference(
                        x, x.new_ones(DESIGN_BATCH), **prep.model_kwargs)
                torch.cuda.synchronize()
            finally:
                ops.fused_t_sublayer = kernel_2
            counts[fused] = (ops.launch_counts(), sorted(set(seen_t)))
            del rt
        err = (outs[True] - outs[False]).abs().max().item()
        scale = outs[False].abs().max().item()
        (fc, ft), (dc, _) = counts[True], counts[False]
        ok = (tuple(outs[True].shape) == (DESIGN_BATCH, 1, L, 20)
              and bool(torch.isfinite(outs[True]).all()) and scale > 1e-2
              and err <= TOL["f32"] * max(scale, 1.0) and ft == [frames]
              and all(fc[k] == 5 for k in FUSED_KERNELS) and not any(dc.values()))
        log(f"[mpnn] {mode} (5x384x16, latent {cfg.latent_dim}, {DESIGN_BATCH} windows of "
            f"{NUM_FRAMES} frames, t = 1), one forward, 32-true: logits {tuple(outs[True].shape)}, "
            f"fused vs dense max_abs_err {err:.3e} (|logits| max {scale:.3f}), tol "
            f"{TOL['f32']:g} x max(|logits|,1); frame kernel at T = {ft}; launches fused {fc} "
            f"({smi}) -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{mode}: fused and dense logits disagree: {err}, T {ft}, {fc}")
        all_counts[mode] = fc
    return all_counts


def phase_quality_task(torch, smi, task):
    with tempfile.TemporaryDirectory(prefix=f"mdgen_quality_{task}_") as work:
        return _quality_task(torch, smi, task, work)


def _quality_task(torch, smi, task, work):
    """quality_run --task tps|upsampling|design at the small budget of the
    sim quality phase; checks the pickle (design: each peptide's metadata)
    and that every metric is finite (design: every recovery in [0, 1])."""
    import pickle

    import numpy as np

    from mdgen_tpu_torch import quality_run

    t0 = time.perf_counter()
    res = quality_run.main(["--task", task, "--out", work, "--md_frames", str(QUALITY_MD_FRAMES),
                            "--epochs", str(QUALITY_EPOCHS), "--device", "cuda"])
    sec = time.perf_counter() - t0
    if task == "design":
        return _quality_design(res, sec, smi)
    pkl = os.path.join(res["samp_dir"], {"tps": "tps_out.pkl",
                                         "upsampling": "upsampling_out.pkl"}[task])
    with open(pkl, "rb") as fh:
        out = pickle.load(fh)
    if task == "tps":
        # gen_valid_prob is nan where no path is valid (gen_valid_rate 0)
        values = [v for d in out.values() for k, v in d.items()
                  if k != "gen_valid_prob" or d["gen_valid_rate"] > 0]
        summary = [res["summary"]["mean_gen_valid_rate"], res["summary"]["median_gen_JSD"]]
    else:
        values = [c for d in out.values() for sec_ in d.values() for curves in sec_.values()
                  for c in curves.values()]
        values = [float(x) for c in values for x in np.asarray(c, np.float32)]
        summary = [res["summary"]["live_mean_acf_err"] or res["summary"]["sub_nyquist_mean_acf_err"]]
    solves = [x for r in res["samples"] for x in r["solves"]]
    evals = [x["evals"] for x in solves]
    ok = (sorted(out) == sorted(quality_run.PEPTIDES) and values
          and all(np.isfinite(v) for v in values + summary))
    log(f"[quality-{task}] quality_run --task {task} on the card ({QUALITY_EPOCHS} steps of the "
        f"128 x 3 model, {QUALITY_MD_FRAMES} MD frames, --xtc): {sec:.1f} s; "
        f"{res['ms_per_step']:.2f} ms per train step (median); {sum(evals) / len(evals):.1f} drift "
        f"evaluations per solve (min {min(evals)}, max {max(evals)}, {len(solves)} solves, "
        f"{sum(not x['reached_t1'] for x in solves)} short of t1); {len(values)} values in "
        f"{os.path.basename(pkl)} finite; printed {json.dumps(res['summary'])} ({smi}) -> "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"quality chain --task {task}: {sorted(out)}, summary {res['summary']}")


def _quality_design(res, sec, smi):
    from mdgen_tpu_torch import quality_run

    s = res["summary"]
    metas = {}
    for name in quality_run.PEPTIDES:
        with open(os.path.join(res["samp_dir"], f"{name}_metadata.json")) as fh:
            metas[name] = json.load(fh)
    recs = [s[k] for k in ("designed", "cond", "consensus", "mode_pair")] + [
        v for r in s["per_peptide"].values() for v in r.values()]
    solves = [x for r in res["samples"] for x in r["solves"]]
    evals = [x["evals"] for x in solves]
    ok = (sorted(s["per_peptide"]) == sorted(quality_run.PEPTIDES)
          and all(len(m) == 32 for m in metas.values()) and all(0 <= v <= 1 for v in recs))
    log(f"[quality-design] quality_run --task design on the card ({QUALITY_EPOCHS} steps of the "
        f"128 x 3 model, {QUALITY_MD_FRAMES} MD frames, 2 x 16 designs a peptide): {sec:.1f} s; "
        f"{res['ms_per_step']:.2f} ms per train step (median); {sum(evals) / len(evals):.1f} drift "
        f"evaluations per solve (min {min(evals)}, max {max(evals)}, {len(solves)} solves, "
        f"{sum(not x['reached_t1'] for x in solves)} short of t1); {len(recs)} recoveries in "
        f"[0, 1]; printed {json.dumps({k: v for k, v in s.items() if k != 'per_peptide'})} "
        f"({smi}) -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"quality chain --task design: {s}")


def _short(name):
    """A kernel's name without its return type, namespace and template
    arguments (`void mdgen::ffn_up_kernel<...>(...)` -> `ffn_up_kernel`)."""
    base = name.split("<")[0].replace("(anonymous namespace)::", "").split("(")[0].strip()
    return (base.removeprefix("void ").split("::")[-1] or name)[:60]


def phase_profiles(torch, state_dict, unprofiled_s, smi, upsampling):
    """The torch.profiler sessions, after every timed phase: a session
    leaves the process's host work slower for the rest of its life (a
    training step after one reads slower than before it, in the same
    process: `tools/train_step_ab.py --after-profiler`). Returns kernel 2's
    device µs per launch on the upsampling path."""
    _launch_split(torch)
    _profile_rollout(state_dict, unprofiled_s, smi)
    return _profile_upsampling_window(torch, *upsampling, smi)


def _profiled(torch, fn):
    """Runs ``fn`` under torch.profiler: ({kernel name: (device ms,
    launches)}, [(start µs, end µs)] of the device events, host wall s), or
    None if the profiler saw no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not events:
        return None
    per = {}
    for e in events:
        n = _short(e.name)
        ms, count = per.get(n, (0.0, 0))
        per[n] = (ms + e.time_range.elapsed_us() / 1e3, count + 1)
    return per, [(e.time_range.start, e.time_range.end) for e in events], wall


# kernel 2's three launches (`gated_out_proj_kernel` is kernel 1's too)
FRAME_KERNEL_NAMES = ("frame_qkv_kernel", "frame_attn_kernel", "gated_out_proj_kernel")


def _profile_upsampling_window(torch, cfg, state_dict, window, smi):
    """One upsampling window (T = 1000, bf16-mixed, fused, dopri5) under
    torch.profiler, through MDGenRuntime.inference: device ms per kernel
    name, the device's busy share, and kernel 2's device µs per launch."""
    rt = _runtime(torch, cfg.replace(fused_block=True), state_dict)
    gen = torch.Generator(device="cuda").manual_seed(0)
    rt.inference(window, gen)  # warm-up
    torch.cuda.synchronize()
    st = {}
    res = _profiled(torch, lambda: rt.inference(window, gen, stats=st))
    if res is None:
        log("[profile] upsampling window: torch.profiler saw no device activity: not measured")
        return None
    per, spans, wall = res
    busy, span_ms = busy_ms(spans)
    device_ms = sum(ms for ms, _ in per.values())
    evals = st["evals"]
    log(f"[profile] one upsampling window (T={UPS_FRAMES}, {evals} drift evaluations, {smi}): "
        f"device {device_ms:.1f} ms in {len(spans)} launches ({len(spans) / evals:.1f} per "
        f"evaluation); device busy {busy:.1f} ms of the {span_ms:.1f} ms from its first launch to "
        f"its last ({busy / span_ms:.1%}); profiled wall {wall * 1e3:.1f} ms "
        f"({wall * 1e3 / evals:.2f} ms per evaluation)")
    for n, (ms, count) in sorted(per.items(), key=lambda kv: -kv[1][0])[:12]:
        log(f"[profile]   {n}: {ms:.2f} ms, {100 * ms / device_ms:.1f}%, {count} launches "
            f"({count / evals:.2f} per evaluation, {1e3 * ms / count:.2f} us each)")
    frame = {n: 1e3 * per[n][0] / per[n][1] for n in FRAME_KERNEL_NAMES if n in per}
    log(f"[profile] kernel 2 at T={UPS_FRAMES} on the upsampling path, device us per launch: "
        + ", ".join(f"{n} {us:.2f}" for n, us in frame.items())
        + " (gated_out_proj_kernel: kernels 1 and 2 together)")
    return frame


def busy_ms(spans):
    """(ms the device was busy, ms from the first start to the last end)
    of kernel intervals [(start µs, end µs)]: the length of their union."""
    spans = sorted(spans)
    busy, (cur_s, cur_e) = 0.0, spans[0]
    for s0, e0 in spans[1:]:
        if s0 > cur_e:
            busy, cur_s = busy + (cur_e - cur_s), s0
        cur_e = max(cur_e, e0)
    return (busy + cur_e - cur_s) / 1e3, (max(e for _, e in spans) - spans[0][0]) / 1e3


def _profile_rollout(state_dict, unprofiled_s, smi):
    """One rollout of the main path (99 evaluations) under torch.profiler,
    through the runtime that sim_inference drives, with its configuration
    and weights: device ms per kernel name, the device's busy share,
    launches per evaluation, frames/s."""
    import torch

    cfg = bench_config(fused_block=True)
    rt = _runtime(torch, cfg, state_dict)
    start, seqres, mask = _start(torch)
    gen = torch.Generator(device="cuda").manual_seed(0)
    rt.rollout(start, seqres, mask, 1, generator=gen)  # warm-up
    torch.cuda.synchronize()
    res = _profiled(torch, lambda: rt.rollout(start, seqres, mask, 1, generator=gen))
    if res is None:
        log("[profile] torch.profiler saw no device activity: device time not measured")
        return
    per, spans, wall = res
    busy, span_ms = busy_ms(spans)
    device_ms = sum(ms for ms, _ in per.values())
    evals = EULER_STEPS - 1
    log(f"[profile] one main-path rollout ({evals} evaluations, {NUM_FRAMES} frames, {smi}): "
        f"device {device_ms:.1f} ms in {len(spans)} launches ({len(spans) / evals:.1f} per "
        f"evaluation); device busy {busy:.1f} ms of the {span_ms:.1f} ms from its first launch "
        f"to its last ({busy / span_ms:.1%}); profiled wall {wall * 1e3:.1f} ms "
        f"({NUM_FRAMES / wall:.1f} frames/s); unprofiled {unprofiled_s * 1e3:.1f} ms per "
        f"rollout in the main run ({NUM_FRAMES / unprofiled_s:.1f} frames/s, device busy "
        f"about {busy / (unprofiled_s * 1e3):.1%})")
    for n, (ms, count) in sorted(per.items(), key=lambda kv: -kv[1][0])[:12]:
        log(f"[profile]   {n}: {ms:.2f} ms, {100 * ms / device_ms:.1f}%, {count} launches "
            f"({count / evals:.2f} per evaluation, {1e3 * ms / count:.2f} us each)")


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


def _optimizer_launches(steps, tp):
    """The optimizer kernels' launches in ``steps`` train steps: one pass a
    step, and one sum of squares, or two under tp (replicated and sharded
    parameters)."""
    return {"sum_of_squares": steps * (2 if tp > 1 else 1), "fused_adam": steps}


def phase_training(torch, smi):
    with tempfile.TemporaryDirectory(prefix="mdgen_train_") as work:
        return _training(torch, smi, work)


def train_argv(work):
    """Writes the recipe's training data (8 synthetic tetrapeptides of 1100
    frames and their split) into ``work``; returns the argv of
    `mdgen_tpu_torch.train` for TRAIN_EPOCHS steps there (run ``run``)."""
    import numpy as np

    from mdgen_tpu_torch.data import synthetic_trajectory

    for i, s in enumerate(TRAIN_SEQS):
        np.save(os.path.join(work, f"{s}.npy"), synthetic_trajectory(s, 1100, seed=i))
    split = os.path.join(work, "split.csv")
    with open(split, "w") as fh:
        fh.write("name,seqres\n" + "".join(f"{s},{s}\n" for s in TRAIN_SEQS))
    return ["--sim_condition", "--num_frames", str(TRAIN_FRAMES), "--prepend_ipa",
            "--abs_pos_emb", "--abs_time_emb", "--crop", str(L), "--sampling_method", "euler",
            "--inference_steps", "2", "--ema", "--epochs", str(TRAIN_EPOCHS), "--val_batches",
            "1", "--val_epoch_freq", str(TRAIN_EPOCHS), "--ckpt_freq", str(TRAIN_EPOCHS),
            "--train_split", split, "--val_split", split, "--data_dir", work,
            "--workdir", work, "--run_name", "run", "--device", "cuda", "--dp_size", "1"]


def _training(torch, smi, work):
    import numpy as np

    from mdgen_tpu_torch import ops, sim_inference, train
    from mdgen_tpu_torch.runtime import checkpoint

    argv = train_argv(work)
    split = os.path.join(work, "split.csv")
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
            "fused_t_sublayer": 0, "fused_ffn_sublayer": 0, "sum_of_squares": TRAIN_EPOCHS,
            "fused_adam": TRAIN_EPOCHS}
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
    if models != TRAIN_FRAMES or not np.isfinite(coords).all() \
            or {k: v for k, v in sample_counts.items() if v} != dict.fromkeys(FUSED_KERNELS, 5):
        raise AssertionError(f"bad rollout from the trained run: {models} models, {sample_counts}")
    return counts, ms


# -- the last model options, the SDE and likelihood samplers, the ATLAS recipe --

# the SDE phase: Euler-Maruyama / stochastic Heun on a 100-point grid, SBDM
# diffusion from t0 = 1e-3 (it is infinite at t = 0), the Mean last step;
# fused vs dense atoms held to phase 4's 1e-3 A: f32 rounding carried
# through a fixed-grid solve (4.2e-6 A on the H100, PERF.md), the noise the
# same on both sides
SDE_STEPS, SDE_TOL = 100, 1e-3
# the likelihood phase: euler over LIK_STEPS grid points; the JVP divergence
# against the VJP (autograd) one at one point, relative: the same products
# summed in another order
LIK_STEPS, LIK_TOL = 4, 1e-4
# the ATLAS recipe (scripts/tpu_perf.py:200-202): crop 256, T = 250, B = 1,
# grad_checkpointing, bf16-mixed; with dropout 0.1; the sequences of 7lao_A
# (271 residues: cropped) and 6sms_A (724: the residue axis past 512 keys)
# from splits/atlas_test.csv, with synthetic coordinates
ATLAS_CROP, ATLAS_FRAMES, ATLAS_STEPS, ATLAS_DROPOUT = 256, 250, 6, 0.1
ATLAS_TRAIN, ATLAS_LONG = "7lao_A", "6sms_A"
# three 4AA recipe steps (T = 1000, B = 8) with and without grad_checkpointing
REMAT_STEPS = 3


def phase_hyena(torch, smi):
    """--hyena --fused_block: one 4AA rollout at the bench shape (B = 1,
    T = 100, 100 Euler steps, bf16-mixed) of a seeded full-width Hyena model:
    frames/s, and kernels 1 and 3 five times an evaluation while the frame
    sublayer is the Hyena operator (kernel 2 never); then fused vs dense in
    32-true (phase_model_parity). Returns the rollout's launch counts."""
    from mdgen_tpu_torch import ops

    cfg = bench_config(hyena=True, fused_block=True)
    state_dict = seeded_model(torch, cfg).state_dict()
    start, seqres, mask = _start(torch)
    noise = torch.randn(1, B, T, L, 21, device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(11))
    rt = _runtime(torch, cfg, state_dict)
    rt.rollout(start, seqres, mask, 1, noise=noise)  # warm-up: cuFFT plans, allocator
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    atoms = rt.rollout(start, seqres, mask, 1, noise=noise)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    counts = ops.launch_counts()
    want = cfg.num_layers * (EULER_STEPS - 1)
    ok = (bool(torch.isfinite(atoms).all()) and counts["fused_l_sublayer"] == want
          and counts["fused_ffn_sublayer"] == want and counts["fused_t_sublayer"] == 0
          and not any(counts[k] for k in FLASH_KERNELS))
    log(f"[hyena] --hyena --fused_block rollout (5x384x16, T={NUM_FRAMES}, {EULER_STEPS} Euler "
        f"steps, bf16-mixed): {sec * 1e3:.1f} ms = {NUM_FRAMES / sec:.1f} frames/s, "
        f"{sec * 1e3 / (EULER_STEPS - 1):.2f} ms an evaluation ({smi}); launches {counts} (want "
        f"{want} of kernels 1 and 3, none of kernel 2) -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"hyena rollout: launches {counts}")
    del rt
    phase_model_parity(torch, state_dict, cfg, "hyena", {"32-true": TOL["f32"]}, rollouts=1,
                       frame_kernel=False)
    return counts


def phase_sde(torch, smi, state_dict):
    """Sampler.sample_sde, Euler-Maruyama and stochastic Heun (SDE_STEPS grid
    points, SBDM from t0 = 1e-3, Mean last step), on the bench sim model at
    T = 100 in 32-true, fused and dense from the same start latents and
    per-step noise: decoded atoms within SDE_TOL, 5 launches of each fused
    kernel per model evaluation (one a drift, one for the last step), none
    dense; ms per solve. Returns the fused solves' launch counts, summed."""
    from mdgen_tpu_torch import ops
    from mdgen_tpu_torch.runtime import tokenize
    from mdgen_tpu_torch.tasks import decode_latents, prep_batch
    from mdgen_tpu_torch.transport import Sampler, Transport, TransportConfig

    start, seqres, mask = _start(torch)
    sampler = Sampler(Transport(TransportConfig(sample_eps=1e-3)))
    g = torch.Generator(device="cuda")
    x0 = torch.randn(B, T, L, 21, device="cuda", generator=g.manual_seed(12))
    noise = torch.randn(SDE_STEPS - 1, B, T, L, 21, device="cuda", generator=g.manual_seed(13))
    total = dict.fromkeys(KERNELS, 0)
    for method in ("Euler", "Heun"):
        runs = {}
        for fused in (True, False):
            cfg = bench_config(precision="32-true", fused_block=fused)
            rt = _runtime(torch, cfg, state_dict)
            prep = prep_batch(cfg, tokenize(cfg, {"atom14": start[:, None].expand(B, T, L, 14, 3),
                                                  "seqres": seqres, "mask": mask}))
            stats = {}
            fn = sampler.sample_sde(rt.model_inf.forward_inference, sampling_method=method,
                                    num_steps=SDE_STEPS, stats=stats)
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            with torch.inference_mode():
                xs = fn(x0, noise=noise, **prep.model_kwargs)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            counts = ops.launch_counts()
            atoms, _ = decode_latents(cfg, xs, prep.rigids, seqres)
            runs[fused] = (atoms, xs, stats, counts, sec)
            del rt
        (atoms, xs, stats, counts, sec), (atoms_d, xs_d, _, counts_d, sec_d) = runs[True], runs[False]
        err = (atoms - atoms_d).abs().max().item()
        lat = ((xs - xs_d).abs().max() / xs_d.abs().max().clamp_min(1.0)).item()
        evals = stats["evals"] + 1
        ok = (bool(torch.isfinite(atoms).all()) and err <= SDE_TOL
              and all(counts[k] == cfg.num_layers * evals for k in FUSED_KERNELS)
              and not any(counts_d.values()))
        log(f"[sde] sample_sde {method} (SBDM, {SDE_STEPS} grid points, Mean last step; the "
            f"bench sim model, T={NUM_FRAMES}, 32-true): {evals} model evaluations; fused "
            f"{sec * 1e3:.1f} ms, dense {sec_d * 1e3:.1f} ms a solve ({smi}); fused vs dense, same "
            f"start and noise: atoms max_abs_err {err:.3e} A, tol {SDE_TOL:g} A; latents "
            f"{lat:.3e} of max(|x|, 1); launches fused {counts} -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"sde {method}: {err} A, launches {counts}, dense {counts_d}")
        for k in KERNELS:
            total[k] += counts[k]
    return total


def phase_likelihood(torch, smi, state_dict):
    """sample_ode_likelihood (euler, LIK_STEPS grid points) of the bench sim
    model in 32-true on the dense route (fused_block off; 101 frame keys take
    dense attention): log p of a tokenized window's latents, finite, no
    kernel launched, and the same twice for one eps; the JVP divergence
    eps.(J eps) at one point against the VJP one (autograd), LIK_TOL
    relative. Then forward-mode AD through the kernels: the fused model under
    the same likelihood raises, as does each kernel wrapper given a dual CUDA
    tensor. Returns the dense run's launch counts."""
    from torch.autograd import forward_ad

    from mdgen_tpu_torch import ops
    from mdgen_tpu_torch.runtime import tokenize
    from mdgen_tpu_torch.tasks import prep_batch
    from mdgen_tpu_torch.transport import Sampler, Transport, TransportConfig

    start, seqres, mask = _start(torch)
    cfg = bench_config(precision="32-true")
    rt = _runtime(torch, cfg, state_dict)
    prep = prep_batch(cfg, tokenize(cfg, {"atom14": start[:, None].expand(B, T, L, 14, 3),
                                          "seqres": seqres, "mask": mask}))
    kw = prep.model_kwargs
    x = prep.latents
    eps = torch.randint(0, 2, x.shape, device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(14)).float() * 2 - 1
    sampler = Sampler(Transport(TransportConfig()))
    stats = {}
    lik = sampler.sample_ode_likelihood(rt.model_inf.forward_inference, sampling_method="euler",
                                        num_steps=LIK_STEPS, stats=stats)
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        logp, z = lik(x, eps=eps, **kw)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    counts = ops.launch_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        logp2, _ = lik(x, eps=eps, **kw)
    torch.cuda.synchronize()
    sec2 = time.perf_counter() - t0
    # the divergence at one point: forward mode (JVP) against reverse (VJP)
    tv = torch.full((B,), 0.5, device="cuda")
    f = lambda xx: rt.model_inf.forward_inference(xx, tv, **kw)  # noqa: E731
    with torch.no_grad():
        _, jvp = torch.func.jvp(f, (x,), (eps,))
    xg = x.detach().clone().requires_grad_(True)
    (vjp,) = torch.autograd.grad((f(xg) * eps).sum(), xg)
    div_f, div_r = (jvp * eps).sum().item(), (vjp * eps).sum().item()
    div_rel = abs(div_f - div_r) / max(abs(div_r), 1e-12)
    refused = []
    fused = _runtime(torch, cfg.replace(fused_block=True), state_dict)
    try:
        with torch.no_grad():
            sampler.sample_ode_likelihood(fused.model_inf.forward_inference,
                                          sampling_method="euler", num_steps=2)(x, eps=eps, **kw)
    except RuntimeError as e:
        refused.append("no forward-mode derivative" in str(e))
    h = torch.randn(1, 2, 3, 8, device="cuda")
    m = torch.zeros(1, 1, 8, device="cuda")
    q, bias = torch.randn(2, 5, 8, device="cuda"), torch.zeros(2, 5, device="cuda")
    w, ow = torch.randn(24, 8, device="cuda"), torch.randn(8, 8, device="cuda")
    z8 = torch.zeros(8, device="cuda")
    with forward_ad.dual_level():
        dh = forward_ad.make_dual(h, torch.ones_like(h))
        dq = forward_ad.make_dual(q, torch.ones_like(q))
        calls = [
            lambda: ops.fused_l_sublayer(dh, m, m, m, torch.ones(1, 3, device="cuda"), w,
                                         torch.zeros(24, device="cuda"), z8, z8, ow, z8,
                                         num_heads=2, compute_dtype=torch.float32),
            lambda: ops.fused_t_sublayer(dh, m, m, m, torch.ones(1, 3, device="cuda"), w,
                                         torch.zeros(24, device="cuda"), z8, z8, ow, z8,
                                         num_heads=2, compute_dtype=torch.float32),
            lambda: ops.fused_ffn_sublayer(dh, m, m, m, torch.randn(32, 8, device="cuda"),
                                           torch.zeros(32, device="cuda"),
                                           torch.randn(8, 32, device="cuda"), z8,
                                           compute_dtype=torch.float32),
            lambda: ops.flash_fwd(dq, q, q, bias),
            lambda: ops.flash_fwd_lse(dq, q, q, bias),
            lambda: ops.flash_bwd_dq(dq, q, q, bias, q, bias, bias),
            lambda: ops.flash_bwd_dkv(dq, q, q, bias, q, bias, bias),
        ]
        for call in calls:
            try:
                call()
                refused.append(False)
            except RuntimeError as e:
                refused.append("no forward-mode derivative" in str(e))
    torch.cuda.synchronize()
    ok = (bool(torch.isfinite(logp).all()) and torch.equal(logp, logp2)
          and not any(counts.values()) and stats["evals"] == LIK_STEPS - 1
          and div_rel <= LIK_TOL and all(refused) and len(refused) == 8)
    log(f"[likelihood] sample_ode_likelihood euler ({LIK_STEPS} grid points; the bench sim "
        f"model, T={NUM_FRAMES}, 32-true, dense route): log p {logp.tolist()} (|z| max "
        f"{z.abs().max().item():.3f}), {sec * 1e3:.1f} ms the first solve, {sec2 * 1e3:.1f} ms "
        f"the second ({stats['evals']} JVP evaluations each; {smi}); launches {counts}; "
        f"divergence at t = 0.5: JVP {div_f:.6e}, VJP {div_r:.6e}, "
        f"rel {div_rel:.2e}, tol {LIK_TOL:g}; the fused model and the 7 kernel wrappers given a "
        f"tangent on the card: {sum(refused)} of {len(refused)} refused -> "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"likelihood: {logp}, {counts}, div rel {div_rel}, refused {refused}")
    return counts


def phase_atlas(torch, smi):
    with tempfile.TemporaryDirectory(prefix="mdgen_atlas_") as work:
        return _atlas(torch, smi, work)


def _atlas_seqs():
    import csv

    with open(os.path.join(HERE, "splits", "atlas_test.csv"), newline="") as fh:
        return {r["name"]: r["seqres"] for r in csv.DictReader(fh)}


def _atlas(torch, smi, work):
    """The ATLAS recipe: (1) `mdgen_tpu_torch.train` at crop 256, T = 250,
    B = 1, bf16-mixed, grad_checkpointing and dropout 0.1 on the 271-residue
    sequence of 7lao_A (three synthetic replicas): ATLAS_STEPS finite steps,
    ms a step, peak device memory, no kernel (257 and 251 keys: dense; and
    dropout forces dense); (2) one Euler solve (2 evaluations) of an ATLAS
    item (crop + 1 wide: the runtime drops the context column) with the
    trained weights; (3) the residue-axis attention at 6sms_A's 724
    residues, T = 250, through kernel 4 against dense (a masked residue);
    (4) REMAT_STEPS 4AA recipe steps (T = 1000, B = 8) with
    grad_checkpointing against the same steps without. Returns {"train":
    counts, "record": the train run's record, "residue": counts, "remat": counts}."""
    import numpy as np

    from mdgen_tpu_torch import ops, train
    from mdgen_tpu_torch.data import MDGenDataset, synthetic_trajectory
    from mdgen_tpu_torch.runtime import MDGenRuntime, batch_to_device, checkpoint

    seqs = _atlas_seqs()
    seq = seqs[ATLAS_TRAIN]
    for r in (1, 2, 3):
        np.save(os.path.join(work, f"{ATLAS_TRAIN}_R{r}.npy"),
                synthetic_trajectory(seq, ATLAS_FRAMES + 10, seed=r))
    split = os.path.join(work, "split.csv")
    with open(split, "w") as fh:
        fh.write(f"name,seqres\n{ATLAS_TRAIN},{seq}\n")
    argv = ["--sim_condition", "--prepend_ipa", "--abs_pos_emb", "--abs_time_emb", "--atlas",
            "--crop", str(ATLAS_CROP), "--num_frames", str(ATLAS_FRAMES), "--batch_size", "1",
            "--precision", "bf16-mixed", "--grad_checkpointing", "--dropout", str(ATLAS_DROPOUT),
            "--sampling_method", "euler", "--inference_steps", "3", "--epochs", str(ATLAS_STEPS),
            "--no_validate", "--ckpt_freq", str(10 * ATLAS_STEPS), "--train_split", split,
            "--val_split", split, "--data_dir", work, "--workdir", work, "--run_name", "atlas",
            "--device", "cuda", "--dp_size", "1"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    marks = [time.perf_counter()]
    rec = train.main(argv)
    counts = ops.launch_counts()
    marks.append(time.perf_counter())
    peak = torch.cuda.max_memory_allocated() / 2**30
    steps = len(rec["losses"])
    ms = (rec["step_end"][-1] - rec["step_end"][1]) / (steps - 2) * 1e3
    n_params = sum(v.numel() for v in torch.load(
        os.path.join(rec["model_dir"], f"step_{ATLAS_STEPS}", "model.pt"),
        weights_only=True)["model"].values())
    ok = (steps == ATLAS_STEPS and np.isfinite(rec["losses"]).all()
          and not any(counts[k] for k in FLASH_KERNELS + FUSED_KERNELS)
          and counts["sum_of_squares"] == counts["fused_adam"] == steps)
    log(f"[atlas] python -m mdgen_tpu_torch.train --atlas (5x384x16, {n_params:,} parameters; "
        f"{ATLAS_TRAIN}, {len(seq)} residues cropped to {ATLAS_CROP}, T={ATLAS_FRAMES}, B=1, "
        f"bf16-mixed, grad_checkpointing, dropout {ATLAS_DROPOUT}): {steps} steps, loss "
        f"{rec['losses'][0]:.4f} -> {rec['losses'][-1]:.4f}; {ms:.1f} ms a step over steps "
        f"2-{steps}; peak device memory {peak:.2f} GiB ({smi}); launches {counts} -> "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"atlas training: {rec['losses']}, {counts}")

    cfg = checkpoint.load_config(rec["model_dir"])
    model, _ = checkpoint.load_model(rec["model_dir"], cfg, "cuda")
    rt = MDGenRuntime(cfg, model)
    item = MDGenDataset(cfg, split, work, seed=0)[0]
    batch = batch_to_device({k: item[k][None] for k in ("atom14", "seqres", "mask")}, "cuda")
    stats = {}
    rt.inference(batch, generator=torch.Generator(device="cuda").manual_seed(0))  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    atoms, _ = rt.inference(batch, generator=torch.Generator(device="cuda").manual_seed(0),
                            stats=stats)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    ok = (tuple(atoms.shape) == (1, ATLAS_FRAMES, ATLAS_CROP, 14, 3)
          and bool(torch.isfinite(atoms).all()))
    log(f"[atlas] Euler solve of an ATLAS item ({item['atom14'].shape[1]} columns: the context "
        f"column dropped), {stats['evals']} evaluations, bf16-mixed: {sec * 1e3:.1f} ms, "
        f"{sec * 1e3 / stats['evals']:.1f} ms an evaluation ({smi}); atoms "
        f"{tuple(atoms.shape)} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"atlas sampling: {tuple(atoms.shape)}")
    del model, rt, atoms
    torch.cuda.empty_cache()
    marks.append(time.perf_counter())
    out = {"train": counts, "record": rec,
           "residue": _atlas_residue_attention(torch, smi, len(seqs[ATLAS_LONG]))}
    marks.append(time.perf_counter())
    out["remat"] = _remat_4aa(torch, smi)
    marks.append(time.perf_counter())
    parts = [b - a for a, b in zip(marks, marks[1:])]
    log(f"[atlas] seconds: train.main {parts[0]:.1f} (its steps and checkpoint), sampling "
        f"{parts[1]:.1f}, residue attention {parts[2]:.1f}, checkpointed 4AA {parts[3]:.1f}")
    return out


def _atlas_residue_attention(torch, smi, n_res):
    """RoPEAttention (384, 16 heads, impl auto) over the residue axis of
    [1, ATLAS_FRAMES, n_res, 384] activations with the last residue masked:
    n_res + 1 > 512 keys take kernel 4 on [ATLAS_FRAMES * 16, n_res, 24]
    rows; against impl dense on the same module, 32-true."""
    from mdgen_tpu_torch import ops
    from mdgen_tpu_torch.models.attention import RoPEAttention

    g = torch.Generator(device="cuda").manual_seed(15)
    attn = RoPEAttention(C, H, impl="auto")
    attn.reset_parameters(torch.Generator().manual_seed(15))
    attn.cuda()
    x = torch.randn(1, ATLAS_FRAMES, n_res, C, device="cuda", generator=g)
    mask = torch.ones(1, ATLAS_FRAMES, n_res, device="cuda")
    mask[:, :, -1] = 0.0
    with torch.inference_mode():
        ops.reset_launch_counts()
        out = attn(x, mask, axis=2)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        ms = _time_ms(torch, lambda: attn(x, mask, axis=2), iters=5)
        attn.impl = "dense"
        ref = attn(x, mask, axis=2)
        ms_d = _time_ms(torch, lambda: attn(x, mask, axis=2), iters=3)
    err = (out - ref).abs().max().item()
    scale = ref.abs().max().item()
    ok = (counts["flash_fwd"] == 1 and err <= FLASH_TOL["f32"]["abs"] * max(scale, 1.0)
          and bool(torch.isfinite(out).all()))
    log(f"[atlas] residue-axis attention at {ATLAS_LONG}'s {n_res} residues (T={ATLAS_FRAMES}, "
        f"a masked residue, 32-true): flash (kernel 4, {ATLAS_FRAMES * H} rows of {n_res} x "
        f"{n_res + 1} keys) {ms:.2f} ms vs dense {ms_d:.2f} ms a call ({smi}); max_abs_err "
        f"{err:.3e} (|out| max {scale:.3f}), tol {FLASH_TOL['f32']['abs']:g} x max(|out|,1); "
        f"launches {counts} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"atlas residue attention: {err}, {counts}")
    del out, ref
    torch.cuda.empty_cache()
    return counts


def _remat_4aa(torch, smi):
    """REMAT_STEPS train steps of the 4AA recipe (5x384x16, B = 8, T = 1000,
    32-true, flash on the frame axis) from seeded weights with and without
    grad_checkpointing, the same batch, t and x0 each step: losses 1e-5 and
    grad norms 1e-4 relative, the final parameters' largest difference
    printed; then one more gradient each, every parameter's within 1e-3 of
    its norm (phase 9's bounds: the flash kernels' sums in another order).
    Kernel 5 runs again in each layer's recompute: 10 launches a step
    against 5; kernels 6 and 7 five a step in both. Returns the checkpointed
    run's launch counts."""
    import numpy as np

    from mdgen_tpu_torch import ops
    from mdgen_tpu_torch.data import synthetic_trajectory
    from mdgen_tpu_torch.geometry import constants as rc
    from mdgen_tpu_torch.runtime import TrainRuntime, batch_to_device

    raw = {"atom14": np.stack([synthetic_trajectory(s, TRAIN_FRAMES, seed=i)
                               for i, s in enumerate(TRAIN_SEQS)]).astype(np.float32),
           "seqres": np.stack([rc.str_sequence_to_aatype(s) for s in TRAIN_SEQS]),
           "mask": np.ones((B_TRAIN, L), np.float32)}
    batch = batch_to_device(raw, "cuda")
    g = torch.Generator(device="cuda").manual_seed(16)
    draws = [(torch.rand(B_TRAIN, device="cuda", generator=g),
              torch.randn(B_TRAIN, TRAIN_FRAMES, L, 21, device="cuda", generator=g))
             for _ in range(REMAT_STEPS + 1)]
    state_dict = seeded_model(torch, train_config()).state_dict()
    runs = {}
    for remat in (False, True):
        rt = TrainRuntime(train_config(grad_checkpointing=remat), "cuda")
        state = rt.init(state_dict=state_dict)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        metrics = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t, x0 in draws[:REMAT_STEPS]:
            state, m = rt.train_step(state, batch, t=t, x0=x0)
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        sec = time.perf_counter() - t0
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        _, grads, _ = rt._grads(state.model, batch, t=draws[-1][0], x0=draws[-1][1])
        params = [p.detach().clone() for p in state.model.parameters()]
        runs[remat] = (metrics, counts, peak, sec, grads, params)
        del rt, state
    (m0, c0, p0, s0, g0, w0), (m1, c1, p1, s1, g1, w1) = runs[False], runs[True]
    loss_rel = max(abs(a[0] - b[0]) / abs(a[0]) for a, b in zip(m0, m1))
    norm_rel = max(abs(a[1] - b[1]) / a[1] for a, b in zip(m0, m1))
    grad_rel = max(((a - b).norm() / (a.norm() if a.norm() > 0 else 1.0)).item()
                   for a, b in zip(g0, g1))
    dw = max((a - b).abs().max().item() for a, b in zip(w0, w1))
    n = REMAT_STEPS * train_config().num_layers  # one frame attention a layer and a step
    want0 = {"flash_fwd_lse": n, "flash_bwd_dq": n, "flash_bwd_dkv": n}
    want1 = {"flash_fwd_lse": 2 * n, "flash_bwd_dq": n, "flash_bwd_dkv": n}
    ok = (loss_rel <= 1e-5 and norm_rel <= 1e-4 and grad_rel <= 1e-3
          and all(c0[k] == v for k, v in want0.items())
          and all(c1[k] == v for k, v in want1.items())
          and not any(c0[k] + c1[k] for k in FUSED_KERNELS) and c0["flash_fwd"] == c1["flash_fwd"] == 0)
    log(f"[atlas] 4AA recipe (B={B_TRAIN}, T={TRAIN_FRAMES}, 32-true) {REMAT_STEPS} steps with "
        f"grad_checkpointing vs without, the same draws: losses {[round(a[0], 6) for a in m1]} vs "
        f"{[round(a[0], 6) for a in m0]} (rel {loss_rel:.2e}, tol 1e-5); grad norms rel "
        f"{norm_rel:.2e} (tol 1e-4); a 4th gradient, worst parameter rel {grad_rel:.2e} (tol "
        f"1e-3); final parameters max |diff| {dw:.3e}; {s1 * 1e3 / REMAT_STEPS:.1f} vs "
        f"{s0 * 1e3 / REMAT_STEPS:.1f} "
        f"ms a step, peak device memory {p1:.2f} vs {p0:.2f} GiB ({smi}); launches {c1} vs {c0} "
        f"-> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"grad_checkpointing: {loss_rel}, {norm_rel}, {grad_rel}, {c1}, {c0}")
    torch.cuda.empty_cache()
    return c1


def phase_options(torch, smi):
    """interleave_ipa (an IPA in each trunk layer) and no_frames (the raw
    atom37 latent, no IPA tower) at full width, seeded: fused vs dense in
    32-true (phase_model_parity). Returns the fused rollouts' counts, summed."""
    total = dict.fromkeys(KERNELS, 0)
    for tag, kw in (("interleave_ipa", dict(interleave_ipa=True)),
                    ("no_frames", dict(no_frames=True, prepend_ipa=False))):
        cfg = bench_config(**kw)
        counts = phase_model_parity(torch, seeded_model(torch, cfg).state_dict(), cfg,
                                    f"options: {tag}", {"32-true": TOL["f32"]}, rollouts=1)
        for k in KERNELS:
            total[k] += counts[k]
    return total


# -- data-parallel training, reference checkpoints, the noise-floor protocol --

# the [dp] phase: the 4AA recipe (T = 1000, global batch B_TRAIN, 32-true)
# for DP_STEPS steps as one rank and as two gloo ranks sharing the card;
# per-step losses and grad norms held within DP_TOL relative: the same sums
# over batches of 4 and 8 rows (the CPU test holds 1e-6 on the first step)
DP_STEPS, DP_TOL = 3, 1e-4
# `--dp_ranks N`: steps of each run (ms a step over steps 2..)
DP_SCALING_STEPS = 5
# the [port-ckpt] phase: the ported model's forward against the seeded one's
# (the same f32 weights through the same code: 0 is expected)
PORT_CKPT_TOL = 1e-6
# the [eval-protocol] phase on the [quality] run: eval frames and rollouts
EVAL_FRAMES, EVAL_ROLLOUTS = 1000, 2


def _run_clis(argvs, timeout=600):
    """Run ``python -m ...`` commands side by side from the checkout; a
    failure kills the others and raises with its output. Returns each
    command's stdout and its seconds."""
    env = dict(os.environ, PYTHONPATH=HERE)
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, *a], cwd=HERE, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for a in argvs]
    outs = []
    try:
        for p, a in zip(procs, argvs):
            out, _ = p.communicate(timeout=timeout)
            outs.append(out)
            if p.returncode != 0:
                raise AssertionError(f"{' '.join(a[:2])} exited {p.returncode}:\n{out[-4000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs, time.perf_counter() - t0


def _recipe_argv(work, steps):
    """`python -m mdgen_tpu_torch.train` at the 4AA recipe on TRAIN_SEQS
    trajectories of exactly TRAIN_FRAMES frames (written to ``work`` once),
    so every run reads the same rows without a window draw."""
    import numpy as np

    from mdgen_tpu_torch.data import synthetic_trajectory

    split = os.path.join(work, "split.csv")
    if not os.path.exists(split):
        for i, s in enumerate(TRAIN_SEQS):
            np.save(os.path.join(work, f"{s}.npy"), synthetic_trajectory(s, TRAIN_FRAMES, seed=i))
        with open(split, "w") as fh:
            fh.write("name,seqres\n" + "".join(f"{s},{s}\n" for s in TRAIN_SEQS))
    return ["-m", "mdgen_tpu_torch.train", "--sim_condition", "--num_frames", str(TRAIN_FRAMES),
            "--prepend_ipa", "--abs_pos_emb", "--abs_time_emb", "--crop", str(L), "--ema",
            "--epochs", str(steps), "--val_batches", "1", "--val_epoch_freq", str(steps),
            "--ckpt_freq", "1000", "--train_split", split, "--val_split", split, "--data_dir",
            work, "--workdir", work, "--device", "cuda"]


def _records(work, name, n):
    out = []
    for r in range(n):
        with open(os.path.join(work, f"{name}.{r}.json")) as fh:
            out.append(json.load(fh))
    return out


def _ms_a_step(rec):  # steps 2..: the first pays the warm-up
    return (rec["step_end"][-1] - rec["step_end"][0]) / (len(rec["step_end"]) - 1) * 1e3


def _rel_worst(runs, one, keys=("losses", "grad_norms"), val=True):
    """The largest relative difference of each run's per-step ``keys`` (and
    last validation loss) from ``one``'s; raises on a wrong length or a
    non-finite value."""
    import numpy as np

    worst = 0.0
    for rec in runs:
        for key in keys:
            a, b = np.asarray(rec[key]), np.asarray(one[key])
            if a.shape != b.shape or not np.isfinite(a).all():
                raise AssertionError(f"{key}: {a} vs {b}")
            worst = max(worst, float(np.abs(a / b - 1).max()))
        if val:
            worst = max(worst, abs(rec["val"][-1]["val_loss"] / one["val"][-1]["val_loss"] - 1))
    return worst


def phase_dp(torch, smi, work, world=2, backend="gloo", steps=DP_STEPS):
    return _dp(torch, smi, work, world, backend, steps)


def _dp(torch, smi, work, world, backend, steps):
    """The 4AA recipe through `python -m mdgen_tpu_torch.train` for ``steps``
    steps: one rank with the global batch, then ``world`` ranks with a share
    of it each. Under gloo the ranks share the one card: ``world`` processes,
    joined by the multi-host flags (--num_processes, --process_id,
    --coordinator_address). Under NCCL one command starts them, one card a
    rank (--dp_size). Returns the launches of each run's ranks and the
    one-rank run's record."""
    from mdgen_tpu_torch.parallel import free_port

    base = _recipe_argv(work, steps)

    def run(name, n):
        flags = [*base, "--run_name", name, "--record", os.path.join(work, f"{name}.{{rank}}.json"),
                 "--dp_size", str(n)]
        if n > 1 and backend == "gloo":
            addr = f"127.0.0.1:{free_port()}"
            argvs = [[*flags, "--coordinator_address", addr, "--num_processes", str(n),
                      "--process_id", str(r), "--dist_backend", "gloo"] for r in range(n)]
        else:
            argvs = [flags]
        _, sec = _run_clis(argvs)
        return _records(work, name, n), sec

    (one,), one_s = run("one", 1)
    many, many_s = run("many", world)
    ms = _ms_a_step
    if len(one["losses"]) != steps:
        raise AssertionError(f"[dp] one rank: {one['losses']}")
    worst = _rel_worst(many, one)
    want = {"flash_fwd_lse": 5 * steps, "flash_bwd_dq": 5 * steps, "flash_bwd_dkv": 5 * steps,
            "flash_fwd": 5, "fused_l_sublayer": 0, "fused_t_sublayer": 0,
            "fused_ffn_sublayer": 0, **_optimizer_launches(steps, 1)}
    launches = [one["launches"]] + [rec["launches"] for rec in many]
    ok = worst <= DP_TOL and all(c == want for c in launches) and \
        os.listdir(os.path.join(work, "many")).count(f"step_{steps}") == 1
    where = "on the one card, the gradient all-reduce staged through the host" \
        if backend == "gloo" else "one card a rank"
    log(f"[dp] python -m mdgen_tpu_torch.train, 4AA recipe (5x384x16, T={TRAIN_FRAMES}, global "
        f"batch {B_TRAIN}, 32-true, --ema), {steps} steps: one rank {ms(one):.1f} ms a step "
        f"(after the first), {world} {backend} ranks ({where}, batch {B_TRAIN // world} each) "
        f"{' / '.join(f'{ms(r):.1f}' for r in many)} ms a step; commands {one_s:.1f} s and "
        f"{many_s:.1f} s ({smi}); losses {one['losses']} vs {many[0]['losses']}, grad norms "
        f"{one['grad_norms']} vs {many[0]['grad_norms']}, val loss "
        f"{one['val'][-1]['val_loss']:.6f} vs {many[0]['val'][-1]['val_loss']:.6f}: max rel "
        f"err {worst:.3e}, tol {DP_TOL:g}; launches per rank {launches} -> "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"[dp]: rel err {worst}, launches {launches}")
    return launches, one


# -- tensor and sequence parallelism; data-parallel inference -----------------

# the [mp] phase: the [dp] recipe (4AA, T = 1000, global batch 8, 32-true,
# --ema, DP_STEPS steps) on one rank and on each grid of MP_MESHES, two gloo
# ranks sharing the card (`--mesh DP,SP,TP`: that grid alone, NCCL, one card
# a rank); losses, grad norms and the val loss within DP_TOL relative of one
# rank's (the same sums in another order: the row-parallel all-reduces, the
# frame sums), and the written checkpoint loaded in one process within
# ADAM_BOUND of one rank's (Adam moves an entry at most lr a step, so a
# misplaced shard shows as a difference of the weights' own size)
MP_MESHES = ((1, 2, 1), (1, 1, 2))
# then the ATLAS recipe (crop 256, T = 250, B = 1, bf16-mixed, checkpointing,
# dropout 0.1) for ATLAS_MP_STEPS steps on the first mesh whose sp divides T
# against one rank's first steps ([atlas]'s run: the same data and draws):
# bf16 activations summed in another order (TOL bf16)
ATLAS_MP_STEPS = 2


def _adam_bound(steps, lr=1e-4):
    return 2 * lr * steps


def _ckpt_diff(torch, run_a, run_b):
    """Max |a - b| over the model and EMA tensors of two runs' newest
    checkpoints, each loaded whole in this process."""
    from mdgen_tpu_torch.runtime import checkpoint

    a, b = (torch.load(checkpoint.weights_path(r), map_location="cpu", weights_only=True)
            for r in (run_a, run_b))
    worst = 0.0
    for key in ("model", "ema"):
        if a[key].keys() != b[key].keys():
            raise AssertionError(f"checkpoint keys differ: {set(a[key]) ^ set(b[key])}")
        for k, v in a[key].items():
            if v.shape != b[key][k].shape:
                raise AssertionError(f"{key}.{k}: {tuple(v.shape)} vs {tuple(b[key][k].shape)}")
            worst = max(worst, (v.float() - b[key][k].float()).abs().max().item())
    return worst


def _mesh_flags(mesh, backend):
    dp, sp, tp = mesh
    where = ["--device", "cuda:0", "--dist_backend", "gloo"] if backend == "gloo" else \
        ["--device", "cuda", "--dist_backend", "nccl"]
    return ["--dp_size", str(dp), "--sp_size", str(sp), "--tp_size", str(tp), *where]


def phase_mp(torch, smi, work, one=None, meshes=MP_MESHES, backend="gloo", steps=DP_STEPS,
             atlas_one=None):
    return _mp(torch, smi, work, one, meshes, backend, steps, atlas_one)


def _mp(torch, smi, work, one, meshes, backend, steps, atlas_one):
    """Each grid of ``meshes`` through `python -m mdgen_tpu_torch.train
    --dp_size --sp_size --tp_size` (one command; its ranks on cuda:0 under
    gloo, one card each under NCCL) against one rank (``one``: [dp]'s run,
    else run here). Checks each rank's losses, grad norms and val loss, its
    launches (kernels 5-7 at 5 x steps and kernel 4 at 5 under tp alone; none
    under sp, whose frame attention is dense as JAX keeps it) and the
    checkpoint; prints ms a step and each rank's peak device memory. Then
    the ATLAS recipe (``atlas_one``: [atlas]'s one-rank run of the same data
    and draws, else run here). Returns {mesh: launches of each rank}."""
    base = _recipe_argv(work, steps)
    if one is None:
        _run_clis([[*base, "--run_name", "one", "--dp_size", "1", "--record",
                    os.path.join(work, "one.{rank}.json")]])
        (one,) = _records(work, "one", 1)
    gib = 2**30
    out = {}
    for mesh in meshes:
        name = "mp" + "x".join(map(str, mesh))
        n = mesh[0] * mesh[1] * mesh[2]
        _, sec = _run_clis([[*base, "--run_name", name, "--record",
                             os.path.join(work, f"{name}.{{rank}}.json"),
                             *_mesh_flags(mesh, backend)]])
        ranks = _records(work, name, n)
        worst = _rel_worst(ranks, one)
        ckpt = _ckpt_diff(torch, os.path.join(work, "one"), os.path.join(work, name))
        flash = mesh[1] == 1
        want = {"flash_fwd_lse": 5 * steps * flash, "flash_bwd_dq": 5 * steps * flash,
                "flash_bwd_dkv": 5 * steps * flash, "flash_fwd": 5 * flash,
                "fused_l_sublayer": 0, "fused_t_sublayer": 0, "fused_ffn_sublayer": 0,
                **_optimizer_launches(steps, mesh[2])}
        launches = [r["launches"] for r in ranks]
        ok = (worst <= DP_TOL and ckpt <= _adam_bound(steps)
              and all(c == want for c in launches))
        mems = " / ".join(f"{r['peak_device_bytes'] / gib:.2f}" for r in ranks)
        step_ms = " / ".join(f"{_ms_a_step(r):.1f}" for r in ranks)
        log(f"[mp] python -m mdgen_tpu_torch.train, 4AA recipe (5x384x16, T={TRAIN_FRAMES}, "
            f"global batch {B_TRAIN}, 32-true, --ema), {steps} steps on a dp x sp x tp = "
            f"{' x '.join(map(str, mesh))} grid of {backend} ranks: {step_ms} ms a step "
            f"against one rank's {_ms_a_step(one):.1f}; peak device memory per rank {mems} GiB "
            f"against {one['peak_device_bytes'] / gib:.2f}; command {sec:.1f} s ({smi}); losses "
            f"{ranks[0]['losses']} vs {one['losses']}, grad norms {ranks[0]['grad_norms']} vs "
            f"{one['grad_norms']}, val loss {ranks[0]['val'][-1]['val_loss']:.6f} vs "
            f"{one['val'][-1]['val_loss']:.6f}: max rel err {worst:.3e}, tol {DP_TOL:g}; "
            f"checkpoint loaded whole, max |diff| {ckpt:.3e} from one rank's, bound "
            f"{_adam_bound(steps):g}; launches per rank {launches}, want {want} -> "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"[mp] {mesh}: rel err {worst}, ckpt {ckpt}, {launches}")
        out[name] = launches
    atlas = [m for m in meshes if ATLAS_FRAMES % m[1] == 0 and H % m[2] == 0]
    if atlas:
        out.update(_mp_atlas(torch, smi, work, atlas[0], backend, atlas_one))
    else:
        log(f"[mp] ATLAS: T={ATLAS_FRAMES} is not a multiple of sp in {meshes}: not run")
    return out


def _mp_atlas(torch, smi, work, mesh, backend, one):
    """The ATLAS recipe for ATLAS_MP_STEPS steps on ``mesh`` against one
    rank's first ATLAS_MP_STEPS (``one``, else run here)."""
    import numpy as np

    from mdgen_tpu_torch.data import synthetic_trajectory

    seq = _atlas_seqs()[ATLAS_TRAIN]
    data = os.path.join(work, "atlas")
    os.makedirs(data, exist_ok=True)
    for r in (1, 2, 3):
        np.save(os.path.join(data, f"{ATLAS_TRAIN}_R{r}.npy"),
                synthetic_trajectory(seq, ATLAS_FRAMES + 10, seed=r))
    split = os.path.join(data, "split.csv")
    with open(split, "w") as fh:
        fh.write(f"name,seqres\n{ATLAS_TRAIN},{seq}\n")
    base = ["-m", "mdgen_tpu_torch.train", "--sim_condition", "--prepend_ipa", "--abs_pos_emb",
            "--abs_time_emb", "--atlas", "--crop", str(ATLAS_CROP), "--num_frames",
            str(ATLAS_FRAMES), "--batch_size", "1", "--precision", "bf16-mixed",
            "--grad_checkpointing", "--dropout", str(ATLAS_DROPOUT), "--epochs",
            str(ATLAS_MP_STEPS), "--no_validate", "--ckpt_freq", "1000", "--train_split", split,
            "--val_split", split, "--data_dir", data, "--workdir", data]
    name = "atlas" + "x".join(map(str, mesh))
    if one is None:
        _run_clis([[*base, "--run_name", "one", "--record",
                    os.path.join(data, "one.{rank}.json"), "--device", "cuda", "--dp_size", "1"]])
        (one,) = _records(data, "one", 1)
    _, sec = _run_clis([[*base, "--run_name", name, "--record",
                         os.path.join(data, f"{name}.{{rank}}.json"),
                         *_mesh_flags(mesh, backend)]])
    ranks = _records(data, name, mesh[0] * mesh[1] * mesh[2])
    head = {k: one[k][:ATLAS_MP_STEPS] for k in ("losses", "grad_norms")}
    worst = _rel_worst(ranks, head, val=False)
    launches = [r["launches"] for r in ranks]
    gib = 2**30
    want = {**dict.fromkeys(KERNELS, 0), **_optimizer_launches(ATLAS_MP_STEPS, mesh[2])}
    ok = worst <= TOL["bf16"] and all(c == want for c in launches)
    mems = " / ".join(f"{r['peak_device_bytes'] / gib:.2f}" for r in ranks)
    step_ms = " / ".join(f"{_ms_a_step(r):.1f}" for r in ranks)
    log(f"[mp] python -m mdgen_tpu_torch.train --atlas ({ATLAS_TRAIN} cropped to {ATLAS_CROP}, "
        f"T={ATLAS_FRAMES}, B=1, bf16-mixed, grad_checkpointing, dropout {ATLAS_DROPOUT}), "
        f"{ATLAS_MP_STEPS} steps on a dp x sp x tp = {' x '.join(map(str, mesh))} grid of "
        f"{backend} ranks: peak device memory per rank {mems} GiB against one rank's "
        f"{one['peak_device_bytes'] / gib:.2f}; step 2 {step_ms} ms against "
        f"{_ms_a_step(one):.1f} (one rank, steps 2-{len(one['losses'])}); "
        f"command {sec:.1f} s ({smi}); losses {ranks[0]['losses']} vs {head['losses']}, grad "
        f"norms {ranks[0]['grad_norms']} vs {head['grad_norms']}: max rel err {worst:.3e}, tol "
        f"{TOL['bf16']:g}; launches per rank {launches} (all dense) -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"[mp] ATLAS {mesh}: rel err {worst}, {launches}")
    return {name: launches}


# the [dp-infer] phase: `python -m mdgen_tpu_torch.sim_inference --fused_block
# --dp_size 2` (two gloo ranks on the card, a peptide each) against one rank
# at the main path's shape (DP_INFER_PEPTIDES, T = 100, 100 Euler steps,
# ROLLOUTS rollouts, bf16-mixed): each rank runs the same kernels on fewer
# rows; the first rollout within DP_INFER_TOL (a row's sums can take another
# cuBLAS algorithm at another batch size, in bf16), the later chained ones
# reported; and one dopri5 batch of TPS_DP_PATHS paths of `tps_inference
# --dp_size 2` (padded to 4), equal evaluation counts
DP_INFER_PEPTIDES = ("ACDE", "FGHI")
DP_INFER_TOL = 1e-2
TPS_DP_PATHS = 3


def _pdb_frames(path):
    import numpy as np

    with open(path) as fh:
        lines = [ln for ln in fh.read().splitlines() if ln.startswith("ATOM")]
    return np.array([[float(ln[30:38]), float(ln[38:46]), float(ln[46:54])] for ln in lines])


def phase_dp_infer(torch, smi, work, state_dict):
    return _dp_infer(torch, smi, work, state_dict)


def _one_rank(work, module, name, argv):
    """`mdgen_tpu_torch.{module}.main(argv)` on one rank in this process,
    into ``work/{name}1``: {"records", "launches"} as a rank's JSON."""
    from mdgen_tpu_torch import ops

    cli = importlib.import_module(f"mdgen_tpu_torch.{module}")
    ops.reset_launch_counts()
    records = cli.main([*argv, "--out_dir", os.path.join(work, f"{name}1"), "--device", "cuda"])
    return json.loads(json.dumps({"records": records, "launches": ops.launch_counts()},
                                 default=lambda a: a.tolist()))


def _two_gloo_ranks(work, module, name, argv):
    """`python -m mdgen_tpu_torch.{module} --dp_size 2`, both ranks on the
    card, into ``work/{name}2``: each rank's {"records", "launches"}."""
    _run_clis([["-m", f"mdgen_tpu_torch.{module}", *argv, "--out_dir",
                os.path.join(work, f"{name}2"), "--record", os.path.join(work, f"{name}2.{{rank}}.json"),
                "--dp_size", "2", "--device", "cuda:0", "--dist_backend", "gloo"]])
    return _records(work, f"{name}2", 2)


def _dp_infer(torch, smi, work, state_dict):
    """Returns {"sim": launches of each rank (one rank, then two),
    "tps": the same}."""
    import shutil

    import numpy as np

    from mdgen_tpu_torch.data import synthetic_rotamer_trajectory, synthetic_trajectory
    from mdgen_tpu_torch.runtime import checkpoint

    for i, s in enumerate(DP_INFER_PEPTIDES):
        np.save(os.path.join(work, f"{s}.npy"), synthetic_trajectory(s, 1, seed=i))
    split = os.path.join(work, "split.csv")
    with open(split, "w") as fh:
        fh.write("name,seqres\n" + "".join(f"{s},{s}\n" for s in DP_INFER_PEPTIDES))
    ckpt = os.path.join(work, "ckpt")
    checkpoint.save_checkpoint(ckpt, bench_config(), state_dict)
    argv = ["--sim_ckpt", ckpt, "--data_dir", work, "--split", split, "--num_rollouts",
            str(ROLLOUTS), "--batch_size", str(len(DP_INFER_PEPTIDES)), "--fused_block"]
    one = _one_rank(work, "sim_inference", "sim", argv)
    two_recs = _two_gloo_ranks(work, "sim_inference", "sim", argv)
    first, worst, shapes = 0.0, 0.0, True
    for s in DP_INFER_PEPTIDES:
        a, b = (_pdb_frames(os.path.join(work, f"sim{n}", f"{s}.pdb")) for n in (1, 2))
        per = len(a) // ROLLOUTS  # the atoms of one rollout's frames
        shapes &= a.shape == b.shape and bool(np.isfinite(a).all() and np.isfinite(b).all())
        first = max(first, float(np.abs(a[:per] - b[:per]).max()))
        worst = max(worst, float(np.abs(a - b).max()))
    want = 5 * (EULER_STEPS - 1) * ROLLOUTS
    launches = [r["launches"] for r in [one, *two_recs]]
    rec1, rec2 = one["records"][0], two_recs[0]["records"][0]
    ok = (first <= DP_INFER_TOL and shapes
          and [x["evals"] for x in rec1["solves"]] == [x["evals"] for x in rec2["solves"]]
          and all(c[k] == want for c in launches for k in FUSED_KERNELS)
          and not any(c[k] for c in launches for k in FLASH_KERNELS))
    fps = [r["frames"] / r["seconds"] for r in (rec1, rec2)]
    log(f"[dp-infer] python -m mdgen_tpu_torch.sim_inference --fused_block (5x384x16, "
        f"bf16-mixed, {len(DP_INFER_PEPTIDES)} peptides x {ROLLOUTS} rollouts x {NUM_FRAMES} "
        f"frames, Euler {EULER_STEPS}): one rank {fps[0]:.1f} frames/s, --dp_size 2 (gloo, the "
        f"one card) {fps[1]:.1f} frames/s ({smi}); written PDBs: first rollout max |diff| "
        f"{first:.3e} A, tol {DP_INFER_TOL:g} A; all {ROLLOUTS} chained rollouts {worst:.3e} A; "
        f"evaluations {[x['evals'] for x in rec2['solves']]}; launches per rank (one rank, "
        f"then two) {launches}, want {want} of each fused kernel -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"[dp-infer] sim: first {first} A, launches {launches}")
    out = {"sim": launches}

    md = synthetic_rotamer_trajectory(SEQ, TPS_MD_FRAMES, seed=0)
    np.save(os.path.join(work, "md_ACDE.npy"), md)
    tps_split = os.path.join(work, "tps.csv")
    with open(tps_split, "w") as fh:
        fh.write(f"name,seqres\nmd_ACDE,{SEQ}\n")
    cfg = task_config(tps_condition=True, num_frames=NUM_FRAMES)
    tps_ckpt = os.path.join(work, "tps_ckpt")
    checkpoint.save_checkpoint(tps_ckpt, cfg, seeded_model(torch, cfg).state_dict())
    argv = ["--sim_ckpt", tps_ckpt, "--data_dir", work, "--split", tps_split, "--num_batches",
            "1", "--batch_size", str(TPS_DP_PATHS), "--tica_lag", str(TPS_TICA_LAG), "--msm_lag",
            str(TPS_MSM_LAG), "--fused_block"]
    recs = {1: [_one_rank(work, "tps_inference", "tps", argv)]}
    os.makedirs(os.path.join(work, "tps2"))  # the one-rank run's MSM
    shutil.copy(os.path.join(work, "tps1", "md_ACDE_metadata.pkl"), os.path.join(work, "tps2"))
    recs[2] = _two_gloo_ranks(work, "tps_inference", "tps", argv)
    r1, r2 = recs[1][0]["records"][0], recs[2][0]["records"][0]
    err = max(float(np.abs(_pdb_frames(p) - _pdb_frames(q)).max())
              for p, q in zip(r1["paths"], r2["paths"]))
    st1, st2 = r1["solves"][0], r2["solves"][0]
    launches = [r["launches"] for r in recs[1] + recs[2]]
    ok = (st1["evals"] == st2["evals"] and st1["reached_t1"] and err <= DP_INFER_TOL
          and r1["start_idx"] == r2["start_idx"] and r1["end_idx"] == r2["end_idx"]
          and all(c[k] == 5 * st1["evals"] for c in launches for k in FUSED_KERNELS))
    log(f"[dp-infer] python -m mdgen_tpu_torch.tps_inference --fused_block --dp_size 2 "
        f"(bf16-mixed dopri5, {TPS_DP_PATHS} paths padded to 4): {st2['evals']} evaluations "
        f"({st2['attempts']} attempts, {st2['rejected']} rejected) against one rank's "
        f"{st1['evals']}; paths max |diff| {err:.3e} A, tol {DP_INFER_TOL:g} A; "
        f"{r1['seconds']:.3f} s vs {r2['seconds']:.3f} s ({smi}); launches per rank "
        f"{launches} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"[dp-infer] tps: {st1} vs {st2}, {err} A, {launches}")
    out["tps"] = launches
    return out


def phase_port_ckpt(torch, smi):
    with tempfile.TemporaryDirectory(prefix="mdgen_port_ckpt_") as work:
        return _port_ckpt(torch, smi, work)


def _port_ckpt(torch, smi, work):
    """A reference-layout Lightning .ckpt of the seeded bench model (the EMA
    entry: the seeded weights; the raw weights: those plus noise) ported by
    `python -m mdgen_tpu_torch.port_checkpoint`; the ported run's model (its
    EMA) against the seeded model in f32 on the card; then
    `sim_inference --fused_block` on the run directory. Returns the
    sampling's launches."""
    import numpy as np

    from mdgen_tpu_torch import interop, ops, sim_inference
    from mdgen_tpu_torch.data import synthetic_trajectory
    from mdgen_tpu_torch.runtime import checkpoint

    cfg = bench_config(ema=True)
    seeded = seeded_model(torch, cfg).state_dict()
    g = torch.Generator().manual_seed(3)
    raw = {k: v + 0.01 * torch.randn(v.shape, generator=g) for k, v in seeded.items()}
    ckpt, out = os.path.join(work, "ref.ckpt"), os.path.join(work, "ported")
    interop.write_lightning_checkpoint(ckpt, cfg, raw, seeded, global_step=704999,
                                       precision="bf16-mixed")
    (text,), sec = _run_clis([["-m", "mdgen_tpu_torch.port_checkpoint", "--ckpt", ckpt,
                               "--out", out]])
    if checkpoint.latest_step(out) != 704999 or checkpoint.load_config(out) != cfg:
        raise AssertionError(f"[port-ckpt] bad run directory: {os.listdir(out)}\n{text}")

    f32 = cfg.replace(precision="32-true")
    ported, _ = checkpoint.load_model(out, f32, "cuda")
    ref = _runtime(torch, f32, seeded).model.eval()
    start, seqres, mask = _start(torch)
    gen = torch.Generator(device="cuda").manual_seed(0)
    batch = {"atom14": start[:, None].expand(B, NUM_FRAMES, L, 14, 3), "seqres": seqres,
             "mask": mask}
    from mdgen_tpu_torch.runtime.wrapper import tokenize
    from mdgen_tpu_torch.tasks import prep_batch

    prep = prep_batch(f32, tokenize(f32, batch))
    x = torch.randn((B, NUM_FRAMES, L, cfg.latent_dim), generator=gen, device="cuda")
    t = torch.full((B,), 0.4, device="cuda")
    with torch.no_grad():
        want = ref(x, t, **prep.model_kwargs)
        got = ported(x, t, **prep.model_kwargs)
    err = float((got - want).abs().max() / want.abs().max().clamp_min(1.0))

    np.save(os.path.join(work, "ACDE.npy"), synthetic_trajectory(SEQ, NUM_FRAMES, seed=0))
    split = os.path.join(work, "split.csv")
    with open(split, "w") as fh:
        fh.write(f"name,seqres\nACDE,{SEQ}\n")
    ops.reset_launch_counts()
    rec = sim_inference.main(["--sim_ckpt", out, "--data_dir", work, "--split", split,
                              "--out_dir", os.path.join(work, "samples"), "--num_rollouts", "1",
                              "--fused_block", "--device", "cuda"])[0]
    counts = ops.launch_counts()
    want_counts = {k: 5 * (EULER_STEPS - 1) if k in FUSED_KERNELS else 0 for k in counts}
    with open(rec["paths"][0]) as fh:
        pdb = fh.read()
    coords = np.array([float(line[30:38]) for line in pdb.splitlines() if line.startswith("ATOM")])
    ok = err <= PORT_CKPT_TOL and counts == want_counts and rec["frames"] == NUM_FRAMES and \
        coords.size > 0 and np.isfinite(coords).all()
    log(f"[port-ckpt] python -m mdgen_tpu_torch.port_checkpoint (Lightning .ckpt, reference "
        f"layout, 5x384x16 with ema, global_step 704999): {sec:.1f} s; the ported run's EMA "
        f"model vs the seeded model, f32 forward (T={NUM_FRAMES}): max err {err:.3e} of "
        f"max(|out|, 1), tol {PORT_CKPT_TOL:g}; sim_inference --fused_block from the run: "
        f"{rec['frames']} frames in {rec['seconds']:.3f} s ({smi}); launches {counts} -> "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"[port-ckpt]: err {err}, launches {counts}, {rec['frames']} frames")
    return counts


def _eval_protocol(smi, work, res):
    """`python -m mdgen_tpu_torch.eval_protocol` on the quality run in
    ``work``: its table finite (a ratio of None, a floor of 0, is not), its
    drift evaluations and the sampling's kernel launches (printed by the
    protocol): kernels 1-3 once a layer in every evaluation, the flash
    kernels never. Returns the launches."""
    import re

    import numpy as np

    from mdgen_tpu_torch.runtime import checkpoint

    (text,), sec = _run_clis([["-m", "mdgen_tpu_torch.eval_protocol", "--ckpt", res["run_dir"],
                               "--train_data", res["data_dir"], "--out",
                               os.path.join(work, "eval"), "--train_frames",
                               str(QUALITY_MD_FRAMES), "--eval_frames", str(EVAL_FRAMES),
                               "--num_rollouts", str(EVAL_ROLLOUTS), "--fused_block",
                               "--device", "cuda"]])
    line = next(x for x in text.splitlines() if x.startswith("[eval-protocol]"))
    launches = json.loads(line.split("kernel launches ", 1)[1])
    evals = int(re.search(r"solves, (\d+) in all\)", line).group(1))
    layers = checkpoint.load_config(res["run_dir"]).num_layers
    want = {k: layers * evals if k in FUSED_KERNELS else 0 for k in launches}
    table = json.loads(text[text.index("\n{") + 1:text.index("EVAL PROTOCOL OK")])
    vals = [table["mean_torsion_jsd"], table["floor_torsion_jsd"], table["ratio"]]
    vals += [v[k] for v in table["per_type"].values() for k in ("model", "floor", "ratio")]
    ok = "EVAL PROTOCOL OK" in text and launches == want and \
        all(v is not None and np.isfinite(v) for v in vals)
    log(f"[eval-protocol] python -m mdgen_tpu_torch.eval_protocol --fused_block on the [quality] "
        f"run ({EVAL_FRAMES} eval frames, {EVAL_ROLLOUTS} rollouts x 8 peptides, the noise floor "
        f"at {EVAL_ROLLOUTS * 100} frames): {sec:.1f} s ({smi}); {line[len('[eval-protocol] '):]}; "
        f"table {json.dumps(table)}; launches held to {layers} layers x {evals} evaluations "
        f"-> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"[eval-protocol]: table {table}, launches {launches}, want {want}")
    return launches


def phase_native_io(smi, writes):
    """[native-io]: the g++ version and a build of the C++ writers
    (``mdgen_tpu_torch/native.py``) from the checkout's sources; then each
    path's trajectories as its CLI wrote them (the main path's 500-frame
    PDB, the upsampling path's 3000-frame XTC with its frame-0 PDB, the
    design batch's 32 PDBs) written again by the native and by the Python
    writers: the PDBs byte-equal, the XTC byte-equal or, at a coordinate
    whose product with the precision rounds to another integer in float32
    (the C++ encoder) than in float64 (the Python one), each file holding
    its own encoder's integers; the seconds of each writer and their share
    of the path's wall time (its solve plus that writer)."""
    import numpy as np

    from mdgen_tpu_torch import native, xtc
    from mdgen_tpu_torch.protein import save_trajectory

    cxx = subprocess.run(["g++", "--version"], capture_output=True, text=True, timeout=60)
    with tempfile.TemporaryDirectory(prefix="mdgen_native_") as d:
        t0 = time.perf_counter()
        native.build(build_dir=d)
        build_s = time.perf_counter() - t0
    log(f"[native-io] {cxx.stdout.splitlines()[0]}; the writers built from "
        f"mdgen_tpu_torch/native/*.cpp ({' '.join(native.CXX_FLAGS)}) in {build_s:.2f} s")
    for path, w in writes.items():
        secs, files, coords = {}, {}, []
        write_xtc = xtc.write_xtc

        def recording(path_, coords_nm, *a, **kw):
            coords.append(np.array(coords_nm, np.float32))
            return write_xtc(path_, coords_nm, *a, **kw)

        with tempfile.TemporaryDirectory(prefix="mdgen_io_") as d:
            for use_native in (True, False):
                out = os.path.join(d, str(use_native))
                os.makedirs(out)
                xtc.write_xtc = recording if use_native else write_xtc
                try:
                    t0 = time.perf_counter()
                    for atom14, aatype, pdb, xtc_name in w["items"]:
                        save_trajectory(atom14, aatype, os.path.join(out, pdb),
                                        os.path.join(out, xtc_name) if xtc_name else None,
                                        use_native=use_native)
                    secs[use_native] = time.perf_counter() - t0
                finally:
                    xtc.write_xtc = write_xtc
                files[use_native] = {f: os.path.join(out, f) for f in sorted(os.listdir(out))}
            equal = {f: open(files[True][f], "rb").read() == open(files[False][f], "rb").read()
                     for f in files[True]}
            ok = files[True].keys() == files[False].keys() and all(
                v for f, v in equal.items() if f.endswith(".pdb"))
            ties = 0
            for f, c in zip([f for f in files[True] if f.endswith(".xtc")], coords):
                q = {}
                for dt in (np.float32, np.float64):
                    lf = c.astype(dt) * dt(1000.0)
                    q[dt] = np.where(lf >= 0, lf + dt(0.5), lf - dt(0.5)).astype(np.int64)
                ties += int((q[np.float32] != q[np.float64]).sum())
                got = {n: np.rint(xtc.read_xtc(files[n][f])[0].astype(np.float64) * 1000)
                       .astype(np.int64) for n in (True, False)}
                ok &= (np.array_equal(got[True], q[np.float32])
                       and np.array_equal(got[False], q[np.float64])
                       and equal[f] == (q[np.float32] == q[np.float64]).all())
        frames = sum(len(item[0]) for item in w["items"])
        share = {n: secs[n] / (w["solve_s"] + secs[n]) for n in (True, False)}
        log(f"[native-io] {path}: {len(w['items'])} trajectories, {frames} frames "
            f"({', '.join(sorted({os.path.splitext(f)[1] for f in files[True]}))}): native "
            f"{secs[True]:.4f} s, Python {secs[False]:.4f} s ({secs[False] / secs[True]:.1f}x); "
            f"the path's solve {w['solve_s']:.3f} s, the writers' share of its wall native "
            f"{share[True]:.2%}, Python {share[False]:.2%} (the CLI's own native write "
            f"{w['cli_write_s']:.4f} s); files byte-equal {sum(equal.values())} of {len(equal)}, "
            f"float32/float64 rounding ties in the XTC {ties}, each file holding its own "
            f"encoder's integers ({smi}) -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"[native-io] {path}: the native and Python writers disagree: "
                                 f"{equal}, ties {ties}")


def phase_micro_fwd(torch, smi):
    """[micro-fwd]: ``python -m mdgen_tpu_torch.micro_fwd`` (its ``main``) at
    the 4AA sampling shape (B = 8, T = 100, bf16-mixed, seeded weights),
    MICRO_STEPS chained forwards, fused and dense: kernels 1-3 at 5 launches
    each a step (the dense run none); the forwards' own contribution, the
    drift out - x0 = 0.01 * sum of the forwards, nonzero and within
    MICRO_TOL x the dense drift's max (x0 itself is left out: its N(0, 1)
    draws would swamp the forwards); ms a step eagerly and as CUDA-graph
    replays."""
    from mdgen_tpu_torch import micro_fwd

    runs = {fused: micro_fwd.main(["--steps", str(MICRO_STEPS)]
                                  + (["--fused_block"] if fused else []))
            for fused in (True, False)}
    launches, dense = runs[True]["launches"], runs[False]["drift"]
    err = (runs[True]["drift"] - dense).abs().max().item()
    scale = dense.abs().max().item()
    want = 5 * MICRO_STEPS
    ok = (bool(torch.isfinite(runs[True]["out"]).all()) and 0 < scale
          and err <= MICRO_TOL * scale
          and all(launches[k] == want for k in FUSED_KERNELS)
          and not any(launches[k] for k in FLASH_KERNELS)
          and not any(runs[False]["launches"].values()))
    log(f"[micro-fwd] micro_fwd --steps {MICRO_STEPS} (5x384x16, B=8, T=100, bf16-mixed): fused "
        f"{runs[True]['eager_ms']:.3f} ms a step eagerly, {runs[True]['graph_ms']:.3f} ms as a "
        f"CUDA graph; dense {runs[False]['eager_ms']:.3f} / {runs[False]['graph_ms']:.3f} ms; "
        f"drift (out - x0) fused vs dense max_abs_err {err:.3e}, the dense drift's max "
        f"{scale:.4e}, tol {MICRO_TOL:g} x that; launches a run {launches}, want {want} of "
        f"each fused kernel ({smi}) -> "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"[micro-fwd]: err {err}, launches {launches}")
    return launches


def phase_e2e(smi):
    """[e2e]: ``python -m mdgen_tpu_torch.e2e_smoke`` (its ``main``) at
    E2E_STEPS steps: the synthetic dataset, training (the fixed-draw loss
    falls), the checkpoint round trip, 3 rollouts, the PDB and its torsion
    JSDs, all finite."""
    import numpy as np

    from mdgen_tpu_torch import e2e_smoke

    with tempfile.TemporaryDirectory(prefix="mdgen_e2e_") as work:
        t0 = time.perf_counter()
        res = e2e_smoke.main(["--steps", str(E2E_STEPS), "--out", work, "--device", "cuda"])
        sec = time.perf_counter() - t0
    ok = res["loss1"] < res["loss0"] and bool(np.isfinite(res["jsds"]).all())
    log(f"[e2e] e2e_smoke --steps {E2E_STEPS}: {sec:.1f} s; {res['steps_per_s']:.2f} steps/s, "
        f"fixed-draw loss {res['loss0']:.4f} -> {res['loss1']:.4f}; rollout "
        f"{res['frames_per_s']:.1f} frames/s; torsion JSDs mean {np.mean(res['jsds']):.4f} "
        f"({smi}) -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"[e2e]: {res}")


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--dp_ranks", type=int, default=0,
                        help="run [dp] alone with this many NCCL ranks, one card each")
    parser.add_argument("--mesh", type=str, default=None, metavar="DP,SP,TP",
                        help="run [mp] alone on this grid of NCCL ranks, one card each")
    opts = parser.parse_args(argv)
    dp_ranks = opts.dp_ranks
    mesh = tuple(int(v) for v in opts.mesh.split(",")) if opts.mesh else None
    if mesh is not None and len(mesh) != 3:
        raise ValueError(f"--mesh takes DP,SP,TP, got {opts.mesh!r}")
    if not os.path.isdir(os.path.join(HERE, "mdgen_tpu_torch")):
        raise RuntimeError("run chip_smoke.py from a checkout of the repository")
    sys.path.insert(0, HERE)
    import torch

    name, count, smi = phase_device(torch)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    phase_build()
    if dp_ranks or mesh:
        need = dp_ranks or mesh[0] * mesh[1] * mesh[2]
        if count < need:
            raise RuntimeError(f"{need} NCCL ranks need {need} cards, found {count}")
        with tempfile.TemporaryDirectory(prefix="mdgen_dp_") as work:
            if dp_ranks:
                phase_dp(torch, smi, work, dp_ranks, "nccl", DP_SCALING_STEPS)
            else:
                phase_mp(torch, smi, work, None, [mesh], "nccl", DP_SCALING_STEPS)
        log(f"[done] {'[dp]' if dp_ranks else '[mp]'} with {need} NCCL ranks passed in "
            f"{time.perf_counter() - t0:.1f} s")
        print(smi)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                                 "count": count}}))
        return
    parity = phase_kernel_parity(torch)
    state_dict = seeded_model(torch, bench_config()).state_dict()
    phase_model_parity(torch, state_dict)
    counts, rollout_s, main_writes = phase_main_path(state_dict, smi)
    phase_dopri5(torch, state_dict, rollout_s, smi)
    t_new = time.perf_counter()
    eval_counts = phase_quality(torch, smi, eval_protocol=True)
    quality_s = time.perf_counter() - t_new
    tps_counts, _ = phase_tps(torch, smi)
    ups_counts, ups, upsampling = phase_upsampling(torch, smi)
    design_counts, design = phase_design(torch, smi)
    mpnn_counts = phase_mpnn(torch, smi)
    for task in ("tps", "upsampling", "design"):
        phase_quality_task(torch, smi, task)
    t_new = time.perf_counter()
    hyena_counts = phase_hyena(torch, smi)
    sde_counts = phase_sde(torch, smi, state_dict)
    lik_counts = phase_likelihood(torch, smi, state_dict)
    option_counts = phase_options(torch, smi)
    phase_quality(torch, smi, tag="quality-hyena", train_extra="--hyena")
    new_s = time.perf_counter() - t_new
    parity.update(phase_flash_parity(torch))
    phase_grad_parity(torch, state_dict)
    train_counts, _ = phase_training(torch, smi)
    t_new = time.perf_counter()
    atlas_counts = phase_atlas(torch, smi)
    atlas_s = time.perf_counter() - t_new
    t_new = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="mdgen_dp_") as work:
        dp_launches, one = phase_dp(torch, smi, work)
        dp_s = time.perf_counter() - t_new
        mp_launches = phase_mp(torch, smi, work, one, atlas_one=atlas_counts["record"])
    mp_s = time.perf_counter() - t_new - dp_s
    with tempfile.TemporaryDirectory(prefix="mdgen_dp_infer_") as work:
        infer_launches = phase_dp_infer(torch, smi, work, state_dict)
    infer_s = time.perf_counter() - t_new - dp_s - mp_s
    t_new = time.perf_counter()
    port_counts = phase_port_ckpt(torch, smi)
    slice_s = time.perf_counter() - t_new + dp_s
    t_new = time.perf_counter()
    phase_native_io(smi, {"main": main_writes, "upsampling": ups["writes"],
                          "design": design["writes"]})
    micro_counts = phase_micro_fwd(torch, smi)
    phase_e2e(smi)
    slice13_s = time.perf_counter() - t_new
    log(f"[phases] [hyena] to [quality-hyena] {new_s:.1f} s, [atlas] {atlas_s:.1f} s, "
        f"[quality] with [eval-protocol] {quality_s:.1f} s, [dp] and [port-ckpt] {slice_s:.1f} s, "
        f"[mp] {mp_s:.1f} s, [dp-infer] {infer_s:.1f} s, [native-io] to [e2e] {slice13_s:.1f} s")
    frame_us = phase_profiles(torch, state_dict, rollout_s, smi, upsampling)
    parity["fused_t_sublayer"]["upsampling_t1000_us_per_launch"] = frame_us
    parity["fused_adam"].update(_profile_optimizer(torch))
    log(f"[done] all phases passed in {time.perf_counter() - t0:.1f} s")
    keys = ("max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms", "bound_by")
    kernels = [
        {"name": k, "route": "cuda", "source": src, "replaces": rep,
         "launches": (counts if k in FUSED_KERNELS else train_counts)[k],
         "tps_launches": tps_counts[k], "upsampling_launches": ups_counts[k],
         "design_launches": design_counts[k],
         "mpnn_launches": mpnn_counts["mpnn"][k] + mpnn_counts["dynamic_mpnn"][k],
         "hyena_launches": hyena_counts[k], "sde_launches": sde_counts[k],
         "likelihood_launches": lik_counts[k], "options_launches": option_counts[k],
         "atlas_train_launches": atlas_counts["train"][k],
         "atlas_residue_launches": atlas_counts["residue"][k],
         "remat_launches": atlas_counts["remat"][k],
         "dp_launches_per_rank": [c[k] for c in dp_launches],
         "mp_launches_per_rank": {m: [c[k] for c in cs] for m, cs in mp_launches.items()},
         "dp_infer_launches_per_rank": {p: [c[k] for c in cs]
                                        for p, cs in infer_launches.items()},
         "port_ckpt_launches": port_counts[k], "eval_protocol_launches": eval_counts[k],
         "micro_fwd_launches": micro_counts[k],
         **{key: parity[k][key] for key in keys}, "library_ms": parity[k].get("library_ms"),
         **{key: v for key, v in parity[k].items() if key not in keys + ("library_ms",)}}
        for k, (src, rep) in KERNELS.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))


if __name__ == "__main__":
    main()  # any failure raises: traceback, exit code 1, no result line
