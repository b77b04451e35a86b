#!/usr/bin/env python3
"""Drive the PyTorch port (micro_diffusion_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py            # from the repository root, on a machine with a card

Phases, each of which fails the run on a failed check:
  1. device  - the card's name and power limit; build the CUDA kernels (one nvcc
               per source, started together) and the native MDS gather (g++), and
               report the build times.
  2. kernels - each hand-written kernel against its plain PyTorch version on the
               card, in bf16, at the shapes of the MicroDiT-XL sampling path;
               CUDA-event times of kernel, plain version and (attention only)
               F.scaled_dot_product_attention as the library yardstick.
     The backward kernels likewise at every MicroDiT-XL stage-1 training shape
               (microbatch 256) and the 512px ones, with SDPA's backward as the
               attention yardstick; the attention backwards (K1b, K4b) from the
               kernel forward's out and row statistics, two calls bitwise equal,
               their deviation from the exact TPU contract logged; the MoE
               backwards (K2b, K3b) two calls bitwise equal. Beside every MoE row
               the time of the cuBLAS chain bmm -> GELU -> bmm (and its autograd
               backward) on the same inputs: a chain of library calls, for
               context (library_chain_ms), which the port never runs.
     The fused adaLN LayerNorm+modulate kernel (K6) likewise at every shape the
               trainer path runs (XL stage 1, the Tiny round trip) and one 512px
               shape (no PyTorch call computes it: no library yardstick).
     The expert-major MoE kernels (K3) and the whole-K attention (K4), forward and
               backward, at the shapes phases 7-9 record (SDPA as K4's yardstick);
               the tiled attention with the saved logsumexp (K5), forward (out and
               lse) and backward (K1b/K4b's kernels in their lse form, two calls
               bitwise equal), at the shapes [stage2] records under 'flash_bthd',
               two 512px ones and the caption block's (SDPA as the yardstick).
  3. slice   - MicroDiT-XL at full width (256px, seeded init with the zero-init
               layers perturbed): one CFG forward through the kernels against the
               same forward through the plain versions, then generate() of 4
               prompts, 30 Heun steps, CFG 5.0, with the launch counts checked.
     serve   - the prompt -> image path at random weights from the seed: the DFN5B
               CLIP-H text tower and the SDXL VAE (bf16 compute), a CLIP tokenizer
               over a BPE vocabulary the script learns into a temp dir; at 256px
               generate(prompt=[4 captions]) with the [slice] model -> (4, 3, 256,
               256) images in [0, 1], the same launch counts as the latents-only
               call, the time of each stage per image; one full-width T5-v1.1-XXL
               forward (4 x 120 ids with a mask, bf16).
  4. train   - the MicroDiT-XL stage-1 train step at full width and depth (mask
               0.75, microbatch 256, AdamW 2.4e-4 / wd 0.1 / clip 0.25, cosine with
               2500 warmup steps): one microbatch's loss and whole gradient through
               the kernels against the plain versions, then a warm-up step and
               timed steps with the launch counts checked, and a profiled step;
               then one further step traced with every module call named
               (utils/profiling.py module_scopes), its [attribution] tables: device
               time by op class and kernel name (scripts/trace_summary.py) and by
               model component, forward / recompute / backward (scripts/
               attribute_trace.py), busy + idle = the traced window, the buckets
               summing to the device ops' time.
  5. trainer - the XL stage-1 recipe through the port's entry point
               (train.cli.main with the H100 overlay: fused adaLN, remat 'full')
               on a seeded synthetic MDS latents dataset: 6 steps at batch 256 and
               one eval, the launch counts of all five kernels checked every step;
               the loader's reads counted through the native MDS gather, and one
               epoch-ordered batch read by the gather and by the memmap path,
               bitwise equal, with the MB/s of each from a warm and a cold page
               cache;
               then a warm-up and 3 bare make_train_step calls on the same state
               under the overlay's policy (median time, peak, profile; the
               trainer-vs-bare ratio).
  6. resume  - MicroDiT-Tiny through the entry point: 4 steps straight against 2
               steps, a checkpoint and an autoresume to 4; the parameters agree.
     dist    - the XL stage-1 recipe through train.cli.main --multihost in a
               one-rank NCCL group (the parallel layer: ZeRO-2 buckets, collectives
               of size 1) on the [trainer] set with the EMA on: 3 steps with an XL
               checkpoint at step 2, an autoresume from it in a fresh trainer
               bitwise equal to the straight run at step 3, the losses and grad
               norms equal to [trainer]'s within 1e-5, the launch counts, the save
               and load seconds, the file's bytes, the peaks; then 2 gloo ranks on
               this card (this script with --dist-rank): which collectives gloo takes
               on CUDA tensors and, where it takes all, one step of XL at full width,
               depth 4, at mesh (1, 2, 1) and (1, 1, 2) under remat 'full', and at
               (1, 1, 2) under 'attn_moe', each against one rank under its policy.
     stage2  - MicroDiT-XL stage 2 (256px, mask 0, mb 64, K = 4) through
               train.cli.main with the H100 overlay on the [trainer] set, as the
               overlay stands ('auto': K1, K2, K6) and with
               model.attention_impl=flash_bthd (K5 at every block attention site):
               4 steps and one eval each with the launch counts checked; under
               'auto' one microbatch's gradient under every remat policy against
               'full' and bare steps under each ('full', 'dots', 'attn_moe',
               'dots_attn_moe', the lean name; BARE_TIMED steps under the overlay's
               'full', profiled, BARE_TIMED_OTHER under each other, launches
               checked); under 'flash_bthd' one microbatch's loss and whole gradient
               through the kernels against the plain path, and bare steps.
  7. stage3  - MicroDiT-XL stage 3 (512px, mask 0.75, mb 32, K = 8, 'gather' with
               the expert-major kernel K3, fp32 EMA from step 2) through
               train.cli.main with the H100 overlay on a seeded synthetic 512px MDS
               set: 4 steps and one eval with the launch counts of every kernel
               checked, then bare steps under remat 'dots', the two lean names and
               'full' (peaks, times, launches; a profile under 'full', the overlay's
               policy); two calls of a 'gather' MoE layer are bitwise equal.
  8. stage4  - the same for stage 4 (mask 0, mb 16, K = 16), with [attribution]
               tables of one further bare step under 'full', as in phase 4, and one
               microbatch's loss and whole gradient through the kernels against the
               plain path.
     options - the trainer's options on the stage-4 trainer: bare steps under
               'full' with param_flow_dtype bfloat16 beside [stage4]'s unset ones,
               the same step otherwise (the in-state EMA included; time, peak, idle
               share, launches checked); after [sample512], XL stage 4 at batch 32
               through cli.main with the EMA in the state (fp32, from step 2) and
               at placement 'hostcompute' (from step 1): the parameters bitwise
               equal, the EMA within HC_EMA_TOL, the update's host times; an
               offloaded HostComputeEMA (smoothing 0.5, a step started after each
               update without waiting) bitwise equal to one decayed on the card; XL stage
               1 at the v5e stage-1 overlay's mb 128, K = 2, bf16 accumulator
               under accum_mode 'scan', 'dispatch' (bitwise equal) and 'dispatch'
               with param_flow_dtype bfloat16 (OPTIONS_FLOW_TOL), launches checked.
     sample512 - a 30-step CFG-5 generate() of 2 prompts at 512px with the stage-4
               model, launch counts checked; then generate(prompt=[2 captions]) ->
               (2, 3, 512, 512) with the same counts, one VAE encode of 2 seeded
               512px images, and one 512px decode in bf16 against fp32.
     eval    - the evaluation path at 512px with random weights from the seed: an XL
               model as the eval CLI builds it ('onehot', fused adaLN off,
               pos_interp_scale 2) with the CLIP-H text tower and the SDXL VAE through
               eval.generate_images (4 captions of configs/eval_prompts.yaml, one
               generate call, 30 steps, CFG 5) with the launch counts checked and the
               PNGs and manifest read back; K2 at the path's k = 256 against its plain
               version; InceptionV3 pool3 at full architecture (synthetic_params(0)):
               fp32 with TF32 off, and TF32 on, against the card's float64 forward, the
               feature rate; the FID CLI as a subprocess on the 4 images and 60 seeded
               stand-in real images, against the same FID in this process; a CLIP
               ViT-L/14 snapshot (random weights) through CLIPZeroShot, card vs CPU,
               the encode rate; the GenEval CLIP colour judge and scorer on the 4
               images; the FID-30K wall-clock estimate.
     precompute - the latent precompute through the port's precompute(): 128 seeded
               600 x 560 JPEGs in an image MDS -> caption latents (the CLIP-H text
               tower of [serve], bf16) and SDXL VAE latents at 256 and 512px (fp32
               compute with the [serve] VAE's weights, cuDNN TF32 on as the CLI runs),
               batch 32, rank 0 of 1: 128 written and 0 skipped, the merged index,
               every latent finite at its shape, the latents loader reading a batch
               at each size, one 256px encode on the card against the CPU (TF32 on
               and off), no DiT kernel launched; the rate over batches 2-4, ms per
               image of each stage, the peak, one more batch under the port's
               profile_trace (device-busy share) and the 37M-image estimate.
     prepare - raw files of six datasets in their own layouts (JDB archive and
               jsonl, cc12m tars, SA-1B captions, COCO annotations, DiffusionDB
               parquet, TextCaps samples) -> the port's download step and converters
               -> the port's precompute at 256px with the [serve] encoders -> the
               latents loader -> one MicroDiT-Tiny step through cli.main; the
               convert and precompute images/s.
  9. chain   - MicroDiT-Tiny through the stage handoffs: stage 2 (256px) saves,
               stage 3 loads its weights only across the pos_embed change (1024
               tokens) and saves, stage 4 loads stage 3's full state (bitwise
               equal to the save) and evaluates; the whole-K attention kernel K4
               runs at head_dim 32, forward and backward, with exact counts.
Every kernel is then checked against its plain version, and timed, at every shape
the phases recorded.

Prints each phase's wall time, a `kernels` JSON line and the card's name and
power limit before the last line, and as the last line {"ok": true, "device": {...}}. Exits non-zero,
printing no result, when there is no card or the package is not beside it.
Imports nothing of JAX.
"""

import collections
import contextlib
import importlib
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

SEED = 0
STEPS = 30    # Heun steps: 2 * 30 - 1 = 59 CFG-doubled DiT forwards
PROMPTS = 4   # x2 for CFG: batch 8 through the DiT
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_BYTES = 3.35e12      # H100 SXM HBM3
ATTN_TOL = 2e-2  # max |kernel - plain|, bf16 outputs of magnitude <~ 1: a few bf16 ulps
ATTN_REL_TOL = 2e-2  # and max |kernel - plain| / max |plain|: at T = 1024 the outputs
                     # are ~0.05 (max ~0.4): the absolute limit alone is 40% of a typical one
MOE_TOL = 2e-2   # same; one-ulp flips of bf16(a) between summation orders stay far below
SLICE_TOL = 3e-2  # relative L2 of the XL CFG forward, kernel vs plain path, after 34
                  # blocks of bf16 rounding that differs between the two paths
BWD_TOL = 1e-2  # max |kernel - plain| / max |plain| per gradient: dk, dv, dw are fp32
                # sums over many rows stored in bf16 (one ulp = 2^-8 of an entry)
TRAIN_LOSS_TOL = 1e-2  # relative, XL stage-1 loss of one microbatch, kernels vs plain
TRAIN_GRAD_TOL = 5e-2  # relative L2 of the whole flattened gradient, kernels vs plain:
                       # the forward's 34 blocks of differing bf16 rounding (rel L2
                       # ~1.5e-2 at the output) compound again through the backward
ATTN_REPLACES = "micro_diffusion_tpu/ops/flash_attention_lane.py:58"
MOE_REPLACES = "micro_diffusion_tpu/ops/moe_ffn.py:74"
ATTN_BWD_REPLACES = "micro_diffusion_tpu/ops/flash_attention_lane.py:80"
MOE_BWD_REPLACES = "micro_diffusion_tpu/ops/moe_ffn.py:124"
TRAIN_MB = 256  # the stage-1 recipe's per-device microbatch (res_256_pretrain.yaml:19)
TRAIN_STEPS = 3  # timed steps after the warm-up step
REMAT = True  # without block remat the mb-256 forward alone outgrows the 80 GB card
              # (77 GiB allocated when it ran out, H100 80GB HBM3)
ATTN_BWD_SHAPES = [  # (B, Tq, Tk, H): stage 1 at mb 256, then 512px
    (256, 77, 77, 16), (256, 256, 256, 12), (256, 256, 77, 12), (256, 64, 64, 8),
    (256, 64, 64, 10), (256, 64, 64, 12), (256, 64, 64, 14), (256, 64, 64, 16),
    (256, 64, 77, 16), (8, 1024, 1024, 16), (8, 1024, 77, 16),
]
MOE_BWD_SHAPES = [  # (n, e, k, d, f): stage-1 mixer, two backbone widths, 512px
    (256, 8, 64, 768, 3072), (256, 8, 16, 1024, 768), (256, 8, 16, 1024, 3840),
    (8, 8, 256, 1024, 3840),
]
ATTN_SHAPES = [  # (Tq, Tk, H) at B = 8 (4 prompts x CFG)
    (256, 256, 8), (256, 256, 12), (256, 256, 16), (256, 77, 12), (256, 77, 16),
    (77, 77, 16), (1024, 1024, 16), (1024, 77, 16),
]
MOE_SHAPES = [  # (k, d, f) at n = 8, e = 8
    (64, 768, 3072), (64, 1024, 768), (64, 1024, 3840), (256, 1024, 3840),
]
PEAK_FP32_FLOPS = 67e12   # H100 SXM fp32 outside the tensor cores (NVIDIA data sheet)
ADALN_REPLACES = "micro_diffusion_tpu/ops/adaln.py:22"
ADALN_TOL = 1e-2  # max |kernel - plain| / max |plain|: the one bf16 rounding of the
                  # output (2^-8 of an entry) with fp32 sums taken in another order
ADALN_SHAPES = [  # (B, T, D): XL stage 1 at mb 256 (mixer, backbone and final
                  # layer), the Tiny round trip at mb 16, XL 512px at mb 32
    (256, 256, 768), (256, 64, 1024), (16, 256, 512), (16, 64, 512), (32, 1024, 768),
]
TRAINER_STEPS = 6   # fit steps of the [trainer] phase, then one eval
TRAINER_SAMPLES = 1024  # synthetic train samples (166 KB each), 4 steps per epoch
EVAL_SAMPLES = 256
RESUME_BATCH, RESUME_MB = 32, 16  # Tiny round trip: K = 2 microbatches per step
RESUME_TOL = 1e-6  # relative L2 of all parameters, straight vs resumed
DIST_STEPS, DIST_SAVE_AT = 3, 2  # [dist]: XL stage-1 steps, the checkpoint resumed
DIST_EMA = 0.9999  # [dist] turns the EMA on (from step 1) so the checkpoint carries it
DIST_TOL = 1e-5  # relative: [dist]'s losses and grad norms against [trainer]'s, and
                 # the 2-rank gloo steps' against one rank's
DIST_B_DEPTH, DIST_B_BATCH, DIST_B_MB = 4, 64, 32  # [dist gloo]: XL width, 4 blocks
# (mesh, remat policy) of each 2-rank step: ZeRO-2, then expert parallelism under
# 'full' and under 'attn_moe' (which keeps the EC-MoE output; the recompute re-issues
# the sum over tensor), each against one rank under the same policy
DIST_B_RUNS = (((1, 2, 1), "full"), ((1, 1, 2), "full"), ((1, 1, 2), "attn_moe"))
DIST_B_PARAM_TOL = {  # relative L2 of all updated parameters together, 2 ranks vs one
    (1, 2, 1): 1e-6,  # ZeRO-2: the same microbatch gradients summed (bitwise here)
    # expert parallelism: the forward is bitwise (the loss too), but in the backward
    # each rank's input gradient of an EC-MoE block (its experts' and its gate
    # share's) is already rounded to bf16 before the ranks' fp32 sum, where one rank
    # rounds the whole sum; that difference flows into every layer before the
    # block, and Adam's first step turns each sign change of a near-zero gradient
    # entry into a move of up to 2 lr: 4.027e-5 on an H100 80GB HBM3 (700 W)
    (1, 1, 2): 1e-4,
}
# relative L2 of each gate and expert leaf's first moment (a tenth of its clipped
# gradient), 2 ranks vs one, leaf by leaf: a few bf16 roundings (2^-9 each) of
# partial sums; a share that is summed wrongly or not at all moves it by O(1)
DIST_B_MOE_GRAD_TOL = 1e-2
DIST_B_TIMEOUT_S, DIST_B_GROUP_TIMEOUT_S = 600, 300
EM_REPLACES = "micro_diffusion_tpu/ops/moe_ffn.py:439"      # _em_fwd (K3)
EM_BWD_REPLACES = "micro_diffusion_tpu/ops/moe_ffn.py:458"  # _em_bwd (K3 backward)
BH_REPLACES = "micro_diffusion_tpu/ops/flash_attention_bh.py:22"      # _fwd_kernel (K4)
BH_BWD_REPLACES = "micro_diffusion_tpu/ops/flash_attention_bh.py:48"  # _bwd_kernel
STAGE_STEPS = 4       # fit steps of [stage3] / [stage4], then one eval
STAGE_EMA_START = 2   # algorithms.ema.ema_start: the EMA decays from step 2 on
BARE_TIMED = 3        # bare steps timed under the overlay's remat policy, after a warm-up
BARE_TIMED_OTHER = 1  # the same under each other policy: its launches checked, one time
BARE_MICROBATCHES = 2  # microbatches of a [stage3]/[stage4] bare step
STAGE_SAMPLES, STAGE_EVAL_SAMPLES = 1024, 256  # 512px synthetic set (32 KB latents each)
SAMPLE512_PROMPTS = 2  # [sample512]: x2 for CFG, batch 4 through the DiT
CHAIN_BATCH = 64      # [chain] per-rank batch: K = 1 / 2 / 4 at stages 2 / 3 / 4
CHAIN_STEPS = 2       # steps per chain stage
FA_REPLACES = "micro_diffusion_tpu/ops/flash_attention.py:76"       # _fwd_kernel (K5)
FA_BWD_REPLACES = "micro_diffusion_tpu/ops/flash_attention.py:140"  # _dq_kernel, and
                                                                    # _dkv_kernel :172
# (B, Tq, Tk, H, D) at which K5 is checked beside the stage-2 path's shapes: XL 512px
# at mb 8, where the JAX kernels tile the sequences (4 chunks of 256), and the caption
# block's self-attention (which stays 'auto' in the DiT, so K1 runs it there)
FA_EXTRA_SHAPES = [(8, 1024, 1024, 16, 64), (8, 1024, 77, 16, 64), (64, 77, 77, 16, 64)]
LSE_TOL = 1e-3  # max |kernel - plain| of the fp32 row logsumexp: the same exponentials
                # summed in another order (online across key tiles) around values ~5
STAGE2_STEPS = 4  # fit steps of each [stage2] run (one epoch of the 1024-sample set)
REMAT_POLICIES = ("full", "dots", "attn_moe", "dots_attn_moe")
# the lean names of the 512px stages' bare steps, beside 'dots' and 'full'; stage 2 runs
# the last of them beside REMAT_POLICIES, with its gradient against 'full'
LEAN_POLICIES = ("dots_xlean_alean", "dots_attn_moe_xlean_alean")
RECIPE_BATCHES = (250000, 30000, 50000, 55000)  # batches of stages 1-4 (configs/res_*.yaml:
                                                # 250k, then to 280k, 50k, 55k more)
CLIP_NAME = "openclip:hf-hub:apple/DFN5B-CLIP-ViT-H-14-378"  # 49408 x 1024, 24 layers
T5_NAME = "DeepFloyd/t5-v1_1-xxl"  # d_model 4096, 24 layers, 64 heads, d_ff 10240
SERVE_CAPTIONS = [  # the prompts of the prompt -> image calls; also the BPE corpus
    "a photograph of an astronaut riding a horse on the moon",
    "a red fox sitting in the snow, watercolor painting",
    "two cups of coffee on a wooden table next to a window",
    "a futuristic city skyline at sunset, highly detailed, 4k",
]
BPE_MERGES = 200  # merges of the vocabulary the script learns (no released one here)
VAE_TOL = 3e-2  # relative L2 of a 512px decode, bf16 vs fp32 compute on the same weights
                # and latents: ~30 convolutions each round to bf16 (2^-8 of an entry);
                # 1.5e-2 at 64px on the CPU
ROOT = os.path.dirname(os.path.abspath(__file__))
OVERLAY = os.path.join(ROOT, "micro_diffusion_tpu_torch", "configs", "h100_1gpu")
PROMPTS_FILE = os.path.join(ROOT, "configs", "eval_prompts.yaml")  # the recipe's, cwd-free
EVAL_PROMPTS = 4  # [eval]: captions of PROMPTS_FILE, one generate call (batch 8 under CFG)
EVAL_REAL = 60    # seeded stand-ins for the real reference images of the FID CLI
FEATURE_BATCH = 64  # Inception feature rate: images per call after a warm-up
INCEPTION_TOL = 1e-4  # max |fp32 - float64| / max |float64| of the pool3 features, TF32
                      # off: ~95 convolutions in fp32 (2^-24 an operation) summed over
                      # up to 2048 x 3 x 3 inputs, far below it
CLIP_CPU_TOL = 1e-3  # relative L2 of CLIP image embeddings, card vs CPU, fp32 (TF32 off):
                     # 24 layers summed in other orders
FID_CLI_TOL = 2e-4  # |FID of the CLI - FID in this process|: the CLI prints 4 decimals,
                    # the features of the two processes agree to fp32 rounding
CLIP_L14 = {  # openai/clip-vit-large-patch14's widths (upstream GenEval's colour judge)
    "vision": {"image_size": 224, "patch_size": 14, "hidden_size": 1024,
               "num_hidden_layers": 24, "num_attention_heads": 16, "hidden_act": "quick_gelu"},
    "text": {"vocab_size": 49408, "hidden_size": 768, "num_hidden_layers": 12,
             "num_attention_heads": 12, "max_position_embeddings": 77,
             "hidden_act": "quick_gelu"},
    "projection_dim": 768,
}
PRECOMPUTE_IMAGES = 128  # [precompute]: 4 batches of 32 (the CLI's default batch)
PRECOMPUTE_BATCH = 32
PRECOMPUTE_SIZES = (256, 512)
PRECOMPUTE_WH = (600, 560)  # larger than 512 on both sides: both centre crops are real
TRAINING_IMAGES = 37e6  # the reference's training set, paid once (SURVEY.md §1, L6)
ENCODE_FP32_TOL = 1e-4  # relative L2 of a 256px SDXL encode_mode, card vs CPU, fp32 with
                        # TF32 off: ~25 convolutions summed in other orders (2^-24 an
                        # operation), far below it
ENCODE_TF32_TOL = 1e-2  # the same with cuDNN's TF32 on, as the CLI runs: each conv
                        # operand rounded to 10 mantissa bits (2^-11 of a value)
OPTIONS_STEPS = 2    # [options]: stage-1 fit steps under each accumulation mode
OPTIONS_MB = 128     # the v5e stage-1 overlay's microbatch: K = 2 of a 256 batch
OPTIONS_FLOW_TOL = 0.25  # param_flow_dtype bf16 against scan: |p_flow - p_scan| over
                     # |p_scan - p_init|, the bound JAX holds its flow run to
                     # (tests/test_train.py:1114-1116); bf16-rounded weights and grads
OPTIONS_LOSS_TOL = 1e-2  # relative, each step's loss under the flow against scan
HC_STEPS = 3         # [options] stage-4 fit steps of the EMA placement comparison
HC_BATCH = 32        # 2 microbatches of the stage-4 overlay's 16
HC_EMA_TOL = 3e-3    # relative L2, hostcompute EMA against an in_state fp32 EMA of the
                     # same trajectory: the placement's bf16 copy rounds each parameter's
                     # contribution by at most 2^-9 of it (JAX's documented numerics)
HC_CHECK_SMOOTHING = 0.5  # [options] offloaded HostComputeEMA against one on the card: each
                          # update halves the EMA's weight, so a skipped, doubled or stale
                          # decay moves every element that the steps moved
HC_CHECK_UPDATES = 3      # updates of that check, each followed at once by a bare step
ATTRIBUTION_STEP = "attributed step"  # the record_function scope around the step that
                                      # [attribution] traces: the tools' window
TRACE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "profile_trace",
                         "chip_smoke")  # the [attribution] traces, gzipped (git-ignored)
PREPARE_IMAGES = 16  # [prepare]: fixture images per dataset, six datasets
PREPARE_BATCH = 16   # the precompute's batch and the Tiny step's batch


def log(msg):
    print(msg, flush=True)


def smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    return out.splitlines()[0]


def time_ms(fn, iters=20, warmup=3):
    """Device time per call, by CUDA events around `iters` back-to-back calls. The
    stream is first held by a ~10 ms spin kernel so that the host enqueues every
    call before the first one runs: the events then time the device work alone,
    not the wrappers' Python overhead (which is part of the slice's wall time)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops, nbytes, peak_flops=PEAK_BF16_FLOPS):
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


# ---------------------------------------------------------------- kernels


def attn_case(tq, tk, h, gen, b=8, d=64):
    """q (B, Tq, H, D) contiguous; k and v strided views of one packed kv
    tensor, as the cross-attention path hands them to the kernel."""
    import torch

    q = torch.randn(b, tq, h, d, generator=gen, device="cuda").bfloat16()
    kv = torch.randn(b, tk, 2, h * d, generator=gen, device="cuda").bfloat16()
    k = kv[:, :, 0].view(b, tk, h, d)
    v = kv[:, :, 1].view(b, tk, h, d)
    return q, k, v


def moe_case(k, d, f, gen, n=8, e=8):
    import torch

    xg = torch.randn(n, e, k, d, generator=gen, device="cuda").bfloat16()
    w1 = (0.02 * torch.randn(e, d, f, generator=gen, device="cuda")).bfloat16()
    w2 = (0.02 * torch.randn(e, f, d, generator=gen, device="cuda")).bfloat16()
    return xg, w1, w2


def attn_flops_bytes(b, tq, tk, h):
    return 4 * b * h * tq * tk * 64, 2 * 2 * 64 * h * b * (tq + tk)


def moe_flops_bytes(n, e, k, d, f):
    return 4 * n * e * k * d * f, 2 * (2 * n * e * k * d + 2 * e * d * f)


def attn_bwd_flops_bytes(b, tq, tk, h):
    """5 products of 2*B*H*Tq*Tk*64; q, do read and dq written (Tq rows), k, v read
    and dk, dv written (Tk rows), bf16."""
    return 5 * 2 * b * h * tq * tk * 64, 2 * 64 * h * b * (3 * tq + 4 * tk)


def moe_bwd_flops_bytes(n, e, k, d, f):
    """The 4 gradient products and the recompute of a; x, do read and dx written,
    w1, w2 read and dw1, dw2 written, bf16."""
    return 5 * 2 * n * e * k * d * f, 2 * (3 * n * e * k * d + 4 * e * d * f)


def adaln_flops_bytes(b, t, d):
    """About 10 fp32 operations per element (the two statistics, normalise, weight,
    modulate); x read and out written in bf16, shift and scale read once, the fp32
    weight once."""
    return 10 * b * t * d, 2 * 2 * b * t * d + 2 * 2 * b * d + 4 * d


def em_flops_bytes(e, m, d, f):
    """K3 forward: moe_flops_bytes on expert-major rows (n*k = m)."""
    return moe_flops_bytes(1, e, m, d, f)


def em_bwd_flops_bytes(e, m, d, f):
    return moe_bwd_flops_bytes(1, e, m, d, f)


def bh_flops_bytes(b, tq, tk, h, d):
    """K4 forward: 2 products of 2*B*H*Tq*Tk*D; q, k, v read and out written, bf16."""
    return 4 * b * h * tq * tk * d, 2 * d * h * b * (2 * tq + 2 * tk)


def bh_bwd_flops_bytes(b, tq, tk, h, d):
    """K4 backward: 5 products; q, do read and dq written, k, v read and dk, dv
    written, bf16."""
    return 5 * 2 * b * h * tq * tk * d, 2 * d * h * b * (3 * tq + 4 * tk)


def fa_flops_bytes(b, tq, tk, h, d):
    """K5 forward: 2 products of 2*B*H*Tq*Tk*D; q, k, v read, out and the fp32
    logsumexp written."""
    return 4 * b * h * tq * tk * d, 2 * d * h * b * (2 * tq + 2 * tk) + 4 * b * h * tq


def fa_bwd_flops_bytes(b, tq, tk, h, d):
    """K5 backward: the function's 5 products; q, do, out and lse read and dq
    written (Tq rows), k, v read and dk, dv written (Tk rows), bf16."""
    return 5 * 2 * b * h * tq * tk * d, 2 * d * h * b * (4 * tq + 4 * tk) + 4 * b * h * tq


def rel_err(got, ref):
    return ((got.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


def attn_errs(out, ref, what):
    """Max abs and max relative error of an attention forward, each held to its limit."""
    err = (out.float() - ref.float()).abs().max().item()
    rel = rel_err(out, ref)
    if not (math.isfinite(err) and err <= ATTN_TOL and rel <= ATTN_REL_TOL):
        raise AssertionError(f"{what}: max abs err {err} (limit {ATTN_TOL}), relative "
                             f"{rel} (limit {ATTN_REL_TOL})")
    return err, rel


def check_attention(shape, gen, b=8):
    import torch
    import torch.nn.functional as F
    fal = importlib.import_module("micro_diffusion_tpu_torch.ops.flash_attention_lane")

    tq, tk, h = shape
    q, k, v = attn_case(tq, tk, h, gen, b)
    out = fal.flash_attention_lane(q, k, v)
    torch.cuda.synchronize()
    ref = fal.flash_attention_lane_plain(q, k, v)
    err, rel = attn_errs(out, ref, f"attention {shape}")
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    ms = time_ms(lambda: fal.flash_attention_lane(q, k, v))
    plain_ms = time_ms(lambda: fal.flash_attention_lane_plain(q, k, v), iters=5)
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt))
    bound_ms, by = bound(*attn_flops_bytes(b, tq, tk, h))
    return dict(B=b, Tq=tq, Tk=tk, H=h, max_abs_err=err, max_rel_err=rel, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by, library_ms=lib_ms)


def check_moe(shape, gen, n=8, e=8):
    import torch
    mf = importlib.import_module("micro_diffusion_tpu_torch.ops.moe_ffn")

    k, d, f = shape
    xg, w1, w2 = moe_case(k, d, f, gen, n, e)
    out = mf.moe_ffn(xg, w1, w2)
    torch.cuda.synchronize()
    ref = mf.moe_ffn_plain(xg, w1, w2)
    err = (out.float() - ref.float()).abs().max().item()
    if not (math.isfinite(err) and err <= MOE_TOL):
        raise AssertionError(f"moe_ffn {shape}: max abs err {err} > {MOE_TOL}")
    ms = time_ms(lambda: mf.moe_ffn(xg, w1, w2))
    plain_ms = time_ms(lambda: mf.moe_ffn_plain(xg, w1, w2), iters=5)
    chain_ms = time_ms(lambda: mf._moe_ffn_ref(xg, w1, w2))
    bound_ms, by = bound(*moe_flops_bytes(n, e, k, d, f))
    return dict(n=n, e=e, k=k, d=d, f=f, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=by, library_ms=None, library_chain_ms=chain_ms)


def moe_bwd_row(bwd, plain, chain, xg, w1, w2, do, iters, what):
    """A MoE backward (``bwd``) against its plain version at BWD_TOL and bitwise
    equal across two calls; its time, the plain version's, and the library chain's
    (``chain``: bmm -> GELU -> bmm through autograd) on the same inputs."""
    import torch

    got = bwd(xg, w1, w2, do)
    again = bwd(xg, w1, w2, do)
    torch.cuda.synchronize()
    deterministic = all(torch.equal(g, a) for g, a in zip(got, again))
    ref = plain(xg, w1, w2, do)
    errs = [rel_err(g, r) for g, r in zip(got, ref)]
    if not (deterministic and all(math.isfinite(e_) and e_ <= BWD_TOL for e_ in errs)):
        raise AssertionError(f"{what}: rel errs (dx, dw1, dw2) {errs} > {BWD_TOL} or two "
                             f"calls differ (bitwise equal: {deterministic})")
    err = max((g.float() - r.float()).abs().max().item() for g, r in zip(got, ref))
    del got, again, ref
    ms = time_ms(lambda: bwd(xg, w1, w2, do), iters=iters)
    plain_ms = time_ms(lambda: plain(xg, w1, w2, do), iters=2, warmup=1)
    leaves = [t.detach().requires_grad_() for t in (xg, w1, w2)]
    out = chain(*leaves)
    chain_ms = time_ms(lambda: torch.autograd.grad(out, leaves, do, retain_graph=True),
                       iters=iters)
    return dict(max_abs_err=err, max_rel_err=max(errs), bitwise_repeatable=deterministic,
                ms=ms, plain_ms=plain_ms, library_ms=None, library_chain_ms=chain_ms)


def attn_bwd_row(mod, bwd, plain, shape, gen, iters):
    """K1b or K4b (``bwd``, module ``mod``) at one (B, Tq, Tk, H, D) shape, from the
    kernel forward's out and row statistics: against the plain version of the same
    function (``plain``, delta from (do, out)) at BWD_TOL, bitwise equal across two
    calls, and its deviation from the exact contract (``flash_attention_lane_bwd_plain``,
    delta = rowsum(e * dp) * inv_l) logged. The backward alone is timed; SDPA's
    backward on the same inputs is the library yardstick."""
    import torch
    import torch.nn.functional as F
    fal = importlib.import_module("micro_diffusion_tpu_torch.ops.flash_attention_lane")

    b, tq, tk, h, d = shape
    q, k, v = attn_case(tq, tk, h, gen, b, d)
    do = torch.randn(b, tq, h, d, generator=gen, device="cuda").bfloat16()
    out, stats = mod._forward_stats(q, k, v, d**-0.5)
    got = bwd(q, k, v, out, stats, do)
    again = bwd(q, k, v, out, stats, do)
    torch.cuda.synchronize()
    deterministic = all(torch.equal(g, a) for g, a in zip(got, again))
    ref = plain(q, k, v, out, stats, do)
    errs = [rel_err(g, r) for g, r in zip(got, ref)]
    if not (deterministic and all(math.isfinite(e) and e <= BWD_TOL for e in errs)):
        raise AssertionError(f"{bwd.__name__} {shape}: rel errs (dq, dk, dv) {errs} > "
                             f"{BWD_TOL} or two calls differ (bitwise equal: {deterministic})")
    err = max((g.float() - r.float()).abs().max().item() for g, r in zip(got, ref))
    dev = [rel_err(g, r) for g, r in zip(got, fal.flash_attention_lane_bwd_plain(q, k, v, do))]
    del got, again, ref
    ms = time_ms(lambda: bwd(q, k, v, out, stats, do), iters=iters)
    plain_ms = time_ms(lambda: plain(q, k, v, out, stats, do), iters=3, warmup=1)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    sdpa = F.scaled_dot_product_attention(qt, kt, vt)
    dot = do.transpose(1, 2)
    lib_ms = time_ms(lambda: torch.autograd.grad(sdpa, (qt, kt, vt), dot, retain_graph=True),
                     iters=iters)
    return dict(max_abs_err=err, max_rel_err=max(errs), exact_contract_rel_err=dev,
                bitwise_repeatable=deterministic, ms=ms, plain_ms=plain_ms,
                library_ms=lib_ms)


def check_attention_bwd(shape, gen):
    fal = importlib.import_module("micro_diffusion_tpu_torch.ops.flash_attention_lane")

    b, tq, tk, h = shape
    r = attn_bwd_row(fal, fal.flash_attention_lane_bwd, fal.flash_attention_lane_bwd_saved_plain,
                     (b, tq, tk, h, 64), gen, iters=20)
    bound_ms, by = bound(*attn_bwd_flops_bytes(b, tq, tk, h))
    return dict(B=b, Tq=tq, Tk=tk, H=h, **r, bound_ms=bound_ms, bound_by=by)


def check_moe_bwd(shape, gen):
    import torch
    mf = importlib.import_module("micro_diffusion_tpu_torch.ops.moe_ffn")

    n, e, k, d, f = shape
    xg, w1, w2 = moe_case(k, d, f, gen, n, e)
    do = torch.randn(n, e, k, d, generator=gen, device="cuda").bfloat16()
    r = moe_bwd_row(mf.moe_ffn_bwd, mf.moe_ffn_bwd_plain, mf._moe_ffn_ref, xg, w1, w2, do,
                    10, f"moe_ffn backward {shape}")
    bound_ms, by = bound(*moe_bwd_flops_bytes(n, e, k, d, f))
    return dict(n=n, e=e, k=k, d=d, f=f, **r, bound_ms=bound_ms, bound_by=by)


def check_adaln(shape, gen):
    """K6 against its plain version, with shift/scale as the strided chunks of one
    (B, 6D) projection (as the DiT block hands them over), with and without the
    weight."""
    import torch
    ad = importlib.import_module("micro_diffusion_tpu_torch.ops.adaln")

    b, t, d = shape
    x = torch.randn(b, t, d, generator=gen, device="cuda").bfloat16()
    mod = (0.5 * torch.randn(b, 6 * d, generator=gen, device="cuda")).bfloat16()
    shift, scale = mod.chunk(6, dim=1)[:2]
    w = 1.0 + 0.1 * torch.randn(d, generator=gen, device="cuda")
    errs = []
    for weight in (w, None):
        out = ad.layernorm_modulate(x, weight, shift, scale)
        torch.cuda.synchronize()
        ref = ad.layernorm_modulate_plain(x, weight, shift, scale)
        errs.append((rel_err(out, ref), (out.float() - ref.float()).abs().max().item()))
    if not all(math.isfinite(e) and e <= ADALN_TOL for e, _ in errs):
        raise AssertionError(f"layernorm_modulate {shape}: rel errs (weight, none) "
                             f"{[e for e, _ in errs]} > {ADALN_TOL}")
    ms = time_ms(lambda: ad.layernorm_modulate(x, w, shift, scale))
    plain_ms = time_ms(lambda: ad.layernorm_modulate_plain(x, w, shift, scale), iters=5)
    bound_ms, by = bound(*adaln_flops_bytes(b, t, d), peak_flops=PEAK_FP32_FLOPS)
    return dict(B=b, T=t, D=d, max_abs_err=max(a for _, a in errs),
                max_rel_err=max(e for e, _ in errs), ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=by, library_ms=None)


def check_em(shape, gen):
    """K3 forward against its plain version at one expert-major (e, m, d, f) shape."""
    import torch
    mf = importlib.import_module("micro_diffusion_tpu_torch.ops.moe_ffn")

    e, m, d, f = shape
    xg, w1, w2 = moe_case(m, d, f, gen, n=1, e=e)
    xg = xg[0]
    out = mf.moe_ffn_expert_major(xg, w1, w2)
    torch.cuda.synchronize()
    ref = mf.moe_ffn_expert_major_plain(xg, w1, w2)
    err = (out.float() - ref.float()).abs().max().item()
    if not (math.isfinite(err) and err <= MOE_TOL):
        raise AssertionError(f"moe_ffn_expert_major {shape}: max abs err {err} > {MOE_TOL}")
    ms = time_ms(lambda: mf.moe_ffn_expert_major(xg, w1, w2), iters=10)
    plain_ms = time_ms(lambda: mf.moe_ffn_expert_major_plain(xg, w1, w2), iters=3, warmup=1)
    chain_ms = time_ms(lambda: mf._moe_ffn_em_ref(xg, w1, w2), iters=10)
    bound_ms, by = bound(*em_flops_bytes(e, m, d, f))
    return dict(e=e, m=m, d=d, f=f, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=by, library_ms=None, library_chain_ms=chain_ms)


def check_em_bwd(shape, gen):
    """K3's backward against its plain version at one (e, m, d, f) shape."""
    import torch
    mf = importlib.import_module("micro_diffusion_tpu_torch.ops.moe_ffn")

    e, m, d, f = shape
    xg, w1, w2 = moe_case(m, d, f, gen, n=1, e=e)
    xg = xg[0]
    do = torch.randn(e, m, d, generator=gen, device="cuda").bfloat16()
    r = moe_bwd_row(mf.moe_ffn_expert_major_bwd, mf.moe_ffn_expert_major_bwd_plain,
                    mf._moe_ffn_em_ref, xg, w1, w2, do, 5,
                    f"moe_ffn_expert_major backward {shape}")
    bound_ms, by = bound(*em_bwd_flops_bytes(e, m, d, f))
    return dict(e=e, m=m, d=d, f=f, **r, bound_ms=bound_ms, bound_by=by)


def check_bh(shape, gen):
    """K4 forward against its plain version at one (B, Tq, Tk, H, D) shape; SDPA's
    time on the same inputs as the library yardstick."""
    import torch
    import torch.nn.functional as F
    bh = importlib.import_module("micro_diffusion_tpu_torch.ops.flash_attention_bh")

    b, tq, tk, h, d = shape
    q, k, v = attn_case(tq, tk, h, gen, b, d)
    out = bh.flash_attention_bh(q, k, v)
    torch.cuda.synchronize()
    ref = bh.flash_attention_bh_plain(q, k, v)
    err, rel = attn_errs(out, ref, f"flash_attention_bh {shape}")
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    ms = time_ms(lambda: bh.flash_attention_bh(q, k, v), iters=10)
    plain_ms = time_ms(lambda: bh.flash_attention_bh_plain(q, k, v), iters=3, warmup=1)
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), iters=10)
    bound_ms, by = bound(*bh_flops_bytes(b, tq, tk, h, d))
    return dict(B=b, Tq=tq, Tk=tk, H=h, D=d, max_abs_err=err, max_rel_err=rel, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by, library_ms=lib_ms)


def check_bh_bwd(shape, gen):
    """K4's backward against its plain version; SDPA's backward as the yardstick."""
    bh = importlib.import_module("micro_diffusion_tpu_torch.ops.flash_attention_bh")

    b, tq, tk, h, d = shape
    r = attn_bwd_row(bh, bh.flash_attention_bh_bwd, bh.flash_attention_bh_bwd_saved_plain,
                     shape, gen, iters=5)
    bound_ms, by = bound(*bh_bwd_flops_bytes(b, tq, tk, h, d))
    return dict(B=b, Tq=tq, Tk=tk, H=h, D=d, **r, bound_ms=bound_ms, bound_by=by)


def check_fa(shape, gen):
    """K5 forward (out and the row logsumexp) and backward against their plain
    versions at one (B, Tq, Tk, H, D) shape, the backward on the kernel's own out
    and lse and bitwise equal across two calls; SDPA forward and backward on the
    same inputs as the yardsticks. Returns the forward and the backward row."""
    import torch
    import torch.nn.functional as F
    fa = importlib.import_module("micro_diffusion_tpu_torch.ops.flash_attention")

    b, tq, tk, h, d = shape
    scale = d**-0.5
    q, k, v = attn_case(tq, tk, h, gen, b, d)
    do = torch.randn(b, tq, h, d, generator=gen, device="cuda").bfloat16()
    out, lse = fa._forward(q, k, v, scale)
    got = fa.flash_attention_bwd(q, k, v, out, lse, do)
    again = fa.flash_attention_bwd(q, k, v, out, lse, do)
    torch.cuda.synchronize()
    deterministic = all(torch.equal(g, a) for g, a in zip(got, again))
    ref, ref_lse = fa.flash_attention_plain(q, k, v)
    err, rel = attn_errs(out, ref, f"flash_attention {shape}")
    lse_err = (lse - ref_lse).abs().max().item()
    if not (math.isfinite(lse_err) and lse_err <= LSE_TOL):
        raise AssertionError(f"flash_attention {shape}: lse max abs err {lse_err} > {LSE_TOL}")
    ref_g = fa.flash_attention_bwd_plain(q, k, v, out, lse, do)
    errs = [rel_err(g, r) for g, r in zip(got, ref_g)]
    if not (deterministic and all(math.isfinite(e) and e <= BWD_TOL for e in errs)):
        raise AssertionError(f"flash_attention backward {shape}: rel errs (dq, dk, dv) "
                             f"{errs} > {BWD_TOL} or two calls differ (bitwise equal: "
                             f"{deterministic})")
    bwd_err = max((g.float() - r.float()).abs().max().item() for g, r in zip(got, ref_g))
    del got, again, ref, ref_lse, ref_g
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    fwd = dict(B=b, Tq=tq, Tk=tk, H=h, D=d, max_abs_err=err, max_rel_err=rel,
               lse_max_abs_err=lse_err,
               ms=time_ms(lambda: fa._forward(q, k, v, scale), iters=10),
               plain_ms=time_ms(lambda: fa.flash_attention_plain(q, k, v), iters=3, warmup=1),
               library_ms=time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), iters=10))
    fwd["bound_ms"], fwd["bound_by"] = bound(*fa_flops_bytes(b, tq, tk, h, d))
    qg, kg, vg = (x.detach().requires_grad_() for x in (qt, kt, vt))
    sdpa = F.scaled_dot_product_attention(qg, kg, vg)
    dot = do.transpose(1, 2)
    bwd = dict(B=b, Tq=tq, Tk=tk, H=h, D=d, max_abs_err=bwd_err, max_rel_err=max(errs),
               bitwise_repeatable=deterministic,
               ms=time_ms(lambda: fa.flash_attention_bwd(q, k, v, out, lse, do), iters=5),
               plain_ms=time_ms(lambda: fa.flash_attention_bwd_plain(q, k, v, out, lse, do),
                                iters=2, warmup=1),
               library_ms=time_ms(lambda: torch.autograd.grad(sdpa, (qg, kg, vg), dot,
                                                              retain_graph=True), iters=5))
    bwd["bound_ms"], bwd["bound_by"] = bound(*fa_bwd_flops_bytes(b, tq, tk, h, d))
    return fwd, bwd


# ------------------------------------------------------------------ slice


@contextlib.contextmanager
def plain_kernels():
    """Route the model's kernel call sites (K1, K4, K5, K2, K3, K6) to the kernels'
    plain versions, forward and backward (the plain backwards run in the autograd
    Functions)."""
    from micro_diffusion_tpu_torch.models import layers
    from micro_diffusion_tpu_torch.ops import attention

    fal = importlib.import_module("micro_diffusion_tpu_torch.ops.flash_attention_lane")
    bh = importlib.import_module("micro_diffusion_tpu_torch.ops.flash_attention_bh")
    fa = importlib.import_module("micro_diffusion_tpu_torch.ops.flash_attention")
    mf = importlib.import_module("micro_diffusion_tpu_torch.ops.moe_ffn")
    ad = importlib.import_module("micro_diffusion_tpu_torch.ops.adaln")
    sites = [(attention, "flash_attention_lane", fal.flash_attention_lane_reference),
             (attention, "flash_attention_bh", bh.flash_attention_bh_reference),
             (attention, "flash_attention", fa.flash_attention_reference),
             (layers, "moe_ffn", mf.moe_ffn_reference),
             (layers, "moe_ffn_expert_major", mf.moe_ffn_expert_major_reference),
             (layers, "layernorm_modulate", ad.layernorm_modulate_reference)]
    saved = [getattr(mod, name) for mod, name, _ in sites]
    for mod, name, plain in sites:
        setattr(mod, name, plain)
    try:
        yield
    finally:
        for (mod, name, _), fn in zip(sites, saved):
            setattr(mod, name, fn)


def attn_route(impl, h, d, tq):
    """The card's attention dispatch (ops/attention.py) for ``impl``: under 'auto'
    K1 where the lane kernel applies (head_dim 64, even H), else K4 at Tq >= 512,
    else the plain path (no kernel); 'flash_bthd' K5 everywhere."""
    lane_ok = d == 64 and h % 2 == 0
    if impl == "auto":
        impl = "flash_lane" if lane_ok else ("flash" if tq >= 512 else "xla")
    elif impl == "pallas":
        impl = "flash"
    if impl == "flash":
        impl = "flash_lane" if lane_ok else "flash_bh"
    return {"flash_lane": "attention", "flash_bh": "bh", "flash_bthd": "fa"}.get(impl)


BWD_OF = {"attention": "attention_bwd", "bh": "bh_bwd", "fa": "fa_bwd", "moe": "moe_bwd",
          "em": "em_bwd"}


class PathRecord:
    """The kernel calls of the forwards run under ``record_path``, by kernel and
    shape (K1 (B, Tq, Tk, H), K4 and K5 (B, Tq, Tk, H, D), K2 (n, e, k, d, f), K3
    (e, m, d, f), K6 (B, T, D)), those of them outside the remat blocks (the
    caption block's attention, the final layer's adaLN) and the cross-attention's."""

    def __init__(self):
        kinds = ("attention", "bh", "fa", "moe", "em", "adaln")
        self.shapes = {k: collections.Counter() for k in kinds}
        self.outside = {k: collections.Counter() for k in kinds}
        self.cross = {k: collections.Counter() for k in kinds}

    def calls(self):
        return {k: sum(c.values()) for k, c in self.shapes.items()}

    def step_shapes(self, kind, microbatches, backward=False, kept=()):
        """Launches by shape of a train step of ``microbatches`` microbatches under
        per-block remat: a block's kernel calls run twice forward (the backward
        re-runs the block) and once backward; the calls outside the blocks once
        each way, and so do the attention calls in the blocks whose outputs the
        remat policy keeps (``kept``: 'attn_out' self-attention, 'xattn_out'
        cross-attention)."""
        def forward(shape, n):
            once = self.outside[kind][shape]
            if kind in ("attention", "bh", "fa"):
                cross = self.cross[kind][shape]
                once += (cross if "xattn_out" in kept else 0) + (
                    n - self.outside[kind][shape] - cross if "attn_out" in kept else 0)
            return 2 * n - once

        return collections.Counter({
            shape: microbatches * (n if backward else forward(shape, n))
            for shape, n in self.shapes[kind].items()})

    def step_launches(self, microbatches, kept=()):
        """Launches of a train step, the outputs named in ``kept`` kept (step_shapes)."""
        want = launch_dict()
        for kind in self.shapes:
            want[kind] = sum(self.step_shapes(kind, microbatches, kept=kept).values())
            if kind in BWD_OF:
                want[BWD_OF[kind]] = sum(self.step_shapes(kind, microbatches, True).values())
        return want

    def forward_launches(self, forwards):
        """Launches of ``forwards`` forwards without gradients (eval, sampling)."""
        return launch_dict(**{k: forwards * n for k, n in self.calls().items()})


@contextlib.contextmanager
def record_path(dit):
    """Record the kernel calls of the forwards run inside the block through forward
    pre-hooks, routed as the card routes them."""
    from micro_diffusion_tpu_torch.models import layers

    mf = importlib.import_module("micro_diffusion_tpu_torch.ops.moe_ffn")
    rec = PathRecord()
    outside = {id(dit.y_emb_preprocess.attn), id(dit.final_layer.norm_final)}

    def add(kind, key, mod, cross=False):
        if kind is not None:
            rec.shapes[kind][key] += 1
            rec.outside[kind][key] += id(mod) in outside
            rec.cross[kind][key] += cross

    def on_attn(mod, tq, tk, b, cross=False):
        h = mod.num_heads
        d = mod.hidden // h
        kind = attn_route(mod.attn_impl, h, d, tq)
        add(kind, (b, tq, tk, h) if kind == "attention" else (b, tq, tk, h, d), mod, cross)

    def on_self(mod, args):
        on_attn(mod, args[0].shape[1], args[0].shape[1], args[0].shape[0])

    def on_cross(mod, args):
        on_attn(mod, args[0].shape[1], args[1].shape[-2], args[0].shape[0], cross=True)

    def on_moe(mod, args):
        n, t, d = args[0].shape
        e, f = mod.num_experts, mod.w1.shape[-1]
        k = int(mod.expert_capacity * t / e)
        if mod.dispatch in ("onehot", "hybrid") and mf.supported(n, e, k, d, f):
            add("moe", (n, e, k, d, f), mod)
        elif mod.dispatch == "gather" and mf.supported_expert_major(n * k, d, f):
            add("em", (e, n * k, d, f), mod)

    def on_norm(mod, args):
        if len(args) > 1 and args[1] is not None:  # called with (shift, scale)
            add("adaln", tuple(args[0].shape), mod)

    hooks = []
    for mod in dit.modules():
        if isinstance(mod, layers.LayerNorm) and mod.fused_adaln:
            hooks.append(mod.register_forward_pre_hook(on_norm))
        elif isinstance(mod, layers.SelfAttention):
            hooks.append(mod.register_forward_pre_hook(on_self))
        elif isinstance(mod, layers.CrossAttention):
            hooks.append(mod.register_forward_pre_hook(on_cross))
        elif isinstance(mod, layers.FeedForwardECMoe):
            hooks.append(mod.register_forward_pre_hook(on_moe))
    try:
        yield rec
    finally:
        for hk in hooks:
            hk.remove()


def perturb_zero_init(module, gen, std=0.02):
    """Give the zero-initialised layers (adaLN, final layer, prompt-block output
    projections) random values: with them at zero every block is the identity and
    a kernel-versus-plain comparison proves nothing."""
    import torch

    with torch.no_grad():
        for p in module.parameters():
            if not p.any():
                p.normal_(0.0, std, generator=gen)


def run_slice(steps, prompts, enc):
    import torch
    from micro_diffusion_tpu_torch.models.diffusion import create_latent_diffusion

    fal = importlib.import_module("micro_diffusion_tpu_torch.ops.flash_attention_lane")
    mf = importlib.import_module("micro_diffusion_tpu_torch.ops.moe_ffn")

    t0 = time.perf_counter()
    model = create_latent_diffusion(dit_arch="MicroDiT_XL_2", latent_res=32,
                                    device="cuda", seed=SEED)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    perturb_zero_init(model.dit, gen)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.dit.parameters())
    log(f"[slice] MicroDiT-XL built on cuda: {n_params} params, "
        f"{time.perf_counter() - t0:.1f} s")

    y = torch.randn(prompts, 77, 1024, generator=gen, device="cuda")
    x = torch.randn(prompts, 4, 32, 32, generator=gen, device="cuda")
    sigma = torch.full((1,), 2.5, device="cuda")
    with torch.no_grad(), record_path(model.dit) as rec:
        out_k = model.model_forward_wrapper(x, sigma, y, cfg=5.0)["sample"]
    attn_shapes, moe_shapes = rec.shapes["attention"], rec.shapes["moe"]
    with torch.no_grad(), plain_kernels():
        out_p = model.model_forward_wrapper(x, sigma, y, cfg=5.0)["sample"]
    torch.cuda.synchronize()
    rel = ((out_k - out_p).norm() / out_p.norm()).item()
    finite = bool(torch.isfinite(out_k).all())
    log(f"[slice] XL CFG forward, kernels vs plain: rel L2 {rel:.3e} (tol {SLICE_TOL}), "
        f"finite {finite}")
    if not (finite and rel <= SLICE_TOL):
        raise AssertionError(f"XL CFG forward: kernels vs plain rel L2 {rel}")

    # per XL forward: 1 caption self-attention + (6 mixer + 28 backbone) blocks x
    # (self + cross) = 69 attention calls; MoE in mixer blocks 1,3,5 and backbone
    # blocks 1,3,...,25 = 16 calls
    per_fwd = (sum(attn_shapes.values()), sum(moe_shapes.values()))
    if per_fwd != (69, 16):
        raise AssertionError(f"XL forward ran {per_fwd} attention/MoE calls, not (69, 16)")
    want_attn, want_moe = (2 * steps - 1) * 69, (2 * steps - 1) * 16
    fal.flash_attention_lane.launches = 0
    mf.moe_ffn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    latents = model.generate(text_embeddings=y, guidance_scale=5.0,
                             num_inference_steps=steps, seed=SEED,
                             return_only_latents=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"attention": fal.flash_attention_lane.launches,
                "moe": mf.moe_ffn.launches}
    log(f"[slice] generate: {prompts} prompts, {steps} Heun steps, CFG 5.0: "
        f"{wall * 1e3:.1f} ms, {wall * 1e3 / prompts:.2f} ms/image, "
        f"{prompts / wall:.3f} img/s (256px); launches {launches}, "
        f"expected attention {want_attn} moe {want_moe}")
    if tuple(latents.shape) != (prompts, 4, 32, 32):
        raise AssertionError(f"latents shape {tuple(latents.shape)}")
    if not bool(torch.isfinite(latents).all()):
        raise AssertionError("latents not finite")
    if launches["attention"] != want_attn or launches["moe"] != want_moe:
        raise AssertionError(f"launch counts {launches} != {want_attn}, {want_moe}")
    # the same sampler behind the prompt -> image path: the same launches. Before the
    # profiled forward, as the latents-only call, so that the two rates compare: the
    # host-bound sampler ran slower once torch.profiler had traced a forward (PERF.md §5)
    serve = prompt_generate(model, enc, SERVE_CAPTIONS[:prompts], steps,
                            launch_dict(attention=want_attn, moe=want_moe), "[serve 256px]")
    del serve["latents"]
    profile_forward(model, x, sigma, y)
    return dict(attn_shapes=attn_shapes, moe_shapes=moe_shapes, launches=launches,
                rel_l2=rel, sampler_ms=wall * 1e3, img_per_s=prompts / wall,
                latents_std=latents.float().std().item(), serve=serve)


def profile_forward(model, x, sigma, y, top=12, label="XL CFG forward (B=8)"):
    """One XL CFG forward (one sampler step's DiT call) under torch.profiler: wall
    time, the device's busy time (sum of kernel durations on the one stream) and
    idle share, and the kernels that take the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def fwd():
        with torch.no_grad():
            model.model_forward_wrapper(x, sigma, y, cfg=5.0)
        torch.cuda.synchronize()

    fwd()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fwd()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy <= 0:
        log(f"[profile] {label} wall {wall:.2f} ms; device time not measured "
            "(the profiler saw no kernels)")
        return
    log(f"[profile] {label}: wall {wall:.2f} ms, device busy {busy:.2f} ms, "
        f"idle share {1 - busy / wall:.3f}, {sum(e.count for e in kernels)} kernel launches")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        log(f"[profile]   {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:<5d} "
            f"{e.key[:110]}")


# ------------------------------------------------------------------ serve


class StageTimes:
    """Times the prompt -> image stages of one ``generate`` call (tokenize, text
    encode, sampler, VAE decode): each wrapped call runs between
    torch.cuda.synchronize() boundaries; keeps the sampler's latents."""

    def __init__(self, model):
        self.sites = [(model.tokenizer, "tokenize", "tokenize"),
                      (model.text_encoder, "encode", "text_encode"),
                      (model, "edm_sampler_loop", "sampler"), (model.vae, "decode", "decode")]
        self.ms = {stage: 0.0 for _, _, stage in self.sites}
        self.latents = None

    def _wrap(self, fn, stage):
        import torch

        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            self.ms[stage] += (time.perf_counter() - t0) * 1e3
            if stage == "sampler":
                self.latents = out
            return out
        return timed

    def __enter__(self):
        for obj, name, stage in self.sites:
            setattr(obj, name, self._wrap(getattr(obj, name), stage))
        return self

    def __exit__(self, *exc):
        for obj, name, _ in self.sites:
            delattr(obj, name)  # the instance's wrapper; the class's method is back


def build_encoders(tok_dir):
    """The DFN5B CLIP-H text tower (bf16 compute) and the SDXL VAE (128/256/512/512,
    2 layers a block, 4 latent channels, bf16 compute as the factory gives it) at
    random weights from the script's seed, and a CLIP tokenizer over a BPE
    vocabulary learned from SERVE_CAPTIONS into ``tok_dir``."""
    import torch
    from micro_diffusion_tpu_torch.models.text_encoders import (UniversalTextEncoder,
                                                                UniversalTokenizer)
    from micro_diffusion_tpu_torch.models.vae import AutoencoderKL
    from micro_diffusion_tpu_torch.utils.clip_bpe import write_bpe_vocab

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    write_bpe_vocab(SERVE_CAPTIONS, tok_dir, num_merges=BPE_MERGES)
    enc = dict(text_encoder=UniversalTextEncoder(CLIP_NAME, dtype="bfloat16", pretrained=False,
                                                 device="cuda", generator=gen),
               vae=AutoencoderKL(compute_dtype=torch.bfloat16, device="cuda").init_weights(gen),
               tokenizer=UniversalTokenizer(CLIP_NAME, tok_dir))
    torch.cuda.synchronize()
    log(f"[serve] CLIP-H text tower ({sum(p.numel() for p in enc['text_encoder'].parameters())} "
        f"params) and SDXL VAE ({sum(p.numel() for p in enc['vae'].parameters())} params) "
        f"built on cuda at random weights, BPE vocabulary of {BPE_MERGES} merges: "
        f"{time.perf_counter() - t0:.1f} s")
    return enc


def prompt_generate(model, enc, prompts, steps, want, label):
    """generate(prompt=...) with the encoders attached: images (B, 3, 8 latent_res,
    8 latent_res) fp32, finite, in [0, 1], not constant; the kernel launch counts
    equal ``want`` (the encoders and the VAE launch none); per-image stage times."""
    import torch

    for key, handle in enc.items():
        setattr(model, key, handle)
    side = 8 * model.latent_res
    # warm-up of the encoder and the VAE at these shapes (cuBLAS / cuDNN choices),
    # so that the timed call's stages are steady-state; the sampler is warm already
    model.encode_prompts(prompts)
    model.decode_latents(torch.zeros(len(prompts), 4, model.latent_res, model.latent_res,
                                     device="cuda"))
    torch.cuda.reset_peak_memory_stats()
    with StageTimes(model) as st:
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        images = model.generate(prompt=prompts, guidance_scale=5.0, num_inference_steps=steps,
                                seed=SEED)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        got = read_counts()
    peak = torch.cuda.max_memory_allocated()
    n = len(prompts)
    per = {stage: ms / n for stage, ms in st.ms.items()}
    out = dict(wall_ms=wall, img_per_s=n / (wall / 1e3), ms_per_image=per,
               decode_share=st.ms["decode"] / wall, peak_gib=peak / 2**30,
               launches=got, images_std=images.std().item(), latents=st.latents)
    log(f"{label} generate(prompt=[{n} captions]), {steps} Heun steps, CFG 5.0 -> "
        f"{tuple(images.shape)} {images.dtype}: {wall:.1f} ms, {out['img_per_s']:.4f} img/s "
        f"end to end; per image tokenize {per['tokenize']:.3f} ms, text encode "
        f"{per['text_encode']:.2f} ms, sampler {per['sampler']:.1f} ms, VAE decode "
        f"{per['decode']:.2f} ms (decode share {out['decode_share']:.4f}); peak "
        f"{out['peak_gib']:.2f} GiB; launches {got}, expected {want}")
    finite = bool(torch.isfinite(images).all())
    if (tuple(images.shape) != (n, 3, side, side) or images.dtype != torch.float32
            or not finite or images.min().item() < 0.0 or images.max().item() > 1.0
            or out["images_std"] <= 0.0):
        raise AssertionError(f"{label} images: shape {tuple(images.shape)} {images.dtype}, "
                             f"finite {finite}, range [{images.min().item()}, "
                             f"{images.max().item()}], std {out['images_std']}")
    if got != want:
        raise AssertionError(f"{label} prompt generate launch counts {got} != {want}")
    return out


def run_serve512(model, enc, want):
    """The 512px prompt -> image path with the stage-4 model; one VAE encode of 2
    seeded 512px images; one 512px decode in bf16 and in fp32 on the same latents
    and weights (cuDNN's bf16 convolutions against fp32 ones)."""
    import torch
    from micro_diffusion_tpu_torch.models.vae import AutoencoderKL

    out = prompt_generate(model, enc, SERVE_CAPTIONS[:SAMPLE512_PROMPTS], STEPS, want,
                          "[serve 512px]")
    vae = enc["vae"]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    images = torch.rand(SAMPLE512_PROMPTS, 3, 512, 512, generator=gen, device="cuda") * 2 - 1
    vae.encode(images, generator=gen)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    z = vae.encode(images, generator=gen)
    torch.cuda.synchronize()
    out["encode_ms_per_image"] = (time.perf_counter() - t0) * 1e3 / SAMPLE512_PROMPTS
    if tuple(z.shape) != (SAMPLE512_PROMPTS, 4, 64, 64) or not bool(torch.isfinite(z).all()):
        raise AssertionError(f"512px VAE encode: shape {tuple(z.shape)}, finite "
                             f"{bool(torch.isfinite(z).all())}")
    vae32 = AutoencoderKL(compute_dtype=torch.float32, device="cuda")
    vae32.load_state_dict(vae.state_dict())
    lat = out.pop("latents") / model.latent_scale
    bf16 = vae.decode(lat)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fp32 = vae32.decode(lat)
    torch.cuda.synchronize()
    out["fp32_decode_ms_per_image"] = (time.perf_counter() - t0) * 1e3 / SAMPLE512_PROMPTS
    out["vae_bf16_rel_l2"] = ((bf16 - fp32).norm() / fp32.norm()).item()
    log(f"[serve 512px] VAE encode {tuple(z.shape)}: {out['encode_ms_per_image']:.2f} ms per "
        f"image; decode bf16 vs fp32 on the same latents: rel L2 {out['vae_bf16_rel_l2']:.3e} "
        f"(tol {VAE_TOL}), fp32 decode {out['fp32_decode_ms_per_image']:.2f} ms per image")
    if not out["vae_bf16_rel_l2"] <= VAE_TOL:
        raise AssertionError(f"512px decode bf16 vs fp32 rel L2 {out['vae_bf16_rel_l2']}")
    del vae32, bf16, fp32
    return out


def run_t5():
    """One full-width DeepFloyd/t5-v1_1-xxl forward at random weights (HF T5's init
    scales) in bf16: 4 x 120 seeded ids with a padding mask -> (4, 1, 120, 4096),
    finite; the encoder is freed afterwards."""
    import torch
    from micro_diffusion_tpu_torch.models.text_encoders import UniversalTextEncoder

    gen = torch.Generator(device="cuda").manual_seed(SEED + 12)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    enc = UniversalTextEncoder(T5_NAME, dtype="bfloat16", pretrained=False, device="cuda",
                               generator=gen)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in enc.parameters())
    ids = torch.randint(2, 32128, (4, 120), generator=gen, device="cuda")
    mask = (torch.arange(120, device="cuda")[None] < torch.tensor(
        [[120], [77], [30], [5]], device="cuda")).long()
    ids = ids * mask
    enc.encode(ids, attention_mask=mask)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    emb, _ = enc.encode(ids, attention_mask=mask)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    finite = bool(torch.isfinite(emb).all())
    log(f"[serve t5] T5-v1.1-XXL ({n_params} params) built on cuda in {build_s:.1f} s; "
        f"forward of 4 x 120 ids in bf16: {tuple(emb.shape)} {emb.dtype}, finite {finite}, "
        f"{ms:.1f} ms, peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if tuple(emb.shape) != (4, 1, 120, 4096) or not finite:
        raise AssertionError(f"T5-XXL forward: shape {tuple(emb.shape)}, finite {finite}")
    del enc, emb
    free_memory()
    return dict(ms=ms, params=n_params)


# ------------------------------------------------------------------ eval


def eval_captions(n):
    """The first ``n`` prompts of the recipe's fixed evaluation prompts."""
    import yaml

    with open(PROMPTS_FILE) as f:
        return yaml.safe_load(f)["prompts"][:n]


def write_real_images(dirname, n, seed):
    """``n`` seeded smooth RGB images, 384 x 320 (the FID loader centre-crops and
    resizes them), standing in for a real reference set."""
    import numpy as np
    from PIL import Image

    os.makedirs(dirname, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        small = Image.fromarray(rng.integers(0, 256, (5, 6, 3), np.uint8))
        small.resize((384, 320), Image.BILINEAR).save(os.path.join(dirname, f"{i:06d}.png"))


def clip_l14_shapes():
    """HF CLIPModel names and shapes at CLIP_L14's widths."""
    v, t, proj = CLIP_L14["vision"], CLIP_L14["text"], CLIP_L14["projection_dim"]
    wv, wt, patch = v["hidden_size"], t["hidden_size"], v["patch_size"]
    shapes = {
        "vision_model.embeddings.class_embedding": (wv,),
        "vision_model.embeddings.patch_embedding.weight": (wv, 3, patch, patch),
        "vision_model.embeddings.position_embedding.weight":
            ((v["image_size"] // patch) ** 2 + 1, wv),
        "text_model.embeddings.token_embedding.weight": (t["vocab_size"], wt),
        "text_model.embeddings.position_embedding.weight": (t["max_position_embeddings"], wt),
        "visual_projection.weight": (proj, wv), "text_projection.weight": (proj, wt),
        "logit_scale": (),
    }
    norms = [("vision_model.pre_layrnorm", wv), ("vision_model.post_layernorm", wv),
             ("text_model.final_layer_norm", wt)]
    for tower, w, layers in (("vision_model", wv, v["num_hidden_layers"]),
                             ("text_model", wt, t["num_hidden_layers"])):
        for i in range(layers):
            pre = f"{tower}.encoder.layers.{i}."
            norms += [(pre + "layer_norm1", w), (pre + "layer_norm2", w)]
            for name, o, n_in in [(f"self_attn.{x}_proj", w, w) for x in ("q", "k", "v", "out")] + [
                    ("mlp.fc1", 4 * w, w), ("mlp.fc2", w, 4 * w)]:
                shapes[pre + name + ".weight"] = (o, n_in)
                shapes[pre + name + ".bias"] = (o,)
    for name, w in norms:
        shapes[name + ".weight"] = shapes[name + ".bias"] = (w,)
    return shapes


def write_clip_snapshot(dirname, gen):
    """A local HF CLIPModel snapshot at the widths of openai/clip-vit-large-patch14
    (the model upstream GenEval's colour judge uses), random weights from ``gen``
    (fan-in scaled matrices, embeddings at 0.02, LayerNorms near the identity):
    config.json, pytorch_model.bin (fp32) and a BPE vocabulary learned from the
    GenEval colour prompts (eot the highest id, as in CLIP's)."""
    import torch
    from micro_diffusion_tpu_torch.eval.geneval import COCO_CLASSES, GENEVAL_COLORS
    from micro_diffusion_tpu_torch.utils.clip_bpe import write_bpe_vocab

    os.makedirs(dirname, exist_ok=True)
    sd = {}
    for name, shape in clip_l14_shapes().items():
        x = torch.randn(shape, generator=gen, device=gen.device)
        if name == "logit_scale":
            x = torch.tensor(math.log(100.0))
        elif "norm" in name:
            x = (1.0 if name.endswith(".weight") else 0.0) + 0.02 * x
        elif "embedding" in name or name.endswith(".bias"):
            x = 0.02 * x
        else:
            x = x * math.prod(shape[1:]) ** -0.5
        sd[name] = x.cpu()
    torch.save(sd, os.path.join(dirname, "pytorch_model.bin"))
    with open(os.path.join(dirname, "config.json"), "w") as f:
        json.dump({"vision_config": CLIP_L14["vision"], "text_config": CLIP_L14["text"],
                   "projection_dim": CLIP_L14["projection_dim"]}, f)
    write_bpe_vocab([f"a photo of a {c} {o}" for c in GENEVAL_COLORS for o in COCO_CLASSES],
                    dirname, num_merges=BPE_MERGES)
    return sum(v.numel() for v in sd.values())


def read_pngs(dirname, names):
    import numpy as np
    from PIL import Image

    return np.stack([np.asarray(Image.open(os.path.join(dirname, n)).convert("RGB"))
                     for n in names])


def run_eval(enc, tmp, gen):
    """The evaluation path at 512px (see the module docstring, phase [eval])."""
    import numpy as np
    import torch
    from micro_diffusion_tpu_torch.eval import fid as tfid
    from micro_diffusion_tpu_torch.eval import geneval
    from micro_diffusion_tpu_torch.eval import inception as tinc
    from micro_diffusion_tpu_torch.eval.generate_eval_images import generate_images
    from micro_diffusion_tpu_torch.models.clip_zero_shot import (CLIPVisionTransformer,
                                                                 CLIPZeroShot,
                                                                 preprocess_images)
    from micro_diffusion_tpu_torch.models.diffusion import create_latent_diffusion

    out = {}
    # ---- the model as the eval CLI builds it: XL at 512px, onehot, fused adaLN off
    t0 = time.perf_counter()
    model = create_latent_diffusion(dit_arch="MicroDiT_XL_2", latent_res=64,
                                    pos_interp_scale=2.0, moe_dispatch="onehot",
                                    fused_adaln=False, device="cuda", seed=SEED)
    perturb_zero_init(model.dit, gen)
    for key, handle in enc.items():
        setattr(model, key, handle)
    captions = eval_captions(EVAL_PROMPTS)
    y = torch.randn(EVAL_PROMPTS, 77, 1024, generator=gen, device="cuda")
    x = torch.randn(EVAL_PROMPTS, 4, 64, 64, generator=gen, device="cuda")
    with torch.no_grad(), record_path(model.dit) as rec:
        model.model_forward_wrapper(x, torch.full((1,), 2.5, device="cuda"), y, cfg=5.0)
    want = rec.forward_launches(2 * STEPS - 1)
    if want != launch_dict(attention=69 * (2 * STEPS - 1), moe=16 * (2 * STEPS - 1)):
        raise AssertionError(f"[eval] XL 512px onehot forward records {rec.calls()}, not 69 "
                             "K1 / 16 K2 calls")
    model.encode_prompts(captions)  # warm-up of the encoder and the VAE at these shapes
    model.decode_latents(torch.zeros(EVAL_PROMPTS, 4, 64, 64, device="cuda"))
    log(f"[eval] MicroDiT-XL 512px (onehot, fused adaLN off, pos_interp_scale 2) built "
        f"and warmed in {time.perf_counter() - t0:.1f} s")

    # ---- generate_images: 4 captions, one generate call, 30 steps, CFG 5
    fake = os.path.join(tmp, "eval_fake")
    with StageTimes(model) as st:
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = generate_images(model, captions, fake, batch_size=EVAL_PROMPTS, steps=STEPS,
                            cfg=5.0, seed=SEED)
        wall = (time.perf_counter() - t0) * 1e3
        got = read_counts()
    names = [f"{i:06d}.png" for i in range(EVAL_PROMPTS)]
    with open(os.path.join(fake, "manifest.json")) as f:
        manifest = json.load(f)
    if (n != EVAL_PROMPTS or sorted(os.listdir(fake)) != names + ["manifest.json"]
            or manifest != [{"file": a, "caption": c} for a, c in zip(names, captions)]):
        raise AssertionError(f"[eval] generate_images wrote {sorted(os.listdir(fake))}, "
                             f"manifest {manifest}")
    if got != want:
        raise AssertionError(f"[eval] generate launch counts {got} != {want}")
    pngs = read_pngs(fake, names)
    redo = (model.decode_latents(st.latents).cpu().numpy().transpose(0, 2, 3, 1) * 255)
    png_err = int(np.abs(pngs.astype(np.int16) - redo.astype(np.uint8).astype(np.int16)).max())
    if pngs.shape != (EVAL_PROMPTS, 512, 512, 3) or png_err > 1 or pngs.std() <= 0:
        raise AssertionError(f"[eval] PNGs {pngs.shape}, max level difference from the "
                             f"truncated decode {png_err}, std {pngs.std()}")
    per = {k: v / n for k, v in st.ms.items()}
    per["png"] = (wall - sum(st.ms.values())) / n
    out.update(generate_ms=wall, img_per_s=n / (wall / 1e3), launches=got, png_level_err=png_err)
    log(f"[eval] generate_images({n} captions, batch {EVAL_PROMPTS}, {STEPS} steps, CFG 5.0) "
        f"-> {fake}: {wall:.1f} ms, {out['img_per_s']:.4f} img/s; launches {got}, expected "
        f"{want}; PNGs read back {pngs.shape}, within {png_err} level of the truncated decode")
    del st

    # ---- K2 at the path's shapes (k = 256) against its plain version
    moe_rows = []
    for (nn_, e, k, d, f) in sorted(rec.shapes["moe"]):
        moe_rows.append(check_moe((k, d, f), gen, nn_, e))
        log(f"[kernels] moe_ffn (512px eval) {json.dumps(moe_rows[-1])}")
    out.update(rec=rec, moe_rows=moe_rows)
    del model
    free_memory()

    # ---- the FID CLI, in the background while the card runs the rest
    real = os.path.join(tmp, "eval_real")
    write_real_images(real, EVAL_REAL, SEED + 21)
    params = tinc.synthetic_params(0)
    weights = os.path.join(tmp, "pt_inception_synthetic.pth")
    torch.save({k: torch.from_numpy(v) for k, v in params.items()}, weights)
    t_cli = time.perf_counter()
    cli = subprocess.Popen(
        [sys.executable, "-m", "micro_diffusion_tpu_torch.eval.fid", "--real", real,
         "--fake", fake, "--inception_weights", weights], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", "")),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        # ---- Inception pool3 at full architecture: fp32 (TF32 off) and TF32 on
        # against the card's float64 forward of 8 images; the feature rate
        feature_fn = tinc.make_feature_fn(params, device="cuda")
        feats_fake = np.concatenate([feature_fn(b) for b in tfid.iter_image_dir_batches(fake)])
        feats_real = np.concatenate([feature_fn(b) for b in tfid.iter_image_dir_batches(real)])
        batch8 = torch.from_numpy(np.concatenate(
            [next(tfid.iter_image_dir_batches(fake)), next(tfid.iter_image_dir_batches(real))[:4]]))
        net64 = tinc.build_inception(params, "cuda", torch.float64)
        with torch.no_grad():
            ref = net64(tinc.preprocess(batch8.cuda().double()))
            net32 = tinc.build_inception(params, "cuda")
            with tinc.cudnn_tf32(True):
                tf32 = net32(tinc.preprocess(batch8.cuda()))
        f32 = torch.from_numpy(feature_fn(batch8)).cuda()
        scale = ref.abs().max()
        err_off = ((f32.double() - ref).abs().max() / scale).item()
        err_on = ((tf32.double() - ref).abs().max() / scale).item()
        del net64, net32
        log(f"[eval] Inception pool3 (synthetic_params(0)) features: fake {feats_fake.shape}, "
            f"real {feats_real.shape}; 8 images vs the card's float64 forward: max abs err / "
            f"scale {err_off:.3e} fp32 TF32 off (tol {INCEPTION_TOL}), {err_on:.3e} TF32 on")
        if not (np.isfinite(feats_fake).all() and np.isfinite(feats_real).all()
                and feats_fake.shape == (n, 2048) and feats_real.shape == (EVAL_REAL, 2048)
                and err_off <= INCEPTION_TOL):
            raise AssertionError(f"[eval] Inception features: fp32 vs float64 {err_off}")
        rate_batch = np.random.default_rng(SEED).uniform(
            0, 1, (FEATURE_BATCH, 3, 299, 299)).astype(np.float32)
        feature_fn(rate_batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            feature_fn(rate_batch)
        feat_ips = 3 * FEATURE_BATCH / (time.perf_counter() - t0)
        per["features"] = 1e3 / feat_ips
        out.update(inception_tf32_off_err=err_off, inception_tf32_on_err=err_on,
                   feature_img_per_s=feat_ips)
        log(f"[eval] Inception feature rate at batch {FEATURE_BATCH} (299 px, host to host, "
            f"TF32 off): {feat_ips:.1f} img/s")

        # ---- CLIP ViT-L/14 at random weights: card vs CPU, the encode rate
        snap = os.path.join(tmp, "clip_l14")
        t0 = time.perf_counter()
        n_clip = write_clip_snapshot(snap, gen)
        zs = CLIPZeroShot(snap, device="cuda")
        load_s = time.perf_counter() - t0
        rng = np.random.default_rng(SEED + 22)
        boxes = rng.integers((0, 0, 32, 32), (256, 256, 256, 256), (64, 4)).tolist()
        crops = [pngs[i % n][a:a + h, b:b + w] for i, (a, b, h, w) in enumerate(boxes)]
        card = zs.encode_images(crops[:2])
        vision_cpu = CLIPVisionTransformer(
            CLIP_L14["vision"]["image_size"], CLIP_L14["vision"]["patch_size"],
            CLIP_L14["vision"]["hidden_size"], CLIP_L14["vision"]["num_hidden_layers"],
            CLIP_L14["vision"]["num_attention_heads"])
        vision_cpu.load_state_dict({k: v.cpu() for k, v in zs.vision.state_dict().items()})
        with torch.no_grad():
            pix = torch.from_numpy(preprocess_images(crops[:2], 224)).permute(0, 3, 1, 2)
            cpu = (vision_cpu(pix) @ zs.visual_projection.cpu()).numpy()
        cpu = cpu / np.linalg.norm(cpu, axis=-1, keepdims=True)
        clip_rel = float(np.linalg.norm(card - cpu) / np.linalg.norm(cpu))
        del vision_cpu
        zs.encode_images(crops)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        zs.encode_images(crops)
        clip_ips = len(crops) / (time.perf_counter() - t0)
        pix = torch.from_numpy(preprocess_images(crops, 224)).permute(0, 3, 1, 2).cuda()
        with torch.no_grad():
            tower_ms = time_ms(lambda: zs.vision(pix), iters=3, warmup=1)
        log(f"[eval] CLIP ViT-L/14 ({n_clip} params, random weights) snapshot written and "
            f"loaded in {load_s:.1f} s; encode_images card vs CPU (fp32, 2 crops): rel L2 "
            f"{clip_rel:.3e} (tol {CLIP_CPU_TOL}); encode rate {clip_ips:.1f} crops/s end to "
            f"end (PIL bicubic on the host), vision tower {len(crops) * 1e3 / tower_ms:.1f} "
            f"crops/s on the card ({tower_ms:.2f} ms for {len(crops)})")
        if not clip_rel <= CLIP_CPU_TOL:
            raise AssertionError(f"[eval] CLIP image embeddings card vs CPU rel L2 {clip_rel}")
        out.update(clip_cpu_rel_l2=clip_rel, clip_img_per_s=clip_ips,
                   clip_tower_ms_per_64=tower_ms)
        del zs
        free_memory()

        # ---- GenEval: the CLIP colour judge and the scorer on the 4 images
        color_fn = geneval.make_clip_color_fn(snap, device="cuda")
        judged = [color_fn(pngs[i], [64, 64, 448, 448], "object") for i in range(n)]
        rows = geneval.load_official_manifest()
        entries = [next(r for r in rows if r["tag"] == tag)
                   for tag in ("colors", "single_object", "two_object", "position")]
        dets = []
        for entry in entries:
            boxes = rng.integers(0, 256, (len(entry["include"]), 2))
            dets.append([{"class": req["class"], "score": float(rng.uniform(0.5, 1.0)),
                          "bbox": [int(x0), int(y0), int(x0) + 256, int(y0) + 256]}
                         for req, (x0, y0) in zip(entry["include"], boxes)])
        records = []
        scores = geneval.score_generated_images(entries, dets, list(pngs), color_fn=color_fn,
                                                results_out=records)
        log(f"[eval] CLIP colour judge over {len(geneval.GENEVAL_COLORS)} colours, one crop per "
            f"image: {judged}; GenEval on {n} images, tags "
            f"{[e['tag'] for e in entries]}: {json.dumps(scores)}; records {records}")
        if (any(c not in geneval.GENEVAL_COLORS for c in judged)
                or not all(0.0 <= v <= 1.0 for v in scores.values())
                or [set(r) for r in records] != [{"filename", "tag", "prompt", "correct"}] * n):
            raise AssertionError(f"[eval] GenEval: judged {judged}, scores {scores}")
        out.update(geneval=scores, judged=judged)

        # ---- the FID CLI's result, and the same FID in this process
        stdout, stderr = cli.communicate(timeout=600)
    finally:
        if cli.poll() is None:
            cli.kill()
            cli.wait()
    cli_s = time.perf_counter() - t_cli
    if cli.returncode != 0:
        raise AssertionError(f"[eval] FID CLI exited {cli.returncode}: {stderr[-2000:]}")
    res = json.loads(stdout.strip().splitlines()[-1])
    stats_real, stats_fake = tfid.FIDStats(2048), tfid.FIDStats(2048)
    stats_real.update(feats_real)
    stats_fake.update(feats_fake)
    t0 = time.perf_counter()
    fid_here = tfid.compute_fid_from_stats(stats_real, stats_fake)
    sqrtm_s = time.perf_counter() - t0
    log(f"[eval] FID CLI (python -m micro_diffusion_tpu_torch.eval.fid, synthetic pt_inception "
        f"weights): {json.dumps(res)} in {cli_s:.1f} s wall (process start to exit, beside the "
        f"card's CLIP and GenEval work); the same FID in this process {fid_here:.6f}, its "
        f"Frechet distance (scipy sqrtm of 2048 x 2048) {sqrtm_s:.1f} s = "
        f"{sqrtm_s / cli_s:.2f} of the CLI's wall")
    if not (math.isfinite(res["fid"]) and (res["real_n"], res["fake_n"]) == (EVAL_REAL, n)
            and abs(res["fid"] - fid_here) <= FID_CLI_TOL):
        raise AssertionError(f"[eval] FID CLI {res} against {fid_here} in this process")
    out.update(fid=res, fid_cli_s=cli_s, sqrtm_s=sqrtm_s, ms_per_image=per)
    est = 30000 / out["img_per_s"] + 30000 / out["feature_img_per_s"]
    out["fid30k_estimate_h"] = est / 3600
    log(f"[eval] {json.dumps({k: v for k, v in out.items() if k not in ('rec', 'moe_rows')})}")
    log(f"[eval] FID-30K wall-clock estimate (an estimate, not a measurement): 30000 / "
        f"{out['img_per_s']:.4f} img/s + 30000 / {out['feature_img_per_s']:.1f} img/s = "
        f"{est:.0f} s = {est / 3600:.2f} h on {smi_line()}")
    return out


# ------------------------------------------------------------------ precompute


def write_image_mds(dirname, n, seed):
    """``n`` seeded PRECOMPUTE_WH JPEGs (smooth colour fields with fine noise, so that
    they compress as photographs do) in an image MDS with the columns the JAX
    package's convert.py writes (width, height, jpg, caption), captions from the
    script's caption lists."""
    import numpy as np
    from PIL import Image
    from micro_diffusion_tpu_torch.datasets.mds import MDSWriter

    w, h = PRECOMPUTE_WH
    captions = SERVE_CAPTIONS + eval_captions(EVAL_PROMPTS)
    rng = np.random.default_rng(seed)
    columns = {"width": "int32", "height": "int32", "jpg": "jpeg", "caption": "str"}
    with MDSWriter(out=dirname, columns=columns) as writer:
        for i in range(n):
            field = Image.fromarray(rng.integers(0, 256, (h // 40, w // 40, 3), np.uint8))
            arr = np.asarray(field.resize((w, h), Image.BICUBIC), np.int16)
            arr = arr + rng.integers(-8, 9, arr.shape, dtype=np.int16)
            img = Image.fromarray(np.clip(arr, 0, 255).astype(np.uint8))
            writer.write({"width": w, "height": h, "jpg": img,
                          "caption": captions[i % len(captions)]})


class PrecomputeProbe:
    """Times the stages of a ``precompute`` call by wrapping its calls: the host
    stage (MDS read, JPEG decode and both resizes: ``PrecomputeImageDataset
    .__getitem__``), tokenize, text encode, the VAE encode at each size and the write
    (to the host in fp16 and into the MDS writer: ``_write_batch``); the device ones
    run between torch.cuda.synchronize() boundaries. A StepTimer closes each batch at
    the return of ``_encode_and_write``: ``timer.times[b]`` is batch b's wall time,
    its host reads included."""

    def __init__(self, timer, tokenizer, text_encoder, vae):
        from micro_diffusion_tpu_torch.datasets.prepare import common, precompute

        self.timer = timer
        self.batches = [collections.defaultdict(float)]
        self.sites = [(common.PrecomputeImageDataset, "__getitem__", "host", False),
                      (tokenizer, "tokenize", "tokenize", False),
                      (text_encoder, "encode", "text_encode", True),
                      (vae, "encode", "vae", True),
                      (precompute, "_write_batch", "write", True),
                      (precompute, "_encode_and_write", None, False)]
        self.saved = []

    def _wrap(self, fn, stage, sync):
        import torch

        def timed(*args, **kwargs):
            if sync:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            if stage is None:  # the end of a batch
                self.timer.stop()
                self.timer.start()
                self.batches.append(collections.defaultdict(float))
                return out
            if sync:
                torch.cuda.synchronize()
            key = stage if stage != "vae" else f"vae_{args[0].shape[-1]}"
            self.batches[-1][key] += (time.perf_counter() - t0) * 1e3
            return out
        return timed

    def __enter__(self):
        for obj, name, stage, sync in self.sites:
            self.saved.append((obj, name, obj.__dict__.get(name)))
            setattr(obj, name, self._wrap(getattr(obj, name), stage, sync))
        return self

    def __exit__(self, *exc):
        for obj, name, orig in self.saved:
            if orig is None:  # the instance's wrapper; the class's method is back
                delattr(obj, name)
            else:  # a class's or a module's own function
                setattr(obj, name, orig)
        self.batches.pop()  # opened by the last batch's end


@contextlib.contextmanager
def cudnn_tf32(enabled):
    """cuDNN's TF32 switch for a block, restored after it."""
    import torch

    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = enabled
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = before


def run_precompute(enc, tmp):
    """The latent precompute through the port's ``precompute``: PRECOMPUTE_IMAGES
    seeded images -> caption latents (the CLIP-H tower of ``enc``, bf16) and SDXL VAE
    latents at 256 and 512px (an fp32-compute VAE with ``enc``'s weights, cuDNN's TF32
    on as the CLI runs it: PyTorch's default), rank 0 of 1, batch PRECOMPUTE_BATCH.
    Checks the output, reads it back through the latents loader, holds one encode on
    the card against the CPU, times the stages, profiles one more batch."""
    import numpy as np
    import torch
    from micro_diffusion_tpu_torch.datasets.latents_loader import (
        build_streaming_latents_dataloader)
    from micro_diffusion_tpu_torch.datasets.mds import MDSReader
    from micro_diffusion_tpu_torch.datasets.prepare import common, precompute
    from micro_diffusion_tpu_torch.models.vae import AutoencoderKL
    from micro_diffusion_tpu_torch.utils.profiling import StepTimer, profile_trace

    t0 = time.perf_counter()
    src, out = os.path.join(tmp, "precompute_images"), os.path.join(tmp, "precompute_latents")
    write_image_mds(src, PRECOMPUTE_IMAGES, SEED + 30)
    log(f"[precompute] {PRECOMPUTE_IMAGES} seeded {PRECOMPUTE_WH[0]} x {PRECOMPUTE_WH[1]} "
        f"JPEGs ({sum(os.path.getsize(os.path.join(src, f)) for f in os.listdir(src)) / 2**20:.1f}"
        f" MiB of MDS) written in {time.perf_counter() - t0:.1f} s")
    text_encoder, tokenizer = enc["text_encoder"], enc["tokenizer"]
    vae = AutoencoderKL(compute_dtype=torch.float32, device="cuda")
    vae.load_state_dict(enc["vae"].state_dict())

    timer = StepTimer()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with cudnn_tf32(True), PrecomputeProbe(timer, tokenizer, text_encoder, vae) as probe:
        reset_counts()
        t0 = time.perf_counter()
        timer.start()
        counts = precompute.precompute([src], out, vae, text_encoder, tokenizer,
                                       batch_size=PRECOMPUTE_BATCH,
                                       resize_sizes=PRECOMPUTE_SIZES, process_index=0,
                                       process_count=1, seed=SEED)
        wall = time.perf_counter() - t0
        launches = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    n_batches = PRECOMPUTE_IMAGES // PRECOMPUTE_BATCH
    if tuple(counts) != (PRECOMPUTE_IMAGES, 0) or len(timer.times) != n_batches:
        raise AssertionError(f"[precompute] wrote {counts.written}, skipped "
                             f"{counts.skipped} batches, {len(timer.times)} batches timed")
    if any(launches.values()):
        raise AssertionError(f"[precompute] the path launched DiT kernels: {launches}")

    # the output: merged index, every latent finite at its shape, fp16
    with open(os.path.join(out, "index.json")) as f:
        index = json.load(f)
    reader = MDSReader(out)
    if sum(s["samples"] for s in index["shards"]) != PRECOMPUTE_IMAGES or len(reader) != \
            PRECOMPUTE_IMAGES:
        raise AssertionError(f"[precompute] index.json lists {index['shards']}")
    want = {"caption_latents": 77 * 1024, **{f"latents_{s}": 4 * (s // 8) ** 2
                                             for s in PRECOMPUTE_SIZES}}
    for i in range(PRECOMPUTE_IMAGES):
        sample = reader[i]
        for col, size in want.items():
            arr = np.frombuffer(sample[col], np.float16)
            if arr.size != size or not np.isfinite(arr).all():
                raise AssertionError(f"[precompute] sample {i} {col}: {arr.size} values "
                                     f"(want {size}), finite {np.isfinite(arr).all()}")
    for size in PRECOMPUTE_SIZES:
        dl = build_streaming_latents_dataloader(out, batch_size=PRECOMPUTE_BATCH,
                                                image_size=size, cap_seq_size=77,
                                                cap_emb_dim=1024, shuffle=False,
                                                num_epochs=1)
        batch = next(iter(dl))
        lat, cap = batch["image_latents"], batch["caption_latents"]
        if (lat.shape != (PRECOMPUTE_BATCH, 4, size // 8, size // 8) or lat.dtype != np.float16
                or cap.shape != (PRECOMPUTE_BATCH, 1, 77, 1024) or not np.isfinite(lat).all()):
            raise AssertionError(f"[precompute] loader at {size}px: {lat.shape} {lat.dtype}, "
                                 f"{cap.shape}")
    log(f"[precompute] {counts.written} written, {counts.skipped} batches skipped; "
        f"index.json merged ({len(index['shards'])} shard); every latent finite at "
        f"(4, 32, 32) / (4, 64, 64), caption latents 77 x 1024 fp16; the loader read a "
        f"batch of {PRECOMPUTE_BATCH} at 256 and at 512px; DiT kernel launches "
        f"{sum(launches.values())}")

    # one 256px image's encode_mode on the card against the CPU, fp32
    image = common.PrecomputeImageDataset([src], resize_sizes=(256,))[0]["image_256"]
    x = torch.from_numpy(np.stack([image]))
    vae_cpu = AutoencoderKL(compute_dtype=torch.float32, device="cpu")
    vae_cpu.load_state_dict(vae.state_dict())
    ref = vae_cpu.encode_mode(x)
    rel = {}
    for tf32 in (True, False):
        with cudnn_tf32(tf32):
            got = vae.encode_mode(x).cpu()
        rel[tf32] = ((got - ref).norm() / ref.norm()).item()
    log(f"[precompute] 256px encode_mode, card vs CPU fp32: rel L2 {rel[True]:.3e} with "
        f"cuDNN TF32 on (tol {ENCODE_TF32_TOL}), {rel[False]:.3e} off (tol {ENCODE_FP32_TOL})")
    if not (rel[True] <= ENCODE_TF32_TOL and rel[False] <= ENCODE_FP32_TOL):
        raise AssertionError(f"[precompute] encode card vs CPU rel L2 {rel}")
    del vae_cpu

    # one more batch (rank 1 of 4: images 32-63, no merge) under the profiler
    with cudnn_tf32(True), profile_trace(os.path.join(tmp, "precompute_trace")) as prof:
        t0 = time.perf_counter()
        extra = precompute.precompute([src], os.path.join(tmp, "precompute_profiled"), vae,
                                      text_encoder, tokenizer, batch_size=PRECOMPUTE_BATCH,
                                      resize_sizes=PRECOMPUTE_SIZES, process_index=1,
                                      process_count=4, seed=SEED)
        torch.cuda.synchronize()
        prof_wall = (time.perf_counter() - t0) * 1e3
    if tuple(extra) != (PRECOMPUTE_BATCH, 0) or not os.path.getsize(prof.trace_path):
        raise AssertionError(f"[precompute] profiled batch {extra}, trace {prof.trace_path}")
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    busy_share = busy / prof_wall if busy > 0 else None

    # one 512px batch's VAE encode with TF32 off, for the cost of the stricter setting
    src_reader = MDSReader(src)
    imgs = torch.from_numpy(np.stack([common.resize_center_crop(src_reader[i]["jpg"], 512)
                                      for i in range(PRECOMPUTE_BATCH)]))
    with cudnn_tf32(False):
        vae.encode(imgs, generator=torch.Generator(device="cuda").manual_seed(SEED))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        vae.encode(imgs, generator=torch.Generator(device="cuda").manual_seed(SEED))
        torch.cuda.synchronize()
        fp32_512 = (time.perf_counter() - t0) * 1e3 / PRECOMPUTE_BATCH

    timed = probe.batches[1:]
    n_timed = PRECOMPUTE_BATCH * len(timed)
    rate = n_timed / sum(timer.times[1:])
    stages = ("host", "tokenize", "text_encode", *(f"vae_{s}" for s in PRECOMPUTE_SIZES),
              "write")
    per = {stage: sum(b[stage] for b in timed) / n_timed for stage in stages}
    res = dict(img_per_s=rate, ms_per_image=per, batch_s=timer.times, wall_s=wall,
               peak_gib=peak, busy_ms=busy, profiled_wall_ms=prof_wall,
               busy_share=busy_share, encode_rel_l2_tf32=rel[True],
               encode_rel_l2_fp32=rel[False], vae_512_fp32_ms_per_image=fp32_512,
               estimate_37m_h=TRAINING_IMAGES / rate / 3600)
    log(f"[precompute] {rate:.2f} img/s end to end over batches 2-{n_batches} (batch "
        f"times {', '.join(f'{t:.3f}' for t in timer.times)} s; the whole call {wall:.2f} s); "
        f"ms per image: host read + decode + both resizes {per['host']:.2f}, tokenize "
        f"{per['tokenize']:.3f}, text encode {per['text_encode']:.3f}, VAE encode 256 "
        f"{per['vae_256']:.2f}, VAE encode 512 {per['vae_512']:.2f}, write "
        f"{per['write']:.3f}; peak {peak:.2f} GiB")
    log(f"[precompute] profiled batch (rank 1 of 4): wall {prof_wall:.1f} ms, device busy "
        f"{busy:.1f} ms, busy share "
        f"{'not measured' if busy_share is None else f'{busy_share:.3f}'}; trace "
        f"{os.path.basename(prof.trace_path)}; VAE encode 512 with TF32 off "
        f"{fp32_512:.2f} ms per image")
    log(f"[precompute] estimate (37e6 / the rate, not measured) for the 37M-image "
        f"training set: {res['estimate_37m_h']:.1f} h on one card ({smi_line()})")
    return res


def seeded_image(rng, wh):
    """A seeded RGB image of size ``wh``: a smooth colour field with fine noise."""
    import numpy as np
    from PIL import Image

    w, h = wh
    field = Image.fromarray(rng.integers(0, 256, (max(1, h // 40), max(1, w // 40), 3),
                                         np.uint8))
    arr = np.asarray(field.resize((w, h), Image.BICUBIC), np.int16)
    arr = arr + rng.integers(-8, 9, arr.shape, dtype=np.int16)
    return Image.fromarray(np.clip(arr, 0, 255).astype(np.uint8))


def write_prepare_sources(root, n, seed):
    """Raw files of the six datasets in their own layouts, ``n`` seeded images each
    (PRECOMPUTE_WH, and for each dataset one more that its filter drops where it has
    one): a JDB archive (a .tgz of images) with its annotation jsonl, cc12m
    webdataset tars (jpg + txt pairs), SA-1B images with caption files, COCO images
    with a captions json, DiffusionDB images with their metadata rows (NSFW scores),
    and TextCaps samples as the HF dataset yields them. Returns what each converter
    takes."""
    import io
    import tarfile

    import numpy as np

    rng = np.random.default_rng(seed)
    caps = SERVE_CAPTIONS + eval_captions(EVAL_PROMPTS)
    cap = lambda i: caps[i % len(caps)]
    small = (200, 180)  # under the 256px minimum side: dropped by the filters
    out = {}

    def jpeg(img):
        buf = io.BytesIO()
        img.save(buf, "JPEG", quality=90)
        return buf.getvalue()

    def add(tar, name, data):
        info = tarfile.TarInfo(name)
        info.size = len(data)
        tar.addfile(info, io.BytesIO(data))

    # JDB: data/train/imgs/000.tgz + the annotation jsonl (img_path ./000/<name>)
    jdb = os.path.join(root, "jdb")
    os.makedirs(jdb)
    with tarfile.open(os.path.join(jdb, "000.tgz"), "w:gz") as tar:
        for i in range(n + 1):
            add(tar, f"{i:04d}.jpg", jpeg(seeded_image(rng, small if i == n else PRECOMPUTE_WH)))
    with open(os.path.join(jdb, "anno.jsonl"), "w") as f:
        for i in range(n + 1):
            f.write(json.dumps({"img_path": f"./000/{i:04d}.jpg", "prompt": cap(i)}) + "\n")
    out["jdb"] = dict(archive=os.path.join(jdb, "000.tgz"), images=os.path.join(jdb, "imgs"),
                      captions=os.path.join(jdb, "anno.jsonl"))

    # cc12m: webdataset tars of <key>.jpg + <key>.txt
    wds = os.path.join(root, "cc12m")
    os.makedirs(wds)
    for t in range(2):
        with tarfile.open(os.path.join(wds, f"cc12m-train-{t:04d}.tar"), "w") as tar:
            for i in range(t, n + 1, 2):
                add(tar, f"{i:06d}.jpg", jpeg(seeded_image(
                    rng, small if i == n else PRECOMPUTE_WH)))
                add(tar, f"{i:06d}.txt", ("<b>" + cap(i) + "</b> http://x.org/a.jpg").encode())
    out["cc12m"] = dict(wds=wds)

    # SA-1B: sa_*.jpg under a tar's folder, captions/<stem>.txt (one image without)
    sa = os.path.join(root, "sa1b")
    os.makedirs(os.path.join(sa, "raw", "sa_000000"))
    os.makedirs(os.path.join(sa, "captions"))
    for i in range(n + 1):
        seeded_image(rng, PRECOMPUTE_WH).save(
            os.path.join(sa, "raw", "sa_000000", f"sa_{i}.jpg"), quality=90)
        if i < n:
            with open(os.path.join(sa, "captions", f"sa_{i}.txt"), "w") as f:
                f.write(cap(i) + "\n")
    out["sa1b"] = dict(images=os.path.join(sa, "raw"), captions=os.path.join(sa, "captions"))

    # COCO: val2014/<file name> + annotations/captions_val2014.json (two captions an
    # image, and one annotation whose image is missing)
    from micro_diffusion_tpu_torch.datasets.prepare import coco

    co = os.path.join(root, "coco")
    os.makedirs(os.path.join(co, "val2014"))
    os.makedirs(os.path.join(co, "annotations"))
    anns = []
    for i in range(n):
        seeded_image(rng, PRECOMPUTE_WH).save(
            os.path.join(co, "val2014", coco.image_file_name(100 + i)), quality=90)
        anns += [{"image_id": 100 + i, "caption": cap(i)},
                 {"image_id": 100 + i, "caption": cap(i + 1)}]
    anns.append({"image_id": 99999, "caption": "no image"})
    with open(os.path.join(co, "annotations", "captions_val2014.json"), "w") as f:
        json.dump({"annotations": anns}, f)
    out["coco"] = dict(datadir=co)

    # DiffusionDB: images/part-000001/<name>.webp + metadata rows (one NSFW-scored)
    dd = os.path.join(root, "diffdb")
    os.makedirs(os.path.join(dd, "images", "part-000001"))
    rows = []
    for i in range(n + 1):
        name = f"{i:04d}.webp"
        seeded_image(rng, PRECOMPUTE_WH).save(
            os.path.join(dd, "images", "part-000001", name), "WEBP")
        rows.append({"part_id": 1, "image_name": name, "prompt": cap(i),
                     "image_nsfw": 0.9 if i == n else 0.05, "prompt_nsfw": 0.05})
    out["diffdb"] = dict(images=dd, rows=rows)

    # TextCaps: the samples the HF dataset yields (one without reference captions)
    out["textcaps"] = dict(samples=[
        {"image_height": PRECOMPUTE_WH[1], "image_width": PRECOMPUTE_WH[0],
         "image": seeded_image(rng, PRECOMPUTE_WH), "image_id": f"tc{i}",
         "reference_strs": [cap(i), cap(i + 1)] if i < n else []}
        for i in range(n + 1)])
    return out


def run_prepare(enc, tmp):
    """The data path from raw files to a train step, with no network and no JAX:
    seeded raw files of the six datasets (write_prepare_sources), the port's download
    step (JDB's archive through ``extract_and_filter``) and each converter into an
    image MDS, the port's precompute at 256px (the CLIP-H tower of ``enc`` in bf16,
    the SDXL VAE in fp32 with cuDNN TF32 on, each dataset's caption column and
    cleaning from specs.py), the latents loader over the results, and one
    MicroDiT-Tiny train step through cli.main on them. DiffusionDB's metadata goes
    through a parquet file where pandas and pyarrow import, else straight to its row
    writer. Prints the images/s of the convert and of the precompute."""
    import numpy as np
    import torch
    from micro_diffusion_tpu_torch.datasets.latents_loader import (
        build_streaming_latents_dataloader)
    from micro_diffusion_tpu_torch.datasets.mds import MDSReader
    from micro_diffusion_tpu_torch.datasets.prepare import (cc12m, coco, diffdb, download, jdb,
                                                            precompute, sa1b, textcaps)
    from micro_diffusion_tpu_torch.datasets.prepare.specs import DATASETS
    from micro_diffusion_tpu_torch.models.vae import AutoencoderKL
    from micro_diffusion_tpu_torch.train import cli

    root = os.path.join(tmp, "prepare")
    t0 = time.perf_counter()
    src = write_prepare_sources(os.path.join(root, "raw"), PREPARE_IMAGES, SEED + 50)
    log(f"[prepare] raw files of six datasets ({PREPARE_IMAGES} images each, one more that "
        f"a filter drops) written in {time.perf_counter() - t0:.1f} s")
    try:
        import pandas  # noqa: F401
        import pyarrow  # noqa: F401
        parquet = True
    except ImportError as err:
        parquet = False
        log(f"[prepare] pandas / pyarrow do not import here ({err}): DiffusionDB's rows go "
            "to its row writer without the parquet file")

    mds = {name: os.path.join(root, "mds", name) for name in src}
    t_convert = time.perf_counter()
    kept = download.extract_and_filter(src["jdb"]["archive"],
                                       os.path.join(src["jdb"]["images"], "000"))
    written = {
        "jdb": jdb.convert_to_mds(src["jdb"]["images"], src["jdb"]["captions"], mds["jdb"]),
        "cc12m": cc12m.convert_to_mds(src["cc12m"]["wds"], mds["cc12m"]),
        "sa1b": sa1b.convert_to_mds(src["sa1b"]["images"], src["sa1b"]["captions"],
                                    mds["sa1b"]),
        "coco": coco.convert_to_mds(src["coco"]["datadir"], mds["coco"]),
        "textcaps": textcaps.write_samples(src["textcaps"]["samples"], mds["textcaps"]),
    }
    rows = src["diffdb"]["rows"]
    if parquet:
        import pandas as pd

        meta = os.path.join(src["diffdb"]["images"], "metadata-large.parquet")
        pd.DataFrame(rows).to_parquet(meta)
        written["diffdb"] = diffdb.convert_to_mds(src["diffdb"]["images"], mds["diffdb"],
                                                  metadata_parquet=meta)
    else:
        safe = [r for r in rows if max(r["image_nsfw"], r["prompt_nsfw"])
                <= diffdb.SAFETY_THRESHOLD]
        written["diffdb"] = diffdb._write_rows(
            [(src["diffdb"]["images"], r["part_id"], r["image_name"], r["prompt"])
             for r in safe], mds["diffdb"])
    convert_s = time.perf_counter() - t_convert
    total = sum(written.values())
    log(f"[prepare] download step: {kept} of {PREPARE_IMAGES + 1} JDB archive images kept; "
        f"converted {written} in {convert_s:.2f} s: {total / convert_s:.1f} images/s "
        f"(DiffusionDB through {'a parquet file' if parquet else 'its row writer'})")
    if written != {name: PREPARE_IMAGES for name in src} or kept != PREPARE_IMAGES:
        raise AssertionError(f"[prepare] converters wrote {written}, JDB kept {kept}; "
                             f"want {PREPARE_IMAGES} each")

    text_encoder, tokenizer = enc["text_encoder"], enc["tokenizer"]
    vae = AutoencoderKL(compute_dtype=torch.float32, device="cuda")
    vae.load_state_dict(enc["vae"].state_dict())
    latents = {}
    torch.cuda.synchronize()
    t_pre = time.perf_counter()
    with cudnn_tf32(True):
        for name in src:
            spec = DATASETS[name]
            latents[name] = os.path.join(root, "latents", name)
            counts = precompute.precompute([mds[name]], latents[name], vae, text_encoder,
                                           tokenizer, batch_size=PREPARE_BATCH,
                                           resize_sizes=(256,), caption_key=spec.caption_key,
                                           clean_captions=spec.clean_captions,
                                           process_index=0, process_count=1, seed=SEED)
            if tuple(counts) != (PREPARE_IMAGES, 0):
                raise AssertionError(f"[prepare] precompute {name}: {counts}")
    torch.cuda.synchronize()
    pre_s = time.perf_counter() - t_pre
    n_all = PREPARE_IMAGES * len(src)
    cleaned = MDSReader(latents["cc12m"])[0]["caption"]
    log(f"[prepare] precompute of {n_all} images at 256px (six calls, batch "
        f"{PREPARE_BATCH}, the first call's warm-up included): {pre_s:.2f} s, "
        f"{n_all / pre_s:.1f} images/s; a cleaned cc12m caption: {cleaned!r}")
    if "<b>" in cleaned or "http" in cleaned:
        raise AssertionError(f"[prepare] cc12m's caption was not cleaned: {cleaned!r}")

    dl = build_streaming_latents_dataloader(list(latents.values()), batch_size=PREPARE_BATCH,
                                            image_size=256, shuffle=False, num_epochs=1)
    batches = list(dl)
    lat = np.concatenate([b["image_latents"] for b in batches])
    if lat.shape != (n_all, 4, 32, 32) or not np.isfinite(lat).all():
        raise AssertionError(f"[prepare] loader: {lat.shape}, finite {np.isfinite(lat).all()}")

    metrics_path = os.path.join(root, "tiny.jsonl")
    probe = TrainerProbe()
    reset_counts()
    trainer = cli.main(stage_argv(
        "res_256_pretrain", latents["jdb"], latents["coco"], metrics_path, 1,
        "model.dit_arch=MicroDiT_Tiny_2", f"dataset.train_batch_size={PREPARE_BATCH}",
        f"trainer.device_train_microbatch_size={PREPARE_BATCH}",
        f"dataset.eval_batch_size={PREPARE_BATCH}"), callbacks=[probe])
    losses, _, _, evals = fit_metrics(metrics_path, 1, "[prepare] Tiny")
    log(f"[prepare] the loader read {len(batches)} batches of {PREPARE_BATCH} from the six "
        f"latents sets, all finite; one Tiny step through cli.main on the JDB latents: loss "
        f"{losses[0]:.4f}, eval on the COCO latents {evals[0]:.4f}, launches {probe.steps[0]}")
    if not any(probe.steps[0].values()):
        raise AssertionError("[prepare] the Tiny step launched no kernel")
    del trainer, vae
    return dict(written=written, convert_img_per_s=total / convert_s,
                precompute_img_per_s=n_all / pre_s, parquet=parquet, loss=losses[0])


# ------------------------------------------------------------------ train


def kernel_counts():
    fal = importlib.import_module("micro_diffusion_tpu_torch.ops.flash_attention_lane")
    bh = importlib.import_module("micro_diffusion_tpu_torch.ops.flash_attention_bh")
    fa = importlib.import_module("micro_diffusion_tpu_torch.ops.flash_attention")
    mf = importlib.import_module("micro_diffusion_tpu_torch.ops.moe_ffn")
    ad = importlib.import_module("micro_diffusion_tpu_torch.ops.adaln")
    return {"attention": fal.flash_attention_lane, "attention_bwd": fal.flash_attention_lane_bwd,
            "moe": mf.moe_ffn, "moe_bwd": mf.moe_ffn_bwd, "adaln": ad.layernorm_modulate,
            "bh": bh.flash_attention_bh, "bh_bwd": bh.flash_attention_bh_bwd,
            "fa": fa.flash_attention, "fa_bwd": fa.flash_attention_bwd,
            "em": mf.moe_ffn_expert_major, "em_bwd": mf.moe_ffn_expert_major_bwd}


def launch_dict(**counts):
    """Launch counts of every kernel wrapper, 0 where not given."""
    return {name: counts.get(name, 0) for name in kernel_counts()}


def reset_counts():
    for fn in kernel_counts().values():
        fn.launches = 0


def read_counts():
    return {name: fn.launches for name, fn in kernel_counts().items()}


def train_batch(gen, b, latent=32):
    """Seeded batch: latents (b, 4, latent, latent) (32 at 256px, 64 at 512px),
    caption latents (b, 1, 77, 1024), 10% of the captions dropped."""
    import torch

    return {
        "image_latents": torch.randn(b, 4, latent, latent, generator=gen, device="cuda"),
        "caption_latents": torch.randn(b, 1, 77, 1024, generator=gen, device="cuda"),
        "drop_caption_mask": (torch.rand(b, generator=gen, device="cuda") >= 0.1).float(),
    }


def compare_train_grads(model, batch, gen, label="[train]"):
    """One microbatch's loss and whole gradient through the kernels and through the
    plain versions, with the same injected draws."""
    import torch

    b = batch["image_latents"].shape[0]
    draws = model.train_draws(batch["image_latents"].shape, model.train_mask_ratio, gen)
    params = [p for p in model.parameters() if p.requires_grad]

    def loss_and_grads():
        loss, _, _ = model(batch, **draws)
        return loss.detach(), torch.autograd.grad(loss, params)

    loss_k, grads_k = loss_and_grads()
    with plain_kernels():
        loss_p, grads_p = loss_and_grads()
    torch.cuda.synchronize()
    diff2 = sum((gk.float() - gp.float()).square().sum() for gk, gp in zip(grads_k, grads_p))
    ref2 = sum(gp.float().square().sum() for gp in grads_p)
    rel_grad = (diff2.sqrt() / ref2.sqrt()).item()
    rel_loss = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
    finite = all(bool(torch.isfinite(g).all()) for g in grads_k)
    log(f"{label} mb {b}, kernels vs plain: loss {loss_k.item():.6f} vs {loss_p.item():.6f} "
        f"(rel {rel_loss:.3e}, tol {TRAIN_LOSS_TOL}); whole gradient rel L2 {rel_grad:.3e} "
        f"(tol {TRAIN_GRAD_TOL}), |grad| {ref2.sqrt().item():.4e}, finite {finite}")
    if not (finite and rel_loss <= TRAIN_LOSS_TOL and rel_grad <= TRAIN_GRAD_TOL):
        raise AssertionError(f"train step kernels vs plain: loss rel {rel_loss}, "
                             f"grad rel L2 {rel_grad}")
    return dict(rel_loss=rel_loss, rel_grad=rel_grad)


def run_train():
    import torch
    from micro_diffusion_tpu_torch.models.diffusion import create_latent_diffusion
    from micro_diffusion_tpu_torch.train import (build_optimizer, build_schedule,
                                                 create_train_state, make_train_step)

    t0 = time.perf_counter()
    model = create_latent_diffusion(dit_arch="MicroDiT_XL_2", latent_res=32,
                                    train_mask_ratio=0.75, device="cuda", seed=SEED,
                                    remat=REMAT)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    # with adaLN-zero every gate is 0 and no gradient reaches attention or MoE
    perturb_zero_init(model.dit, gen)
    batch = train_batch(gen, TRAIN_MB)
    log(f"[train] MicroDiT-XL stage 1 on cuda, remat {REMAT}: built in "
        f"{time.perf_counter() - t0:.1f} s")
    cmp = compare_train_grads(model, batch, gen)

    sched = build_schedule({"_target_": "composer.optim.CosineAnnealingWithWarmupScheduler",
                            "t_warmup": "2500ba", "alpha_f": 0.33}, 2.4e-4, 250000)
    tx = build_optimizer(dict(model.dit.named_parameters()), sched, weight_decay=0.1,
                         betas=(0.9, 0.999), eps=1e-8, clip_norm=0.25)
    state = create_train_state(model.dit, tx)
    step_fn = make_train_step(model, tx, sched, microbatch_size=TRAIN_MB)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def step(state):
        state, m = step_fn(state, batch, gen)
        m = {k: float(v) for k, v in m.items()}
        log(f"[train] step {state.step - 1}: loss {m['loss']:.6f} grad_norm "
            f"{m['grad_norm']:.6f} lr {m['lr']:.6e}")
        if not (math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])):
            raise AssertionError(f"non-finite train metrics {m}")
        return state

    # the path's kernel shapes, from one forward of the loss (under remat the
    # backward re-runs each block's forward, which the hooks would count again)
    with torch.no_grad(), record_path(model.dit) as rec:
        model(batch, generator=gen)
    attn_shapes, moe_shapes = rec.shapes["attention"], rec.shapes["moe"]
    per_fwd = (sum(attn_shapes.values()), sum(moe_shapes.values()))
    if per_fwd != (69, 16):
        raise AssertionError(f"XL train forward ran {per_fwd} attention/MoE calls, not (69, 16)")
    state = step(state)  # warm-up (lr 0 at step 0)
    sums = [p.detach().double().sum().item() for p in state.params.values()]

    times = []
    for i in range(TRAIN_STEPS):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = step(state)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        counts = read_counts()
        if i == 0:
            launches = counts
            changed = sum(a != p.detach().double().sum().item()
                          for a, p in zip(sums, state.params.values()))
            log(f"[train] step 1 changed {changed} of {len(sums)} parameter tensors")
            if changed < 0.9 * len(sums):
                raise AssertionError(f"step 1 changed only {changed} of {len(sums)} params")
    fwd_factor = 2 if REMAT else 1  # with remat the 34 blocks re-run their forward
    want = launch_dict(attention=69 + 68 * (fwd_factor - 1), attention_bwd=69,
                       moe=16 * fwd_factor, moe_bwd=16)  # fused adaLN off here
    log(f"[train] launches per K=1 step {launches}, expected {want}")
    if launches != want:
        raise AssertionError(f"train step launch counts {launches} != {want}")
    ms = sorted(times)[len(times) // 2] * 1e3
    peak = torch.cuda.max_memory_allocated()
    log(f"[train] stage 1, mb {TRAIN_MB}, K=1: step times "
        f"{', '.join(f'{t * 1e3:.1f}' for t in times)} ms; median {ms:.1f} ms/step, "
        f"{TRAIN_MB / ms * 1e3:.2f} img/s; peak memory {peak / 2**30:.2f} GiB "
        f"(torch.cuda.max_memory_allocated); remat {REMAT}")
    profile_step(lambda: step(state))
    attribute_step(lambda: step(state), model, f"XL stage-1 train step (mb {TRAIN_MB})")
    return dict(attn_shapes=attn_shapes, moe_shapes=moe_shapes, launches=launches,
                ms_per_step=ms, img_per_s=TRAIN_MB / ms * 1e3, peak_bytes=peak, **cmp)


def profile_step(fn, top=15, label=f"XL stage-1 train step (mb {TRAIN_MB})"):
    """One train step under torch.profiler: wall time, device busy time (sum of
    kernel durations on the one stream), idle share, and the top kernels; returns
    the first three (busy and idle None where the profiler saw no kernel)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy <= 0:
        log(f"[profile] train step wall {wall:.2f} ms; device time not measured "
            "(the profiler saw no kernels)")
        return dict(wall=wall, busy=None, idle=None)
    log(f"[profile] {label}: wall {wall:.2f} ms, device busy "
        f"{busy:.2f} ms, idle share {1 - busy / wall:.3f}, "
        f"{sum(e.count for e in kernels)} kernel launches")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        log(f"[profile]   {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:<5d} "
            f"{e.key[:110]}")
    return dict(wall=wall, busy=busy, idle=1 - busy / wall)


def attribute_step(fn, model, label):
    """One further step ``fn`` under profile_trace, every module call of ``model``
    named (utils/profiling.py module_scopes) and the step inside the scope
    ATTRIBUTION_STEP: its Chrome trace gzipped into TRACE_DIR, and the tables of
    scripts/trace_summary.py (device time by op class and by kernel name, busy and
    idle) and scripts/attribute_trace.py (by model component and direction) as
    [attribution] lines. Fails unless busy + idle equals the window, the buckets sum
    to the device ops' time and the device ran."""
    import gzip
    import shutil
    import torch
    from micro_diffusion_tpu_torch.scripts import attribute_trace, trace_summary
    from micro_diffusion_tpu_torch.utils.profiling import module_scopes, profile_trace

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile_trace(TRACE_DIR) as prof:
        with module_scopes(model), torch.profiler.record_function(ATTRIBUTION_STEP):
            fn()
            torch.cuda.synchronize()
    traced = time.perf_counter() - t0
    t0 = time.perf_counter()
    events = trace_summary.load(prof.trace_path)
    summary = trace_summary.summarize(events, ATTRIBUTION_STEP)
    attr = attribute_trace.attribute(events, ATTRIBUTION_STEP)
    del events
    path = prof.trace_path + ".gz"
    with open(prof.trace_path, "rb") as src, gzip.open(path, "wb", compresslevel=3) as dst:
        shutil.copyfileobj(src, dst)
    os.remove(prof.trace_path)
    for line in trace_summary.report(summary) + attribute_trace.report(attr):
        log(f"[attribution] {label}: {line}")
    log(f"[attribution] {label}: traced step and export {traced:.1f} s, tables "
        f"{time.perf_counter() - t0:.1f} s; trace {os.path.relpath(path, ROOT)} "
        f"({os.path.getsize(path) / 2**20:.1f} MiB)")
    summed = sum(sum(d.values()) for d in attr["buckets"].values())
    if not (summary["device_ms"] > 0
            and abs(summary["busy_ms"] + summary["idle_ms"] - summary["window_ms"])
            <= 1e-6 * summary["window_ms"]
            and abs(summed - summary["device_ms"]) <= 1e-6 * summary["device_ms"]):
        raise AssertionError(f"[attribution] {label}: busy {summary['busy_ms']} + idle "
                             f"{summary['idle_ms']} vs window {summary['window_ms']}, "
                             f"buckets {summed} vs device {summary['device_ms']}")


def share(x):
    return "not measured" if x is None else f"{x:.3f}"


# ------------------------------------------------------------------ trainer


def write_latents(dirname, n, seed, res=256):
    """A seeded MDS latents dataset with the recipe's columns: fp16 caption latents
    (1, 77, 1024) and image latents (4, res/8, res/8) (8 KB at 256px, 32 KB at
    512px)."""
    import numpy as np
    from micro_diffusion_tpu_torch.datasets import MDSWriter

    rng = np.random.default_rng(seed)
    lat = res // 8
    caps = rng.standard_normal((n, 1, 77, 1024), dtype=np.float32).astype(np.float16)
    lats = (0.8 * rng.standard_normal((n, 4, lat, lat), dtype=np.float32)).astype(np.float16)
    col = f"latents_{res}"
    with MDSWriter(out=dirname, columns={"caption_latents": "bytes", col: "bytes"}) as w:
        for i in range(n):
            w.write({"caption_latents": caps[i].tobytes(), col: lats[i].tobytes()})


class TrainerProbe:
    """A trainer callback (fit_start / step_end / eval_end / fit_end): the kernel
    launches of every step and of the eval, the parameter tensors that step 1 (the
    first with a non-zero lr) changed, and those changed from then to the end. At
    the recipe's adaLN-zero init step 1 moves only the layers whose gradient is not
    gated by a zero (the adaLN and final projections); later steps move the rest.
    Runs with metric_window 1."""

    def __init__(self):
        self.steps, self.eval_counts, self.changed, self.changed_by_end = [], None, None, None
        self._mark, self._sums = None, None

    def _delta(self):
        now = read_counts()
        delta = {k: now[k] - self._mark[k] for k in now}
        self._mark = now
        return delta

    @staticmethod
    def _param_sums(trainer):
        import torch
        return torch.stack([p.detach().double().sum()
                            for p in trainer.state.params.values()]).cpu()

    def fit_start(self, trainer):
        self._mark = read_counts()
        self._start = trainer.global_step  # 0, or the step a full-state load resumed at

    def step_end(self, trainer, metrics):
        self.steps.append(self._delta())
        if trainer.global_step == self._start + 1:
            self._sums = self._param_sums(trainer)
        elif trainer.global_step == self._start + 2:
            self.changed = int((self._param_sums(trainer) != self._sums).sum())

    def eval_end(self, trainer, eval_loss):
        self.eval_counts = self._delta()

    def fit_end(self, trainer):
        self.changed_by_end = int((self._param_sums(trainer) != self._sums).sum())


def free_memory():
    import gc
    import torch

    gc.collect()
    torch.cuda.empty_cache()


def read_jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def bare_steps(trainer, batch, n):
    """``n`` make_train_step calls on the trainer's state, each synced; ms each."""
    import torch

    times = []
    for i in range(n):
        gen = torch.Generator(device="cuda").manual_seed(SEED + 10 + i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.state, m = trainer._step_fn(trainer.state, batch, gen)
        if not math.isfinite(float(m["loss"])):
            raise AssertionError(f"bare step: non-finite loss {m}")
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def remat_grads_agree(model, batch, gen, label, policies):
    """One microbatch's loss and whole gradient under each remat policy of
    ``policies`` against 'full' on the card, with the same draws: the selective
    contexts must rebuild what the kernels' autograd Functions saved, and the kept
    kernel outputs ('attn_moe') must be the recomputed ones, so all agree (the same
    arithmetic in the same order; 1e-6 relative L2 leaves room for a GEMM algorithm
    that sums otherwise). Returns {policy: relative L2}."""
    import torch

    b = batch["image_latents"].shape[0]
    draws = model.train_draws(batch["image_latents"].shape, model.train_mask_ratio, gen)
    params = [p for p in model.parameters() if p.requires_grad]
    policy = model.dit.remat_policy

    def loss_and_grads(name):
        model.dit.remat_policy = name
        loss, _, _ = model(batch, **draws)
        return loss.detach(), torch.autograd.grad(loss, params)

    loss_f, grads_f = loss_and_grads("full")
    ref = sum(g.float().square().sum() for g in grads_f).sqrt()
    rels = {}
    for name in policies:
        loss, grads = loss_and_grads(name)
        equal = sum(bool(torch.equal(a, g)) for a, g in zip(grads, grads_f))
        diff2 = sum((a.float() - g.float()).square().sum() for a, g in zip(grads, grads_f))
        rels[name] = (diff2.sqrt() / ref).item()
        log(f"{label} remat '{name}' vs 'full', one microbatch of {b}: loss "
            f"{loss.item():.6f} vs {loss_f.item():.6f}; {equal} of {len(params)} gradients "
            f"bitwise equal, whole gradient relative L2 {rels[name]:.3e} (tol 1e-6)")
        if not (torch.equal(loss, loss_f) and rels[name] <= 1e-6):
            raise AssertionError(f"remat {name} vs full: loss {loss.item()} vs "
                                 f"{loss_f.item()}, gradient rel L2 {rels[name]}")
        del grads
    model.dit.remat_policy = policy
    return rels


@contextlib.contextmanager
def counted_gathers():
    """Count the native MDS gather's calls, samples and bytes (datasets/native.py)
    inside the block: [calls, samples, bytes]."""
    from micro_diffusion_tpu_torch.datasets import native

    fn, counts = native.gather, [0, 0, 0]

    def gather(paths, file_offsets, lengths, *args, **kwargs):
        counts[0] += 1
        counts[1] += len(paths)
        counts[2] += int(sum(lengths))
        return fn(paths, file_offsets, lengths, *args, **kwargs)

    native.gather = gather
    try:
        yield counts
    finally:
        native.gather = fn


def drop_page_cache(dirname):
    """Drop the page cache's copy of every file under ``dirname`` (fsync, then
    ``posix_fadvise`` DONTNEED, which needs no root): the next read is a cold one, as
    a sample's read is in an epoch over a set larger than the host's memory."""
    for root, _, files in os.walk(dirname):
        for name in files:
            fd = os.open(os.path.join(root, name), os.O_RDONLY)
            try:
                os.fsync(fd)
                os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
            finally:
                os.close(fd)


def read_batch(datadir, indices, path):
    """One batch's blobs read through ``path``, 'gather' (``native.gather``) or 'mmap'
    (``MDSReader.read_blobs_mmap``), by a new reader whose maps no read has touched
    yet (a sample's first read in an epoch): (sha256 of the blobs, bytes, start and
    end on the host's monotonic clock, which every process of the host shares)."""
    import hashlib
    from micro_diffusion_tpu_torch.datasets import native
    from micro_diffusion_tpu_torch.datasets.mds import MDSReader

    reader = MDSReader(datadir)
    ranges = [reader.sample_range(int(i)) for i in indices]
    t0 = time.perf_counter()
    if path == "gather":
        blobs = native.gather([r[0] for r in ranges], [r[2] for r in ranges],
                              [r[3] for r in ranges])
    else:
        blobs = reader.read_blobs_mmap(ranges)
    t1 = time.perf_counter()
    digest = hashlib.sha256()
    for b in blobs:
        digest.update(b)
    return digest.hexdigest(), sum(r[3] for r in ranges), t0, t1


def compare_reads(datadir, batches, label, rounds=5, pool=None):
    """The batches (one a reader; in ``pool``'s processes at once when given, else
    one after another in this one) through the native gather and through the
    memmap path, in turns, ``rounds`` times each from a warm page cache and from a
    cold one (``drop_page_cache`` before each read): the blobs bitwise equal, the
    MB/s of all the batches (their bytes over the span from the first start to the
    last end), the median of the rounds. Raises when the two paths differ."""
    rates, digests = {}, {}
    for cache in ("warm", "cold"):
        for _ in range(rounds):
            for path in ("gather", "mmap"):
                if cache == "cold":
                    drop_page_cache(datadir)
                args = [(datadir, b, path) for b in batches]
                res = (list(pool.starmap(read_batch, args)) if pool is not None
                       else [read_batch(*a) for a in args])
                span = max(r[3] for r in res) - min(r[2] for r in res)
                rates.setdefault((cache, path), []).append(sum(r[1] for r in res) / span / 1e6)
                digests.setdefault(path, set()).add(tuple(r[0] for r in res))
    equal = len(digests["gather"]) == 1 and digests["gather"] == digests["mmap"]
    med = {f"{path}_{cache}_mb_s": statistics.median(v) for (cache, path), v in rates.items()}
    every = {f"{cache} {path}": [round(x) for x in v] for (cache, path), v in rates.items()}
    log(f"{label} {len(batches)} reader(s) x {len(batches[0])} samples "
        f"({'processes at once' if pool is not None else 'one process'}), a new reader "
        f"each read: native gather and memmap slices bitwise equal {equal}; MB/s, median "
        f"of {rounds}: warm {med['gather_warm_mb_s']:.0f} (gather, 8 threads) vs "
        f"{med['mmap_warm_mb_s']:.0f} (memmap), cold {med['gather_cold_mb_s']:.0f} vs "
        f"{med['mmap_cold_mb_s']:.0f}; every round {every}")
    if not equal:
        raise AssertionError(f"{label} the native gather's blobs differ from the memmap path's")
    return med


def gather_vs_mmap(loader, gathers):
    """The loader's reads went through the native gather; its first epoch-ordered
    batch read by the gather and by the memmap path (``compare_reads``)."""
    from micro_diffusion_tpu_torch.datasets import native

    calls, samples, nbytes = gathers
    log(f"[trainer] the loader read {samples} samples ({nbytes / 1e6:.1f} MB) in {calls} "
        f"calls of the native MDS gather ({os.path.basename(native.library_path())})")
    if not calls:
        raise AssertionError("[trainer] the loader never called the native gather")
    idx = loader._epoch_order(0)[:loader.global_batch_size]
    rates = compare_reads(loader.dataset.readers[0].dirname, [idx], "[trainer]")
    return dict(calls=calls, samples=samples, bytes=nbytes, **rates)


def run_trainer(tmp):
    """The XL stage-1 recipe through the entry point, then the bare-step and remat
    comparisons on the same model and state."""
    import torch
    from micro_diffusion_tpu_torch.train import cli

    t0 = time.perf_counter()
    train_dir, eval_dir = os.path.join(tmp, "train"), os.path.join(tmp, "eval")
    write_latents(train_dir, TRAINER_SAMPLES, SEED)
    write_latents(eval_dir, EVAL_SAMPLES, SEED + 1)
    metrics_path = os.path.join(tmp, "metrics.jsonl")
    log(f"[trainer] wrote {TRAINER_SAMPLES} + {EVAL_SAMPLES} synthetic MDS samples in "
        f"{time.perf_counter() - t0:.1f} s")
    argv = ["--config-path", OVERLAY, "--config-name", "res_256_pretrain",
            f"dataset.train.datadir={train_dir}", f"dataset.eval.datadir={eval_dir}",
            f"trainer.max_duration={TRAINER_STEPS}ba", "trainer.metric_window=1",
            f"trainer.eval_interval={TRAINER_STEPS}ba", "trainer.save_folder=null",
            "callbacks.speed_monitor.window_size=1",
            f"callbacks.image_monitor.prompts_file={PROMPTS_FILE}",
            "logger.progress._target_=micro_diffusion_tpu_torch.train.callbacks.JSONLLogger",
            f"logger.progress.path={metrics_path}"]
    probe = TrainerProbe()
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with counted_gathers() as gathers:
        trainer = cli.main(argv, callbacks=[probe])
    wall = time.perf_counter() - t0
    fit_peak = torch.cuda.max_memory_allocated()
    dit = trainer.model.dit
    gather = gather_vs_mmap(trainer.train_loader, gathers)
    log(f"[trainer] cli.main: {TRAINER_STEPS} steps + eval in {wall:.1f} s (model build "
        f"included); remat {dit.remat} '{dit.remat_policy}', fused adaLN on; peak "
        f"{fit_peak / 2**30:.2f} GiB")

    rows = read_jsonl(metrics_path)
    losses = [r["loss/train/total"] for r in rows if "loss/train/total" in r]
    norms = [r["l2_norm/grad/global"] for r in rows if "l2_norm/grad/global" in r]
    ips = {r["step"]: r["throughput/images_per_sec"] for r in rows
           if "throughput/images_per_sec" in r}
    waits = [r["trainer/data_wait_ms_per_step"] for r in rows
             if "trainer/data_wait_ms_per_step" in r]
    evals = [r["metrics/eval/loss"] for r in rows if "metrics/eval/loss" in r]
    log(f"[trainer] losses {losses}; grad norms {norms}; eval loss {evals}")
    if not (len(losses) == len(norms) == TRAINER_STEPS
            and all(math.isfinite(v) for v in losses + norms + evals) and len(evals) == 1):
        raise AssertionError(f"trainer metrics: {len(losses)} losses, {len(norms)} grad "
                             f"norms, evals {evals}; all finite expected")
    want = launch_dict(attention=137, attention_bwd=69, moe=32, moe_bwd=16, adaln=137)
    want_eval = launch_dict(attention=138, moe=32, adaln=138)
    log(f"[trainer] launches per step {probe.steps}; eval (2 batches of 128) "
        f"{probe.eval_counts}")
    if probe.steps != [want] * TRAINER_STEPS or probe.eval_counts != want_eval:
        raise AssertionError(f"trainer launch counts: steps {probe.steps} (want {want}), "
                             f"eval {probe.eval_counts} (want {want_eval})")
    n_params = len(trainer.state.params)
    log(f"[trainer] step 1 changed {probe.changed} of {n_params} parameter tensors; steps "
        f"1-{TRAINER_STEPS - 1} changed {probe.changed_by_end}")
    if not (probe.changed and probe.changed_by_end >= 0.9 * n_params):
        raise AssertionError(f"step 1 changed {probe.changed}, steps 1-{TRAINER_STEPS - 1} "
                             f"{probe.changed_by_end} of {n_params} params")
    trainer_ips = steady_rate(ips)
    log(f"[trainer] images/s per step (SpeedMonitor, window 1) {ips}; all images over "
        f"all the time after the first two steps {trainer_ips:.2f} img/s; data wait "
        f"ms/step {waits}")

    # the path's K6 shapes from one forward (the remat re-run repeats the blocks')
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    batch = {k: v.half() if v.dtype == torch.float32 and v.dim() > 1 else v
             for k, v in train_batch(gen, TRAIN_MB).items()}
    with torch.no_grad(), record_path(dit) as rec:
        trainer.model(batch, generator=gen)
    adaln_fwd = rec.shapes["adaln"]
    adaln_step = {s: 2 * c for s, c in adaln_fwd.items()}
    adaln_step[(TRAIN_MB, 64, dit.dim)] -= 1  # the final layer (64 kept tokens) runs
                                              # outside the remat blocks
    if sum(adaln_step.values()) != want["adaln"]:
        raise AssertionError(f"K6 shapes per step {adaln_step} do not sum to 137")

    # bare make_train_step on the same model, state and configuration, resident
    # batch, under the overlay's policy: the trainer / bare ratio (the remat
    # policies are compared at stage 2, [stage2])
    bare = bare_policy(trainer, batch, dit.remat_policy, "[trainer]", rec)
    log(f"[trainer] trainer / bare (remat '{dit.remat_policy}') = "
        f"{trainer_ips / bare['img_per_s']:.3f}")
    return dict(launches=want, adaln_step=adaln_step, trainer_ips=trainer_ips,
                bare=bare, bare_ips=bare["img_per_s"], ratio=trainer_ips / bare["img_per_s"],
                waits=waits, fit_peak=fit_peak, policy=dit.remat_policy, losses=losses,
                gather=gather,
                norms=norms, ips=ips,
                numel=sum(p.numel() for p in trainer.state.params.values()))


def run_resume(tmp):
    """MicroDiT-Tiny through the entry point: 4 steps straight, against 2 steps, a
    checkpoint and an autoresume to 4."""
    import torch
    from micro_diffusion_tpu_torch.train import cli

    train_dir, eval_dir = os.path.join(tmp, "train"), os.path.join(tmp, "eval")
    if not os.path.exists(os.path.join(train_dir, "index.json")):
        write_latents(train_dir, TRAINER_SAMPLES, SEED)
        write_latents(eval_dir, EVAL_SAMPLES, SEED + 1)

    def fit(name, steps, *extra):
        argv = ["--config-path", OVERLAY, "--config-name", "res_256_pretrain",
                "model.dit_arch=MicroDiT_Tiny_2", f"dataset.train.datadir={train_dir}",
                f"dataset.eval.datadir={eval_dir}",
                f"dataset.train_batch_size={RESUME_BATCH}",
                f"trainer.device_train_microbatch_size={RESUME_MB}",
                f"trainer.max_duration={steps}ba", "trainer.eval_interval=0",
                "trainer.save_interval=0", f"trainer.save_folder={os.path.join(tmp, name)}",
                f"callbacks.image_monitor.prompts_file={PROMPTS_FILE}",
                "logger.progress._target_=micro_diffusion_tpu_torch.train.callbacks.JSONLLogger",
                f"logger.progress.path={os.path.join(tmp, name + '.jsonl')}", *extra]
        return cli.main(argv)

    t0 = time.perf_counter()
    straight = fit("straight", 4)
    ref = {k: p.detach().clone() for k, p in straight.state.params.items()}
    del straight
    first = fit("resumed", 2)
    first_step = first.state.step
    del first
    resumed = fit("resumed", 4, "trainer.autoresume=true")
    got = resumed.state.params
    equal = sum(bool(torch.equal(got[k], ref[k])) for k in ref)
    diff2 = sum((got[k].double() - ref[k].double()).square().sum() for k in ref)
    ref2 = sum(ref[k].double().square().sum() for k in ref)
    rel = (diff2.sqrt() / ref2.sqrt()).item()
    max_abs = max((got[k] - ref[k]).abs().max().item() for k in ref)
    log(f"[resume] Tiny, batch {RESUME_BATCH} (K = {RESUME_BATCH // RESUME_MB}), fused adaLN, "
        f"remat '{resumed.model.dit.remat_policy}': 2 steps + autoresume to "
        f"{resumed.state.step} vs 4 straight: {equal} of {len(ref)} tensors bitwise equal, "
        f"relative L2 {rel:.3e} (tol {RESUME_TOL}), max abs diff {max_abs:.3e}; "
        f"{time.perf_counter() - t0:.1f} s")
    if not (first_step == 2 and resumed.state.step == 4 and rel <= RESUME_TOL):
        raise AssertionError(f"resume: steps {first_step} -> {resumed.state.step}, rel L2 {rel}")
    return dict(equal=equal, tensors=len(ref), rel=rel, max_abs=max_abs)


# ------------------------------------------------------------ multi-GPU layer


def dist_argv(tmp, save_folder, metrics_path, *extra):
    return ["--multihost", "--config-path", OVERLAY, "--config-name", "res_256_pretrain",
            f"dataset.train.datadir={os.path.join(tmp, 'train')}",
            f"dataset.eval.datadir={os.path.join(tmp, 'eval')}",
            f"trainer.max_duration={DIST_STEPS}ba", "trainer.metric_window=1",
            "trainer.eval_interval=0", f"trainer.save_interval={DIST_SAVE_AT}ba",
            "trainer.save_num_checkpoints_to_keep=2", f"trainer.save_folder={save_folder}",
            f"algorithms.ema.smoothing={DIST_EMA}", "algorithms.ema.ema_start=1ba",
            "callbacks.speed_monitor.window_size=1",
            f"callbacks.image_monitor.prompts_file={PROMPTS_FILE}",
            "logger.progress._target_=micro_diffusion_tpu_torch.train.callbacks.JSONLLogger",
            f"logger.progress.path={metrics_path}", *extra]


@contextlib.contextmanager
def timed_methods(cls, names, into):
    """Wrap methods of ``cls`` to add each call's synchronised wall seconds to
    ``into[name]``."""
    import torch

    saved = {n: getattr(cls, n) for n in names}

    def wrap(name, fn):
        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                torch.cuda.synchronize()
                into[name].append(time.perf_counter() - t0)
        return timed

    for n, fn in saved.items():
        setattr(cls, n, wrap(n, fn))
    try:
        yield into
    finally:
        for n, fn in saved.items():
            setattr(cls, n, fn)


def run_dist(tmp, tn):
    """(a) The XL stage-1 recipe through ``cli.main --multihost`` in a one-rank NCCL
    group (torchrun's variables set here) on the [trainer] set, with the EMA on:
    3 steps with a save at 2 (and the final one), then an autoresume from step 2 in
    a fresh trainer to step 3, bitwise equal to the straight run; losses and grad
    norms against [trainer]'s no-group steps; the launch counts; the save and load
    seconds, the file's bytes, the peak. (b) 2 gloo ranks on this card, when gloo
    takes CUDA tensors (run_dist_gloo)."""
    import shutil
    import torch
    import torch.distributed as dist
    from micro_diffusion_tpu_torch.parallel.dryrun import free_ports
    from micro_diffusion_tpu_torch.train import cli
    from micro_diffusion_tpu_torch.train.trainer import Trainer

    ckpt = os.path.join(tmp, "dist_ckpt")
    need = int(2.2 * 16 * tn["numel"])  # two files of fp32 params, mu, nu and EMA
    free = shutil.disk_usage(tmp).free
    log(f"[dist] {free / 1e9:.1f} GB free under {tmp}; the round trip needs "
        f"{need / 1e9:.1f} GB (two checkpoints of {16 * tn['numel'] / 1e9:.2f} GB)")
    if free < need:
        raise AssertionError(f"[dist] {free / 1e9:.1f} GB free under {tmp}, "
                             f"{need / 1e9:.1f} GB needed for two XL checkpoints")
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "LOCAL_WORLD_SIZE": "1",
           "MASTER_ADDR": "localhost", "MASTER_PORT": str(free_ports()[0])}
    os.environ.update(env)
    times = {"save": [], "_resume": []}
    want = tn["launches"]
    try:
        with timed_methods(Trainer, ("save", "_resume"), times):
            metrics_a = os.path.join(tmp, "dist_a.jsonl")
            probe_a = TrainerProbe()
            reset_counts()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            a = cli.main(dist_argv(tmp, ckpt, metrics_a), callbacks=[probe_a])
            wall_a = time.perf_counter() - t0
            peak_a = torch.cuda.max_memory_allocated()
            backend = dist.get_backend()
            log(f"[dist] cli.main --multihost: backend {backend}, {a.mesh}, {DIST_STEPS} "
                f"steps in {wall_a:.1f} s (model build and 2 saves included); peak "
                f"{peak_a / 2**30:.2f} GiB")
            if backend != "nccl" or a.mesh.size != 1 or a.zero is None:
                raise AssertionError(f"[dist] not a one-rank NCCL group: {backend}, {a.mesh}")
            file_bytes = os.path.getsize(os.path.join(ckpt, str(DIST_SAVE_AT), "checkpoint.pt"))
            shutil.rmtree(os.path.join(ckpt, str(DIST_STEPS)))
            probe_b = TrainerProbe()
            reset_counts()
            torch.cuda.reset_peak_memory_stats()
            b = cli.main(dist_argv(tmp, ckpt, os.path.join(tmp, "dist_b.jsonl"),
                                   "trainer.autoresume=true"), callbacks=[probe_b])
            peak_b = torch.cuda.max_memory_allocated()
        losses, norms, ips, _ = fit_metrics(metrics_a, DIST_STEPS, "[dist]", evals_want=0)
        rel = [abs(x - y) / abs(y) for x, y in zip(losses + norms,
                                                   tn["losses"][:DIST_STEPS] + tn["norms"][:DIST_STEPS])]
        log(f"[dist] against [trainer]'s no-group steps: losses {tn['losses'][:DIST_STEPS]}, "
            f"grad norms {tn['norms'][:DIST_STEPS]}; largest relative difference "
            f"{max(rel):.3e} (tol {DIST_TOL})")
        if max(rel) > DIST_TOL:
            raise AssertionError(f"[dist] losses/norms differ from [trainer]'s by {max(rel)}")
        log(f"[dist] launches per step {probe_a.steps}, resumed step {probe_b.steps}; "
            f"expected {want}")
        if probe_a.steps != [want] * DIST_STEPS or probe_b.steps != [want]:
            raise AssertionError(f"[dist] launch counts {probe_a.steps} / {probe_b.steps} "
                                 f"(want {want})")
        sa, sb = a.state, b.state
        pairs = {"params": (sa.params, sb.params), "mu": (sa.opt_state.mu, sb.opt_state.mu),
                 "nu": (sa.opt_state.nu, sb.opt_state.nu),
                 "ema": (sa.ema_params, sb.ema_params)}
        equal = {k: sum(bool(torch.equal(x[n], y[n])) for n in x) for k, (x, y) in pairs.items()}
        n = len(sa.params)
        log(f"[dist] autoresume from step {DIST_SAVE_AT} to {sb.step} against the straight run "
            f"at step {sa.step}: bitwise equal tensors {equal} of {n} each; count "
            f"{sb.opt_state.count} / {sa.opt_state.count}")
        if not (sb.step == sa.step == DIST_STEPS and all(v == n for v in equal.values())
                and sb.opt_state.count == sa.opt_state.count):
            raise AssertionError(f"[dist] resume not bitwise: {equal} of {n}")
        trainer_ips = {s: tn["ips"][s] for s in sorted(tn["ips"]) if s <= DIST_STEPS}
        log(f"[dist] images/s per step {ips} ([trainer], no group: {trainer_ips}; the "
            f"time to step {DIST_SAVE_AT + 1} includes the save at {DIST_SAVE_AT}); saves "
            f"{', '.join(f'{t:.1f}' for t in times['save'])} s (steps {DIST_SAVE_AT}, "
            f"{DIST_STEPS}, then the resumed {DIST_STEPS}); load {times['_resume'][0]:.1f} s; "
            f"file {file_bytes} bytes ({file_bytes / 1e9:.2f} GB); peaks {peak_a / 2**30:.2f} "
            f"/ {peak_b / 2**30:.2f} GiB (straight / resumed, the straight run's state held)")
        result = dict(losses=losses, norms=norms, ips=ips, trainer_ips=trainer_ips,
                      save_s=times["save"], load_s=times["_resume"][0], file_bytes=file_bytes,
                      peak=peak_a, peak_resumed=peak_b, rel=max(rel), launches=probe_a.steps)
        del a, b, sa, sb, pairs
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k in env:
            os.environ.pop(k, None)
        shutil.rmtree(ckpt, ignore_errors=True)
        free_memory()
    result["gloo"] = run_dist_gloo(tmp)
    return result


def xl_cut_model(policy="full"):
    """MicroDiT-XL at full width (dim 1024, mixer 6 x 768, 8 experts) with the
    backbone cut to ``DIST_B_DEPTH`` blocks, the stage-1 overlay's settings but the
    remat ``policy``, the zero-initialised layers perturbed."""
    import torch
    from micro_diffusion_tpu_torch.models import dit as tdit
    from micro_diffusion_tpu_torch.models.diffusion import LatentDiffusion

    dit = tdit._zoo(DIST_B_DEPTH, 1024, 64, 256, 6, 768, (0.5, 1.0), (0.5, 4.0),
                    caption_channels=1024, input_size=32, num_experts=8, expert_capacity=2.0,
                    experts_every_n=2, in_channels=4, dtype=torch.bfloat16, remat=True,
                    remat_policy=policy, moe_dispatch="onehot", fused_adaln=True,
                    device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    dit.init_weights(gen)
    perturb_zero_init(dit, gen)  # else the gated MoE blocks get no gradient at step 1
    return LatentDiffusion(dit, latent_res=32, train_mask_ratio=0.75)


def moe_leaf_names(dit):
    """The gate and expert parameters of every EC-MoE block of ``dit``."""
    names = []
    for name, mod in dit.named_modules():
        if hasattr(mod, "set_expert_parallel"):
            names += [f"{name}.w1", f"{name}.w2"]
            names += [f"{name}.gate.{n}" for n, _ in mod.gate.named_parameters()]
    return names


def xl_cut_step(mesh=None, policy="full"):
    """One step of the cut XL model under remat ``policy`` on its rows of a seeded
    global batch of ``DIST_B_BATCH`` in microbatches of ``DIST_B_MB`` (constant lr
    1e-4, clip 0.25); (loss, grad norm, whole parameters, whole first moments of the
    gate and expert leaves; on the host)."""
    import torch
    from micro_diffusion_tpu_torch.parallel import Zero2, batch_sharding, shard_params
    from micro_diffusion_tpu_torch.train.optim import build_optimizer, constant_schedule
    from micro_diffusion_tpu_torch.train.train_step import create_train_state, make_train_step

    model = xl_cut_model(policy)
    zero = None
    if mesh is not None:
        shard_params(model.dit, mesh)
        zero = Zero2(model.dit, mesh)
    sched = constant_schedule(1e-4)
    tx = build_optimizer(dict(model.dit.named_parameters()), sched, clip_norm=0.25)
    state = create_train_state(model.dit, tx, grad_shardings=zero)
    step = make_train_step(model, tx, sched, microbatch_size=DIST_B_MB, grad_shardings=zero)
    batch = train_batch(torch.Generator(device="cuda").manual_seed(SEED + 30), DIST_B_BATCH)
    rows = batch_sharding(mesh).rows(DIST_B_BATCH)
    state, m = step(state, {k: v[rows] for k, v in batch.items()},
                    torch.Generator(device="cuda").manual_seed(SEED + 31))
    params = {k: (zero.gather_param(p.detach(), k) if zero else p.detach()).cpu()
              for k, p in state.params.items()}
    mu = state.opt_state.mu
    moe_mu = {k: (zero.gather_state(mu[k], k) if zero else mu[k]).cpu()
              for k in moe_leaf_names(model.dit)}
    return float(m["loss"]), float(m["grad_norm"]), params, moe_mu


def gloo_cuda_probe(rank):
    """Every collective the parallel layer uses, on CUDA tensors in this (gloo)
    group of 2: 'ok' or the error, by name."""
    import torch
    import torch.distributed as dist

    x = torch.arange(4.0, device="cuda") + rank

    def all_reduce():
        y = x.clone()
        dist.all_reduce(y)
        return torch.equal(y, 2 * torch.arange(4.0, device="cuda") + 1)

    def reduce_scatter():
        y = torch.empty(2, device="cuda")
        dist.reduce_scatter_tensor(y, x.clone())
        return torch.equal(y, (2 * torch.arange(4.0, device="cuda") + 1)[2 * rank:2 * rank + 2])

    def all_gather_into_tensor():
        y = torch.empty(8, device="cuda")
        dist.all_gather_into_tensor(y, x.clone())
        return torch.equal(y[:4] + 1, y[4:])

    def all_gather_list():
        parts = [torch.empty(4, device="cuda") for _ in range(2)]
        dist.all_gather(parts, x.clone())
        return torch.equal(parts[0] + 1, parts[1])

    def broadcast_object():
        obj = [rank]
        dist.broadcast_object_list(obj, src=0)
        return obj == [0]

    def barrier():
        dist.barrier()
        return True

    out = {}
    for fn in (all_reduce, reduce_scatter, all_gather_into_tensor, all_gather_list,
               broadcast_object, barrier):
        try:
            out[fn.__name__] = "ok" if fn() else "wrong values"
        except (RuntimeError, ValueError, NotImplementedError) as err:
            out[fn.__name__] = f"{type(err).__name__}: {str(err).splitlines()[0][:200]}"
    return out


def dist_rank_main(out_path):
    """One of 2 gloo ranks sharing this card (``run_dist_gloo``): the collective
    probe, then, when every collective takes CUDA tensors, one cut-XL step at each
    (mesh, policy) of ``DIST_B_RUNS``; rank 0 writes the results."""
    import datetime
    import torch
    import torch.distributed as dist
    from micro_diffusion_tpu_torch.parallel import make_mesh

    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method="env://",
                            timeout=datetime.timedelta(seconds=DIST_B_GROUP_TIMEOUT_S))
    rank = dist.get_rank()
    res = {"probe": gloo_cuda_probe(rank), "steps": {}}
    if all(v == "ok" for v in res["probe"].values()):
        for shape, policy in DIST_B_RUNS:
            mesh = make_mesh(*shape)
            t0 = time.perf_counter()
            loss, norm, params, moe_mu = xl_cut_step(mesh, policy)
            res["steps"][shape, policy] = dict(loss=loss, grad_norm=norm, params=params,
                                               moe_mu=moe_mu, seconds=time.perf_counter() - t0)
            del params, moe_mu
    if rank == 0:
        torch.save(res, out_path)
    dist.destroy_process_group()
    return 0


def run_dist_gloo(tmp):
    """(b) 2 gloo ranks on this card: the collective probe; when every collective
    takes CUDA tensors, one step of XL at full width, depth cut to DIST_B_DEPTH, at
    each (mesh, remat policy) of DIST_B_RUNS, each against the same step on one rank
    (no group) under the same policy: loss and grad norm within DIST_TOL relative,
    the parameters within DIST_B_PARAM_TOL[mesh] relative L2, and each gate and
    expert leaf's first moment within DIST_B_MOE_GRAD_TOL."""
    import torch
    from micro_diffusion_tpu_torch.parallel import dryrun

    out = os.path.join(tmp, "dist_gloo.pt")
    t0 = time.perf_counter()
    procs = dryrun.spawn(2, [os.path.abspath(__file__), "--dist-rank", out],
                         env={"PYTHONPATH": ROOT})
    dryrun.wait(procs, timeout=DIST_B_TIMEOUT_S)
    res = torch.load(out, weights_only=False)
    os.remove(out)
    log(f"[dist gloo] 2 gloo ranks on one card, collectives on CUDA tensors: "
        f"{json.dumps(res['probe'])} ({time.perf_counter() - t0:.1f} s)")
    summary = {"probe": res["probe"], "steps": {}}
    if not res["steps"]:
        log("[dist gloo] gloo does not take CUDA tensors in every collective the layer "
            "uses: no 2-rank steps on the card; the CPU tests carry the multi-rank parity")
        return summary
    refs = {}
    for (shape, policy), got in res["steps"].items():
        if policy not in refs:
            refs.clear()  # one reference on the card at a time
            free_memory()
            refs[policy] = xl_cut_step(policy=policy)
        loss, norm, params, moe_mu = refs[policy]
        ref2 = sum(v.double().square().sum() for v in params.values())
        diffs = {k: float((got["params"][k].double() - v.double()).square().sum())
                 for k, v in params.items()}
        rel_p = float(sum(diffs.values()) ** 0.5 / ref2.sqrt())
        worst = sorted(diffs, key=diffs.get, reverse=True)[:3]
        leaf = {k: (d / max(float(params[k].double().square().sum()), 1e-300)) ** 0.5
                for k, d in diffs.items()}
        worst_leaf = max(leaf, key=leaf.get)
        grad = {k: float((got["moe_mu"][k].double() - v.double()).norm() / v.double().norm())
                for k, v in moe_mu.items()}
        worst_grad = max(grad, key=grad.get)
        rel_l, rel_n = abs(got["loss"] - loss) / abs(loss), abs(got["grad_norm"] - norm) / norm
        tol = DIST_B_PARAM_TOL[shape]
        log(f"[dist gloo] mesh {shape}, remat '{policy}', XL width depth {DIST_B_DEPTH}, "
            f"batch {DIST_B_BATCH} "
            f"(mb {DIST_B_MB}): loss {got['loss']:.6f} vs one rank {loss:.6f} (rel {rel_l:.3e}), "
            f"grad norm {got['grad_norm']:.6f} vs {norm:.6f} (rel {rel_n:.3e}), parameters "
            f"relative L2 {rel_p:.3e} (tol {DIST_TOL} / {tol}; largest in {worst}, "
            f"{sum(v > 0 for v in diffs.values())} of {len(diffs)} tensors differ; the "
            f"worst leaf alone {leaf[worst_leaf]:.3e} in {worst_leaf}); gate and expert "
            f"leaves' first moments, each: worst relative L2 {grad[worst_grad]:.3e} in "
            f"{worst_grad} (tol {DIST_B_MOE_GRAD_TOL}, {len(grad)} leaves); the 2-rank "
            f"step {got['seconds']:.1f} s (model build included)")
        if not (rel_l <= DIST_TOL and rel_n <= DIST_TOL and rel_p <= tol
                and grad[worst_grad] <= DIST_B_MOE_GRAD_TOL):
            raise AssertionError(f"[dist gloo] mesh {shape} '{policy}': loss {rel_l}, norm {rel_n}, "
                                 f"params {rel_p}, {worst_grad} first moment {grad[worst_grad]}")
        summary["steps"][f"{shape} {policy}"] = dict(
            rel_loss=rel_l, rel_norm=rel_n, rel_params=rel_p, worst_leaf=worst_leaf,
            worst_leaf_rel=leaf[worst_leaf], worst_moe_grad=worst_grad,
            worst_moe_grad_rel=grad[worst_grad])
    refs.clear()
    free_memory()
    return summary


# ------------------------------------------------------------ 512px stages


class StageProbe(TrainerProbe):
    """TrainerProbe plus the EMA: its per-tensor sums when step ``STAGE_EMA_START``
    ends (the last mirrored value) and at the end of the fit, and how many EMA
    tensors differ from the parameters at the end (they lag once it decays)."""

    def __init__(self):
        super().__init__()
        self.ema_moved, self.ema_lagging, self._ema_sums = None, None, None

    @staticmethod
    def _ema_totals(trainer):
        import torch
        return torch.stack([p.detach().double().sum()
                            for p in trainer.state.ema_params.values()]).cpu()

    def step_end(self, trainer, metrics):
        super().step_end(trainer, metrics)
        if trainer.global_step == STAGE_EMA_START:
            self._ema_sums = self._ema_totals(trainer)

    def fit_end(self, trainer):
        import torch
        super().fit_end(trainer)
        self.ema_moved = int((self._ema_totals(trainer) != self._ema_sums).sum())
        ema, params = trainer.state.ema_params, trainer.state.params
        self.ema_lagging = sum(not torch.equal(ema[k], params[k]) for k in params)


def stage_argv(config, train_dir, eval_dir, metrics_path, steps, *extra):
    return ["--config-path", OVERLAY, "--config-name", config,
            f"dataset.train.datadir={train_dir}", f"dataset.eval.datadir={eval_dir}",
            f"trainer.max_duration={steps}ba", "trainer.metric_window=1",
            "trainer.load_path=null", "trainer.save_folder=null", "trainer.save_interval=0",
            f"trainer.eval_interval={steps}ba", "callbacks.speed_monitor.window_size=1",
            f"callbacks.image_monitor.prompts_file={PROMPTS_FILE}",
            "logger.progress._target_=micro_diffusion_tpu_torch.train.callbacks.JSONLLogger",
            f"logger.progress.path={metrics_path}", *extra]


def fit_metrics(metrics_path, steps, label, evals_want=1):
    """Losses, grad norms, SpeedMonitor img/s and the eval losses of a fit; all
    finite, one per step and ``evals_want`` evals."""
    rows = read_jsonl(metrics_path)
    losses = [r["loss/train/total"] for r in rows if "loss/train/total" in r]
    norms = [r["l2_norm/grad/global"] for r in rows if "l2_norm/grad/global" in r]
    ips = {r["step"]: r["throughput/images_per_sec"] for r in rows
           if "throughput/images_per_sec" in r}
    evals = [r["metrics/eval/loss"] for r in rows if "metrics/eval/loss" in r]
    log(f"{label} losses {losses}; grad norms {norms}; eval loss {evals}; images/s per "
        f"step {ips}")
    if not (len(losses) == len(norms) == steps and len(evals) == evals_want
            and all(math.isfinite(v) for v in losses + norms + evals)):
        raise AssertionError(f"{label} metrics: {len(losses)} losses, {len(norms)} grad "
                             f"norms, evals {evals}; all finite expected")
    return losses, norms, ips, evals


def steady_rate(ips, warm=2):
    """Images over time of a fit's steps after the first ``warm`` ones, from the
    SpeedMonitor's per-step rates (window 1): every step has the same batch, so the
    harmonic mean."""
    rates = [ips[s] for s in sorted(ips) if s > warm]
    return len(rates) / sum(1 / r for r in rates)


def microbatching(trainer, batch=None):
    """(microbatch size, microbatches per step) of a trainer's step (or of a bare
    step on ``batch`` samples), as make_train_step splits the batch."""
    batch = batch or trainer.global_batch_size
    mb = min(trainer.microbatch_size or batch, batch)
    return mb, batch // mb


def path_of(trainer, latent):
    """The kernel calls of one training microbatch's forward (mask ratio of the
    recipe) and of one eval forward (mask 0), recorded on small seeded batches of
    the path's shapes (the microbatch at its size: its shapes are timed)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    mb, _ = microbatching(trainer)
    with torch.no_grad(), record_path(trainer.model.dit) as train_rec:
        trainer.model(train_batch(gen, mb, latent), generator=gen)
    with torch.no_grad(), record_path(trainer.model.dit) as eval_rec:
        trainer._eval_fn(train_batch(gen, 2, latent), gen)
    return train_rec, eval_rec


def check_launches(label, probe, want, want_eval, steps):
    log(f"{label} launches per step {probe.steps[0]} (all {steps} steps equal: "
        f"{probe.steps == [probe.steps[0]] * steps}); expected {want}; eval {probe.eval_counts}, "
        f"expected {want_eval}")
    if probe.steps != [want] * steps or probe.eval_counts != want_eval:
        raise AssertionError(f"{label} launch counts: steps {probe.steps} (want {want}), eval "
                             f"{probe.eval_counts} (want {want_eval})")


def gather_determinism(moe, gen, n, t):
    """Two forward + backward calls of one 'gather' MoE layer on the same input: the
    expert-by-expert combine and dispatch backward make them bitwise equal."""
    import torch

    x = torch.randn(n, t, moe.w1.shape[1], generator=gen, device="cuda").bfloat16()
    do = torch.randn(n, t, moe.w1.shape[1], generator=gen, device="cuda").bfloat16()
    params = [moe.gate.weight, moe.w1, moe.w2]
    runs = []
    for _ in range(2):
        xi = x.clone().requires_grad_()
        out = moe(xi)
        grads = torch.autograd.grad(out, [xi] + params, do)
        runs.append([out.detach()] + [g.detach() for g in grads])
    torch.cuda.synchronize()
    equal = [bool(torch.equal(a, b)) for a, b in zip(*runs)]
    log(f"[stage3] 'gather' MoE layer ({n}, {t}, {moe.w1.shape[1]}) twice on the card: "
        f"output, dx, dgate, dw1, dw2 bitwise equal {equal}")
    if not all(equal):
        raise AssertionError(f"'gather' MoE layer not bitwise repeatable: {equal}")


def kept_outputs(policy):
    """The attention outputs that remat ``policy`` keeps, so that the backward does
    not launch their kernels again (JAX dit.py:350-379): both under the 'attn_moe'
    bases, but under 'dots_attn_moe' '_alean' gives up the cross-attention's."""
    from micro_diffusion_tpu_torch.models.dit import parse_remat_policy

    base, lean = parse_remat_policy(policy)
    if not base.endswith("attn_moe"):
        return ()
    if base == "dots_attn_moe" and "attn_proj" in lean:
        return ("attn_out",)
    return ("attn_out", "xattn_out")


def bare_policy(trainer, batch, policy, label, rec, profile=None, attribute=False):
    """A warm-up and ``BARE_TIMED`` bare train steps under the overlay's own remat
    policy, ``BARE_TIMED_OTHER`` under any other ``policy``; their median, its peak
    memory and the memory resident before them, then, under the overlay's own policy
    (``profile`` None; True or False: always or never), one profiled step (a
    profiled XL step costs tens of seconds of script: the profiler's key_averages
    over ~35k launches), and with ``attribute`` one further step for
    ``attribute_step``. The timed steps' launches must be those of ``rec`` (one
    microbatch's forward): the attention kernels whose outputs the policy keeps are
    not launched again."""
    import torch

    dit = trainer.model.dit
    saved, dit.remat_policy = dit.remat_policy, policy
    timed = BARE_TIMED if policy == saved else BARE_TIMED_OTHER
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    bare_steps(trainer, batch, 1)
    reset_counts()
    times = bare_steps(trainer, batch, timed)
    got = read_counts()
    peak = torch.cuda.max_memory_allocated()
    b = batch["image_latents"].shape[0]
    per_step = rec.step_launches(microbatching(trainer, b)[1], kept_outputs(policy))
    want = {k: timed * n for k, n in per_step.items()}
    if got != want:
        raise AssertionError(f"{label} bare steps under '{policy}': launches {got} != {want}")
    ms = statistics.median(times)
    log(f"{label} bare steps, remat '{policy}', batch {b}: "
        f"{', '.join(f'{t:.1f}' for t in times)} ms; median {ms:.1f} ms/step, "
        f"{b / ms * 1e3:.2f} img/s; peak {peak / 2**30:.2f} GiB (resident before "
        f"{resident / 2**30:.2f} GiB); launches per step as expected: {per_step}")
    prof = None
    if profile or (profile is None and policy == saved):
        prof = profile_step(lambda: bare_steps(trainer, batch, 1), top=8,
                            label=f"{label} step, remat '{policy}'")
    if attribute and policy == saved:
        attribute_step(lambda: bare_steps(trainer, batch, 1), trainer.model,
                       f"{label} bare step, remat '{policy}'")
    dit.remat_policy = saved
    return dict(ms=ms, img_per_s=b / ms * 1e3, peak=peak, resident=resident, times=times,
                profile=prof)


def run_stage(tmp, config, label, latent=64, attribute=False):
    """One XL 512px stage through the entry point (the H100 overlay, 'gather', EMA
    from ``STAGE_EMA_START``), then the stage's bare steps under 'dots', the lean
    names and 'full' (the overlays' policy, the one timed in full; with
    ``attribute`` its step's [attribution] tables too)."""
    import torch
    from micro_diffusion_tpu_torch.train import cli

    train_dir, eval_dir = os.path.join(tmp, "train512"), os.path.join(tmp, "eval512")
    if not os.path.exists(os.path.join(train_dir, "index.json")):
        t0 = time.perf_counter()
        write_latents(train_dir, STAGE_SAMPLES, SEED + 20, res=512)
        write_latents(eval_dir, STAGE_EVAL_SAMPLES, SEED + 21, res=512)
        log(f"{label} wrote {STAGE_SAMPLES} + {STAGE_EVAL_SAMPLES} synthetic 512px MDS "
            f"samples in {time.perf_counter() - t0:.1f} s")
    metrics_path = os.path.join(tmp, f"{config}.jsonl")
    probe = StageProbe()
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = cli.main(stage_argv(config, train_dir, eval_dir, metrics_path, STAGE_STEPS,
                                  f"algorithms.ema.ema_start={STAGE_EMA_START}ba"),
                       callbacks=[probe])
    wall = time.perf_counter() - t0
    fit_peak = torch.cuda.max_memory_allocated()
    dit = trainer.model.dit
    batch_size = trainer.global_batch_size
    mb, k = microbatching(trainer)
    log(f"{label} cli.main {config}: {STAGE_STEPS} steps of {batch_size} (mb {mb}, K = {k}) "
        f"+ eval in {wall:.1f} s (model build included); moe_dispatch "
        f"{sorted({m.dispatch for m in dit.modules() if hasattr(m, 'dispatch')})}, remat "
        f"'{dit.remat_policy}', mask {trainer.model.train_mask_ratio}; peak "
        f"{fit_peak / 2**30:.2f} GiB")
    losses, norms, ips, evals = fit_metrics(metrics_path, STAGE_STEPS, label)

    train_rec, eval_rec = path_of(trainer, latent)
    want = train_rec.step_launches(k)
    n_eval = -(-STAGE_EVAL_SAMPLES // trainer.eval_loader.batch_size)
    want_eval = eval_rec.forward_launches(n_eval)
    check_launches(label, probe, want, want_eval, STAGE_STEPS)
    if want["moe"] or not want["em"]:
        raise AssertionError(f"{label}: 'gather' must run K3 and never the one-hot K2: {want}")
    n_params = len(trainer.state.params)
    log(f"{label} steps 1-{STAGE_STEPS - 1} changed {probe.changed_by_end} of {n_params} "
        f"parameter tensors; the EMA moved in {probe.ema_moved} after step "
        f"{STAGE_EMA_START} and lags the parameters in {probe.ema_lagging}")
    # the recipe's smoothing (0.99975 / 0.9975) moves an fp32 EMA entry by less than
    # its ulp where the parameter moved little: some tensors keep their sum
    if not (probe.changed_by_end == n_params and probe.ema_moved > 0
            and probe.ema_lagging >= 0.9 * n_params):
        raise AssertionError(f"{label}: params changed {probe.changed_by_end}, EMA moved "
                             f"{probe.ema_moved}, lagging {probe.ema_lagging} of {n_params}")
    trainer_ips = steady_rate(ips)

    # the remat comparison on bare steps of BARE_MICROBATCHES microbatches: the
    # per-image time and the peak of a recipe step at a fraction of its cost
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    batch = {key: v.half() if v.dtype == torch.float32 and v.dim() > 1 else v
             for key, v in train_batch(gen, BARE_MICROBATCHES * mb, latent).items()}
    policies = {p: bare_policy(trainer, batch, p, label, train_rec, attribute=attribute)
                for p in ("dots",) + LEAN_POLICIES + ("full",)}
    return trainer, dict(train_rec=train_rec, want=want, want_eval=want_eval, k=k, mb=mb,
                         policy=dit.remat_policy,
                         trainer_ips=trainer_ips, fit_peak=fit_peak, losses=losses,
                         policies=policies, wall=wall)


def run_stage2(tmp):
    """XL stage 2 (256px, mask 0, mb 64, K = 4) through the entry point on the
    [trainer] phase's 256px set, twice: as the H100 overlay stands ('auto': K1, K2,
    K6) and with model.attention_impl=flash_bthd (K5 at every attention site, K1
    never). Each: 4 steps and one eval with the launch counts of every kernel
    checked, bare steps under remat 'full'; under 'auto' also under every other
    remat policy and one lean name, with one microbatch's gradient under each
    against 'full'; under
    'flash_bthd' one microbatch's loss and gradient through the kernels against the
    plain versions."""
    import torch
    from micro_diffusion_tpu_torch.train import cli

    train_dir, eval_dir = os.path.join(tmp, "train"), os.path.join(tmp, "eval")
    runs = {}
    for impl in ("auto", "flash_bthd"):
        label = f"[stage2 {impl}]"
        metrics_path = os.path.join(tmp, f"stage2_{impl}.jsonl")
        probe = TrainerProbe()
        reset_counts()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        trainer = cli.main(stage_argv("res_256_finetune", train_dir, eval_dir, metrics_path,
                                      STAGE2_STEPS, f"model.attention_impl={impl}"),
                           callbacks=[probe])
        wall = time.perf_counter() - t0
        fit_peak = torch.cuda.max_memory_allocated()
        dit = trainer.model.dit
        mb, k = microbatching(trainer)
        log(f"{label} cli.main res_256_finetune: {STAGE2_STEPS} steps of "
            f"{trainer.global_batch_size} (mb {mb}, K = {k}) + eval in {wall:.1f} s (model "
            f"build included); remat '{dit.remat_policy}', mask "
            f"{trainer.model.train_mask_ratio}; peak {fit_peak / 2**30:.2f} GiB (allocated "
            f"before the fit {base / 2**30:.2f} GiB)")
        losses, norms, ips, evals = fit_metrics(metrics_path, STAGE2_STEPS, label)
        train_rec, eval_rec = path_of(trainer, 32)
        want = train_rec.step_launches(k)
        want_eval = eval_rec.forward_launches(-(-EVAL_SAMPLES // trainer.eval_loader.batch_size))
        check_launches(label, probe, want, want_eval, STAGE2_STEPS)
        # under 'flash_bthd' K1 runs only in the caption block, outside the DiT blocks:
        # its self-attention is 'auto' in both packages (JAX layers.py:759)
        attn = (want["attention"], want["attention_bwd"], want["fa"], want["fa_bwd"])
        k1_in_blocks = train_rec.shapes["attention"] - train_rec.outside["attention"]
        ok = (attn[2:] == (0, 0) and attn[0] > 0 if impl == "auto" else
              attn[2] > 0 and attn[3] > 0 and not +k1_in_blocks and attn[:2] == (k, k))
        if not ok:
            raise AssertionError(f"{label}: K1/K1b/K5/K5b launches per step {attn}, K1 in "
                                 f"the blocks {dict(k1_in_blocks)}")
        n_params = len(trainer.state.params)
        log(f"{label} step 1 changed {probe.changed} of {n_params} parameter tensors; "
            f"steps 1-{STAGE2_STEPS - 1} changed {probe.changed_by_end}")
        if not (probe.changed and probe.changed_by_end >= 0.9 * n_params):
            raise AssertionError(f"{label}: step 1 changed {probe.changed}, steps 1-"
                                 f"{STAGE2_STEPS - 1} {probe.changed_by_end} of {n_params}")
        run = dict(train_rec=train_rec, want=want, want_eval=want_eval, k=k, mb=mb,
                   trainer_ips=steady_rate(ips), fit_peak=fit_peak, wall=wall,
                   policy=dit.remat_policy)
        gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
        batch = {key: v.half() if v.dtype == torch.float32 and v.dim() > 1 else v
                 for key, v in train_batch(gen, BARE_MICROBATCHES * mb).items()}
        mb_batch = {key: v[:mb] for key, v in batch.items()}
        if impl == "flash_bthd":
            run["cmp"] = compare_train_grads(trainer.model, mb_batch, gen, label=label)
            policies = ("full",)
        else:
            policies = REMAT_POLICIES + LEAN_POLICIES[-1:]
            run["remat_rel"] = remat_grads_agree(trainer.model, mb_batch, gen, label,
                                                 policies[1:])
        run["policies"] = {p: bare_policy(trainer, batch, p, label, train_rec)
                           for p in policies}
        runs[impl] = run
        del trainer, dit, batch, mb_batch
        free_memory()
    return runs


# ------------------------------------------------------------------ options


class InitProbe(TrainerProbe):
    """TrainerProbe that also keeps a copy of the parameters as the fit starts."""

    def fit_start(self, trainer):
        super().fit_start(trainer)
        self.init = {k: p.detach().clone() for k, p in trainer.state.params.items()}


def rel_l2(got, ref, base=None):
    """|got - ref| / |ref - base| over whole {name: tensor} dicts (|ref| without
    ``base``), in float64."""
    diff2 = sum((got[k].double() - ref[k].double()).square().sum() for k in ref)
    den2 = sum((ref[k].double() - (base[k].double() if base else 0)).square().sum()
               for k in ref)
    return (diff2.sqrt() / den2.sqrt()).item()


def run_options_accum(tmp):
    """[options] (a): the XL stage-1 recipe through cli.main with the v5e stage-1
    overlay's trainer block (mb 128, K = 2, a bf16 gradient accumulator), on the
    [trainer] set: OPTIONS_STEPS steps under accum_mode 'scan', 'dispatch' (bitwise
    equal to scan) and 'dispatch' with param_flow_dtype bfloat16 (within
    OPTIONS_FLOW_TOL of scan), each with the launch counts of every step checked."""
    import torch
    from micro_diffusion_tpu_torch.train import cli

    train_dir, eval_dir = os.path.join(tmp, "train"), os.path.join(tmp, "eval")
    modes = {"scan": ["trainer.accum_mode=scan"],
             "dispatch": ["trainer.accum_mode=dispatch"],
             "dispatch_flow": ["trainer.accum_mode=dispatch",
                               "trainer.param_flow_dtype=bfloat16"]}
    runs, ref = {}, None
    for name, extra in modes.items():
        label = f"[options] {name}"
        metrics_path = os.path.join(tmp, f"options_{name}.jsonl")
        probe = InitProbe()
        reset_counts()
        base = torch.cuda.memory_allocated()  # the reference copies kept below
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        trainer = cli.main(stage_argv(
            "res_256_pretrain", train_dir, eval_dir, metrics_path, OPTIONS_STEPS,
            f"trainer.device_train_microbatch_size={OPTIONS_MB}", "dataset.train_batch_size=256",
            "trainer.grad_accum_dtype=bfloat16", "trainer.eval_interval=0", *extra),
            callbacks=[probe])
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        mb, k = microbatching(trainer)
        losses, norms, ips, _ = fit_metrics(metrics_path, OPTIONS_STEPS, label, evals_want=0)
        train_rec, _ = path_of(trainer, 32)
        check_launches(label, probe, train_rec.step_launches(k), None, OPTIONS_STEPS)
        log(f"{label}: accum_mode {trainer.accum_mode}, grad_accum_dtype "
            f"{trainer.accum_dtype}, param_flow_dtype {trainer.param_flow_dtype}, mb {mb}, "
            f"K = {k}: {OPTIONS_STEPS} steps in {wall:.1f} s (model build included); peak "
            f"{peak / 2**30:.2f} GiB above the {base / 2**30:.2f} GiB held before the fit")
        params = {n: p.detach().clone() for n, p in trainer.state.params.items()}
        run = dict(losses=losses, norms=norms, ips=ips, peak=peak, wall=wall)
        if ref is None:
            ref = dict(params=params, init=probe.init, losses=losses)
        else:
            equal = sum(bool(torch.equal(params[n], ref["params"][n])) for n in params)
            drift = rel_l2(params, ref["params"], ref["init"])
            loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref["losses"]))
            run.update(equal=equal, drift=drift, loss_rel=loss_rel)
            log(f"{label} against scan: {equal} of {len(params)} parameter tensors bitwise "
                f"equal; |p - p_scan| / |p_scan - p_init| {drift:.3e}; losses {losses} vs "
                f"{ref['losses']} (largest relative difference {loss_rel:.3e})")
            if name == "dispatch" and (equal != len(params) or losses != ref["losses"]):
                raise AssertionError(f"{label}: dispatch must equal scan bit for bit: "
                                     f"{equal} of {len(params)} tensors, losses {losses}")
            if name == "dispatch_flow" and not (drift <= OPTIONS_FLOW_TOL
                                                 and loss_rel <= OPTIONS_LOSS_TOL):
                raise AssertionError(f"{label}: drift {drift} (tol {OPTIONS_FLOW_TOL}), "
                                     f"loss rel {loss_rel} (tol {OPTIONS_LOSS_TOL})")
        runs[name] = run
        del trainer, params, probe
        free_memory()
    return runs


def hc_timing(trainer, batch):
    """One hostcompute EMA update on the trainer's parameters, timed on the host: the
    call (the bf16 copies taken, the side-stream copies and the host decays queued),
    a bare step started right after it (whether the copies or decays were still in
    flight when it started, and its time against a step with no update before it),
    then the wait for the rest; and one update waited for whole."""
    import torch

    hc = trainer._hc_ema
    plain = bare_steps(trainer, batch, 2)[-1]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hc.update(trainer.state.params)
    call_ms = (time.perf_counter() - t0) * 1e3
    in_flight = hc.pending()
    after = bare_steps(trainer, batch, 1)[0]
    t0 = time.perf_counter()
    hc.block()
    rest_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hc.update(trainer.state.params)
    hc.block()
    whole_ms = (time.perf_counter() - t0) * 1e3
    return dict(call_ms=call_ms, in_flight_at_next_step=in_flight, step_after_ms=after,
                step_plain_ms=plain, wait_after_step_ms=rest_ms, whole_update_ms=whole_ms,
                chunks=len(hc.chunks), host_gib=hc.total_elems * 4 / 2**30)


def hc_offload_agrees(trainer, batch):
    """An offloaded ``HostComputeEMA`` (fp32 chunks in pinned host memory, the bf16
    copies on a side stream, the decay on the host's worker thread) against one with
    ``offload=False`` (chunks and decay on the card), on the trainer's parameters at
    smoothing HC_CHECK_SMOOTHING: HC_CHECK_UPDATES rounds of a bare step and an update
    of each, the next step started without waiting for the offloaded copy and decay
    (the step overwrites the parameters in place), then two updates back to back (the
    second reuses the staging buffers). The arithmetic is the same on both sides, so
    the chunks must be bitwise equal; and the EMA must differ from the bf16 copy of
    the current parameters (the decays mixed more than one copy)."""
    import torch
    from micro_diffusion_tpu_torch.train.host_ema import HostComputeEMA

    params = trainer.state.params
    t0 = time.perf_counter()
    card = HostComputeEMA(params, HC_CHECK_SMOOTHING, offload=False)
    host = HostComputeEMA(params, HC_CHECK_SMOOTHING)
    made_s = time.perf_counter() - t0
    in_flight = []
    for i in range(HC_CHECK_UPDATES):
        gen = torch.Generator(device="cuda").manual_seed(SEED + 45 + i)
        trainer.state, _ = trainer._step_fn(trainer.state, batch, gen)
        card.update(params)
        host.update(params)
        in_flight.append(host.pending())
    for _ in range(2):
        card.update(params)
        host.update(params)
    host.block()
    torch.cuda.synchronize()
    n = sum(c.numel() for c in card.chunks)
    differ = sum(int((h != c.cpu()).sum()) for h, c in zip(host.chunks, card.chunks))
    mixed = sum(int((c != card._layout.wire(params, k, torch.bfloat16).float()).sum())
                for k, c in enumerate(card.chunks))
    log(f"[options] offloaded HostComputeEMA against offload=False, smoothing "
        f"{HC_CHECK_SMOOTHING}, {HC_CHECK_UPDATES} updates each followed at once by a step "
        f"(copies or decays in flight as it started: {in_flight}) and 2 back to back: "
        f"{differ} of {n} fp32 elements differ (want 0); the EMA differs from the bf16 copy "
        f"of the current parameters in {mixed} ({mixed / n:.3f}); both made in {made_s:.1f} s")
    if differ or not mixed:
        raise AssertionError(f"[options] offloaded HostComputeEMA: {differ} elements differ "
                             f"from the card's, {mixed} mixed")
    del card, host
    return dict(differ=differ, mixed=mixed, elements=n, in_flight=in_flight)


def run_options_hostcompute(tmp):
    """[options] (b): XL stage 4 through cli.main with the H100 overlay at batch
    HC_BATCH (2 microbatches of 16), HC_STEPS steps, twice: the EMA in the state in
    fp32 from step 2 (it mirrors the parameters before), and placement 'hostcompute'
    from step 1 (made then from the parameters: JAX's mirror): the same EMA up to
    the placement's bf16 copy, and the parameters bitwise equal. Then the EMA
    update's host times (hc_timing) and the offloaded update against one on the card
    (hc_offload_agrees)."""
    import torch
    from micro_diffusion_tpu_torch.train import cli

    train_dir, eval_dir = os.path.join(tmp, "train512"), os.path.join(tmp, "eval512")
    placements = {"in_state": ["algorithms.ema.ema_start=2ba"],
                  "hostcompute": ["algorithms.ema.placement=hostcompute",
                                  "algorithms.ema.ema_start=1ba"]}
    out, ema = {}, {}
    for name, extra in placements.items():
        label = f"[options] stage 4 EMA {name}"
        metrics_path = os.path.join(tmp, f"options_{name}.jsonl")
        probe = TrainerProbe()
        reset_counts()
        base = torch.cuda.memory_allocated()  # the in_state run's copies, kept below
        torch.cuda.reset_peak_memory_stats()
        trainer = cli.main(stage_argv(
            "res_512_finetune", train_dir, eval_dir, metrics_path, HC_STEPS,
            f"dataset.train_batch_size={HC_BATCH}", "trainer.eval_interval=0",
            "algorithms.ema.update_interval=1ba", *extra), callbacks=[probe])
        peak = torch.cuda.max_memory_allocated() - base
        mb, k = microbatching(trainer)
        losses, _, ips, _ = fit_metrics(metrics_path, HC_STEPS, label, evals_want=0)
        train_rec, _ = path_of(trainer, 64)
        check_launches(label, probe, train_rec.step_launches(k), None, HC_STEPS)
        with trainer.eval_weights():
            ema[name] = {n: p.detach().clone() for n, p in trainer.state.params.items()}
        run = dict(params={n: p.detach().clone() for n, p in trainer.state.params.items()},
                   losses=losses, ips=ips, peak=peak)
        log(f"{label}: placement {trainer.ema_placement}, in the state "
            f"{trainer.state.ema_params is not None}, mb {mb}, K = {k}; losses {losses}; "
            f"peak {peak / 2**30:.2f} GiB above the {base / 2**30:.2f} GiB held before")
        if name == "hostcompute":
            if trainer._hc_ema is None or trainer.state.ema_params is not None:
                raise AssertionError(f"{label}: the EMA is not off the state")
            gen = torch.Generator(device="cuda").manual_seed(SEED + 40)
            batch = {key: v.half() if v.dtype == torch.float32 and v.dim() > 1 else v
                     for key, v in train_batch(gen, HC_BATCH, 64).items()}
            run["timing"] = hc_timing(trainer, batch)
            run["offload"] = hc_offload_agrees(trainer, batch)
        out[name] = run
        del trainer
        free_memory()
    a, b = out["in_state"], out["hostcompute"]
    n_params = len(a["params"])
    equal = sum(bool(torch.equal(a["params"][n], b["params"][n])) for n in a["params"])
    rel = rel_l2(ema["hostcompute"], ema["in_state"])
    lagging = sum(not torch.equal(ema["hostcompute"][n], b["params"][n]) for n in b["params"])
    t = b["timing"]
    log(f"[options] stage 4 EMA hostcompute against in_state (fp32): parameters {equal} of "
        f"{n_params} bitwise equal; EMA relative L2 {rel:.3e} (tol {HC_EMA_TOL}), lagging "
        f"the parameters in {lagging}")
    log(f"[options] hostcompute update ({t['chunks']} chunks, {t['host_gib']:.2f} GiB fp32 "
        f"pinned): the call {t['call_ms']:.1f} ms on the host; copies or decays still in "
        f"flight when the next step started: {t['in_flight_at_next_step']}; that step "
        f"{t['step_after_ms']:.1f} ms against {t['step_plain_ms']:.1f} ms with no update "
        f"before it; then {t['wait_after_step_ms']:.1f} ms more to wait for the decay; one "
        f"update waited for whole {t['whole_update_ms']:.1f} ms ({smi_line()})")
    if not (equal == n_params and rel <= HC_EMA_TOL and lagging >= 0.9 * n_params):
        raise AssertionError(f"[options] hostcompute: params equal {equal}, EMA rel {rel}, "
                             f"lagging {lagging} of {n_params}")
    return dict(ema_rel=rel, params_equal=equal, timing=t, offload=b["offload"],
                losses={n: r["losses"] for n, r in out.items()})


def run_options_flow(trainer, unset=None, label="[options] stage 4"):
    """[options] (c): bare XL stage-4 steps of BARE_MICROBATCHES microbatches under
    remat 'full' on the [stage4] trainer with param_flow_dtype bfloat16 (a warm-up,
    BARE_TIMED timed steps with the launch counts checked, one profiled step), right
    after [stage4]'s bare steps with it unset (``unset``, bare_policy's result; run
    here first when not given): the step time, the peak and the device's idle share
    of each. The flow step is the trainer's own (``_make_step``) with only the flow
    dtype changed: the same accumulator, ZeRO-2 setting and in-state EMA update."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)  # [stage4]'s batch
    mb, _ = microbatching(trainer)
    batch = {key: v.half() if v.dtype == torch.float32 and v.dim() > 1 else v
             for key, v in train_batch(gen, BARE_MICROBATCHES * mb, 64).items()}
    train_rec, _ = path_of(trainer, 64)
    if unset is None:
        unset = bare_policy(trainer, batch, "full", f"{label} param_flow_dtype unset",
                            train_rec, profile=True)
    step_fn, flow_dtype = trainer._step_fn, trainer.param_flow_dtype
    trainer.param_flow_dtype = torch.bfloat16
    trainer._step_fn = trainer._make_step()
    flow = bare_policy(trainer, batch, "full", f"{label} param_flow_dtype bfloat16",
                       train_rec, profile=True)
    trainer._step_fn, trainer.param_flow_dtype = step_fn, flow_dtype
    a, b = unset, flow
    log(f"{label} param_flow_dtype under remat 'full', batch {BARE_MICROBATCHES * mb}: "
        f"unset {a['ms']:.1f} ms ([stage4]'s steps), peak {a['peak'] / 2**30:.2f} GiB, idle "
        f"share {share(a['profile']['idle'])} (busy {a['profile']['busy']} ms); bfloat16 "
        f"{b['ms']:.1f} ms, peak {b['peak'] / 2**30:.2f} GiB, idle share "
        f"{share(b['profile']['idle'])} (busy {b['profile']['busy']} ms) ({smi_line()})")
    return {name: {k: r[k] for k in ("ms", "img_per_s", "peak", "times", "profile")}
            for name, r in (("unset", a), ("bfloat16", b))}


def run_sample512(model, prompts=SAMPLE512_PROMPTS, steps=STEPS):
    """The serving path at 512px: a 30-step CFG-5 generate() with the stage-4 model."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    y = torch.randn(prompts, 77, 1024, generator=gen, device="cuda")
    x = torch.randn(prompts, 4, 64, 64, generator=gen, device="cuda")
    with torch.no_grad(), record_path(model.dit) as rec:
        model.model_forward_wrapper(x, torch.full((1,), 2.5, device="cuda"), y, cfg=5.0)
    want = rec.forward_launches(2 * steps - 1)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    latents = model.generate(text_embeddings=y, guidance_scale=5.0, num_inference_steps=steps,
                             seed=SEED, return_only_latents=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = read_counts()
    log(f"[sample512] generate: {prompts} prompts at 512px, {steps} Heun steps, CFG 5.0: "
        f"{wall * 1e3:.1f} ms, {prompts / wall:.4f} img/s; launches {got}, expected {want}")
    if tuple(latents.shape) != (prompts, 4, 64, 64) or not bool(torch.isfinite(latents).all()):
        raise AssertionError(f"512px latents: shape {tuple(latents.shape)}, finite "
                             f"{bool(torch.isfinite(latents).all())}")
    if got != want:
        raise AssertionError(f"512px generate launch counts {got} != {want}")
    profile_forward(model, x, torch.full((1,), 2.5, device="cuda"), y,
                    label=f"XL 512px CFG forward (B={2 * prompts})")
    return dict(rec=rec, launches=got, wall_ms=wall * 1e3, img_per_s=prompts / wall,
                latents_std=latents.float().std().item())


# ------------------------------------------------------------------ chain


def run_chain(tmp):
    """MicroDiT-Tiny through the stage handoffs on the card: stage 2 (256px) saves;
    stage 3 (512px) loads its weights only, pos_embed rebuilt at 1024 tokens, and
    saves with its EMA; stage 4 loads stage 3's full state, which must equal the
    saved one bit for bit; 2 steps each, one eval at the end; exact launch counts."""
    import torch
    from micro_diffusion_tpu_torch.train import cli
    from micro_diffusion_tpu_torch.train.config import load_config
    from micro_diffusion_tpu_torch.train.trainer import CKPT_FILE

    def stage(config, data, latent, steps, probe, *extra):
        metrics = os.path.join(tmp, f"chain_{config}.jsonl")
        suffix = "" if data == 256 else "512"  # the [trainer] and [stage3] datasets
        argv = stage_argv(config, os.path.join(tmp, "train" + suffix),
                          os.path.join(tmp, "eval" + suffix), metrics, steps,
                          "model.dit_arch=MicroDiT_Tiny_2",
                          f"dataset.train_batch_size={CHAIN_BATCH}",
                          f"trainer.save_folder={os.path.join(tmp, 'chain_' + config)}", *extra)
        cfg = load_config(argv[1], argv[3], argv[4:])
        reset_counts()
        trainer = cli.build_from_config(cfg, callbacks=[probe])
        return trainer, metrics

    def fit(trainer, label, latent, metrics, steps, evals):
        trainer.fit()
        trainer.close()
        rows = read_jsonl(metrics)
        losses = [r["loss/train/total"] for r in rows if "loss/train/total" in r]
        if len(losses) != steps or not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"{label} losses {losses}")
        train_rec, eval_rec = path_of(trainer, latent)
        want = train_rec.step_launches(microbatching(trainer)[1])
        want_eval = eval_rec.forward_launches(
            -(-STAGE_EVAL_SAMPLES // trainer.eval_loader.batch_size)) if evals else None
        log(f"{label} losses {losses}")
        check_launches(label, probe, want, want_eval, steps)
        return train_rec, want

    t0 = time.perf_counter()
    probe = TrainerProbe()
    s2, m2 = stage("res_256_finetune", 256, 32, CHAIN_STEPS, probe, "trainer.eval_interval=0")
    rec2, want2 = fit(s2, "[chain] stage 2", 32, m2, CHAIN_STEPS, False)
    saved2 = {k: p.detach().clone() for k, p in s2.state.params.items()}
    del s2

    probe = TrainerProbe()
    s3, m3 = stage("res_512_pretrain", 512, 64, CHAIN_STEPS, probe, "trainer.eval_interval=0",
                   f"trainer.load_path={os.path.join(tmp, 'chain_res_256_finetune')}",
                   "algorithms.ema.ema_start=1ba")
    dit = s3.model.dit
    strict = set(s3.state.params) == set(saved2)
    loaded = sum(bool(torch.equal(s3.state.params[k], p)) for k, p in saved2.items())
    log(f"[chain] stage 3 weights-only load: {loaded} of {len(saved2)} parameters equal "
        f"stage 2's, key sets equal {strict}; pos_embed {tuple(dit.pos_embed.shape)}; step "
        f"{s3.state.step}")
    if not (strict and loaded == len(saved2) and tuple(dit.pos_embed.shape) == (1, 1024, dit.dim)
            and s3.state.step == 0):
        raise AssertionError("stage 3 weights-only load across the pos_embed change failed")
    del saved2
    rec3, want3 = fit(s3, "[chain] stage 3", 64, m3, CHAIN_STEPS, False)
    del s3
    ckpt3 = torch.load(os.path.join(tmp, "chain_res_512_pretrain", str(CHAIN_STEPS), CKPT_FILE),
                       map_location="cuda", weights_only=True)

    probe = TrainerProbe()
    s4, m4 = stage("res_512_finetune", 512, 64, 2 * CHAIN_STEPS, probe,
                   f"trainer.load_path={os.path.join(tmp, 'chain_res_512_pretrain')}",
                   "trainer.save_folder=null", "algorithms.ema.ema_start=1ba")
    st = s4.state
    same = {"params": all(torch.equal(st.params[k], v) for k, v in ckpt3["params"].items()),
            "mu": all(torch.equal(st.opt_state.mu[k], v)
                      for k, v in ckpt3["opt_state"]["mu"].items()),
            "nu": all(torch.equal(st.opt_state.nu[k], v)
                      for k, v in ckpt3["opt_state"]["nu"].items()),
            "ema": all(torch.equal(st.ema_params[k], v) for k, v in ckpt3["ema_params"].items()),
            "step": st.step == ckpt3["step"] == CHAIN_STEPS,
            "count": st.opt_state.count == ckpt3["opt_state"]["count"],
            "keys": set(st.params) == set(ckpt3["params"])}
    log(f"[chain] stage 4 full-state load equals stage 3's saved state: {same}")
    if not all(same.values()):
        raise AssertionError(f"stage 4 full-state load differs from stage 3's save: {same}")
    del ckpt3
    rec4, want4 = fit(s4, "[chain] stage 4", 64, m4, CHAIN_STEPS, True)
    if not (want3["bh"] and want3["bh_bwd"] and want4["bh"] and want4["bh_bwd"]):
        raise AssertionError(f"K4 did not run on the 512px Tiny path: {want3}, {want4}")
    wall = time.perf_counter() - t0
    log(f"[chain] Tiny 2 -> 3 -> 4 (batch {CHAIN_BATCH}): {wall:.1f} s")
    del s4
    return dict(rec3=rec3, rec4=rec4, want2=want2, want3=want3, want4=want4, wall=wall)


# ------------------------------------------------------------------- main


def summarize(name, source, replaces, per_shape, path_counts, launches, key, flops_bytes,
              per, peak_flops=PEAK_BF16_FLOPS):
    """One kernel entry: times and bounds summed over the calls of one forward or
    step (``per``). ``key(row)`` is a row's shape tuple, the arguments of
    ``flops_bytes``."""
    rows = {key(r): r for r in per_shape}
    tot = collections.defaultdict(float)
    lib_known = True
    chain = bool(per_shape) and all("library_chain_ms" in r for r in per_shape)
    for shape, count in path_counts.items():
        r = rows[shape]
        for f in ("ms", "plain_ms", "bound_ms") + (("library_chain_ms",) if chain else ()):
            tot[f] += count * r[f]
        if r["library_ms"] is None:
            lib_known = False
        else:
            tot["library_ms"] += count * r["library_ms"]
    flops = sum(c * flops_bytes(*s)[0] for s, c in path_counts.items())
    nbytes = sum(c * flops_bytes(*s)[1] for s, c in path_counts.items())
    entry = {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches,
        "max_abs_err": max((r["max_abs_err"] for r in per_shape), default=None),
        "ms": tot["ms"], "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
        "bound_by": "operations" if flops / peak_flops >= nbytes / PEAK_BYTES else "bytes",
        "library_ms": tot["library_ms"] if lib_known else None,
        "per": per,
        "shapes": per_shape,
    }
    if chain:  # the MoE kernels: a chain of library calls for context, not one call
        entry["library_chain_ms"] = tot["library_chain_ms"]
    return entry


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    try:
        from micro_diffusion_tpu_torch.datasets import native
        from micro_diffusion_tpu_torch.ops import _build
    except ImportError as err:
        print(f"chip_smoke: the port's package is not beside this script: {err}",
              file=sys.stderr)
        return 1

    # ---- 1. device
    smi = smi_line()
    log(f"[device] {smi}; torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = t0 = time.perf_counter()
    logs = _build.build_all()
    log(f"[device] kernels built in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    native.available()  # built up front as the kernels are, so [trainer]'s wait is reads
    log(f"[device] the native MDS gather ({os.path.basename(native.library_path())}) built "
        f"with g++ in {time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or (
                    name.startswith("moe") and "entry function" in line):
                log(f"[ptxas {name}] {line.strip()}")

    # ---- 2. kernels
    t_phase = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    attn_rows, moe_rows, attn_bwd_rows, moe_bwd_rows, adaln_rows = [], [], [], [], []
    for shape in ATTN_SHAPES:
        r = check_attention(shape, gen)
        attn_rows.append(r)
        log(f"[kernels] attention {json.dumps(r)}")
    for shape in MOE_SHAPES:
        r = check_moe(shape, gen)
        moe_rows.append(r)
        log(f"[kernels] moe_ffn {json.dumps(r)}")
    for shape in ATTN_BWD_SHAPES:
        r = check_attention_bwd(shape, gen)
        attn_bwd_rows.append(r)
        log(f"[kernels] attention_bwd {json.dumps(r)}")
    for shape in MOE_BWD_SHAPES:
        r = check_moe_bwd(shape, gen)
        moe_bwd_rows.append(r)
        log(f"[kernels] moe_ffn_bwd {json.dumps(r)}")
    for shape in ADALN_SHAPES:
        r = check_adaln(shape, gen)
        adaln_rows.append(r)
        log(f"[kernels] layernorm_modulate {json.dumps(r)}")
    log(f"[phase] kernels {time.perf_counter() - t_phase:.1f} s")

    # ---- 3. slice, and the prompt -> image path at 256px; T5-XXL
    t_phase = time.perf_counter()
    tok_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_bpe_")
    enc = build_encoders(tok_dir.name)
    res = run_slice(STEPS, PROMPTS, enc)
    log(f"[phase] slice {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    t5 = run_t5()
    log(f"[phase] serve t5 {time.perf_counter() - t_phase:.1f} s")

    # ---- 4. train
    t_phase = time.perf_counter()
    tr = run_train()
    log(f"[phase] train {time.perf_counter() - t_phase:.1f} s")

    # ---- 5. trainer, 6. resume, 7-9. the 512px stages, sampling and chain (seeded
    # datasets and the chain's checkpoints, removed at the end)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        t_phase = time.perf_counter()
        tn = run_trainer(tmp)
        log(f"[phase] trainer {time.perf_counter() - t_phase:.1f} s")
        t_phase = time.perf_counter()
        rs = run_resume(tmp)
        log(f"[phase] resume {time.perf_counter() - t_phase:.1f} s")
        free_memory()

        # ---- the parallel layer: one-rank NCCL XL round trip, 2 gloo ranks
        t_phase = time.perf_counter()
        ds = run_dist(tmp, tn)
        log(f"[phase] dist {time.perf_counter() - t_phase:.1f} s")

        # ---- XL stage 2 under 'auto' and 'flash_bthd' (K5), the remat policies
        t_phase = time.perf_counter()
        s2 = run_stage2(tmp)
        log(f"[phase] stage2 {time.perf_counter() - t_phase:.1f} s")

        # ---- 7. stage 3, with the 'gather' layer's determinism on the card
        t_phase = time.perf_counter()
        trainer, s3 = run_stage(tmp, "res_512_pretrain", "[stage3]")
        from micro_diffusion_tpu_torch.models.layers import FeedForwardECMoe
        mixer_moe = next(blk.mlp for blk in trainer.model.dit.patch_mixer
                         if isinstance(blk.mlp, FeedForwardECMoe))
        gather_determinism(mixer_moe, gen, s3["mb"], 1024)
        del trainer, mixer_moe
        free_memory()
        log(f"[phase] stage3 {time.perf_counter() - t_phase:.1f} s")

        # ---- 8. stage 4 and one microbatch kernels-vs-plain; the 512px sampler
        t_phase = time.perf_counter()
        trainer, s4 = run_stage(tmp, "res_512_finetune", "[stage4]", attribute=True)
        gen4 = torch.Generator(device="cuda").manual_seed(SEED + 8)
        batch = {key: v.half() if v.dtype == torch.float32 and v.dim() > 1 else v
                 for key, v in train_batch(gen4, s4["mb"], 64).items()}
        s4["cmp"] = compare_train_grads(trainer.model, batch, gen4, label="[stage4]")
        log(f"[phase] stage4 {time.perf_counter() - t_phase:.1f} s")
        t_phase = time.perf_counter()
        op = {"flow": run_options_flow(trainer, s4["policies"]["full"])}
        log(f"[phase] options flow {time.perf_counter() - t_phase:.1f} s")
        t_phase = time.perf_counter()
        sp = run_sample512(trainer.model)
        sv = run_serve512(trainer.model, enc, sp["rec"].forward_launches(2 * STEPS - 1))
        del trainer, batch
        free_memory()
        log(f"[phase] sample512 {time.perf_counter() - t_phase:.1f} s")

        # ---- the trainer's options: the EMA placements at stage 4, the
        # accumulation modes and param_flow_dtype at stage 1
        t_phase = time.perf_counter()
        op["hostcompute"] = run_options_hostcompute(tmp)
        op["accum"] = run_options_accum(tmp)
        log(f"[phase] options {time.perf_counter() - t_phase:.1f} s")

        # ---- the evaluation path at 512px: images -> FID and GenEval
        t_phase = time.perf_counter()
        ev = run_eval(enc, tmp, torch.Generator(device="cuda").manual_seed(SEED + 20))
        free_memory()
        log(f"[phase] eval {time.perf_counter() - t_phase:.1f} s")

        # ---- the latent precompute: image MDS -> caption and VAE latents
        t_phase = time.perf_counter()
        pc = run_precompute(enc, tmp)
        free_memory()
        log(f"[phase] precompute {time.perf_counter() - t_phase:.1f} s")

        # ---- raw files of the six datasets -> convert -> precompute -> a train step
        t_phase = time.perf_counter()
        pr = run_prepare(enc, tmp)
        del enc
        tok_dir.cleanup()
        free_memory()
        log(f"[phase] prepare {time.perf_counter() - t_phase:.1f} s")

        # ---- 9. the Tiny stage chain 2 -> 3 -> 4
        t_phase = time.perf_counter()
        ch = run_chain(tmp)
        free_memory()
        log(f"[phase] chain {time.perf_counter() - t_phase:.1f} s")

    # time the paths' shapes not already in the lists above
    t_phase = time.perf_counter()
    have = {(r["B"], r["Tq"], r["Tk"], r["H"]) for r in attn_rows}
    fwd_512 = [s3["train_rec"], s4["train_rec"], sp["rec"]]
    rec2a = s2["auto"]["train_rec"]
    for (b, tq, tk, h) in sorted(set(res["attn_shapes"]).union(
            rec2a.shapes["attention"], ev["rec"].shapes["attention"],
            *(rec.shapes["attention"] for rec in fwd_512))):
        if (b, tq, tk, h) not in have:
            attn_rows.append(check_attention((tq, tk, h), gen, b))
            log(f"[kernels] attention {json.dumps(attn_rows[-1])}")
    have = {(r["n"], r["e"], r["k"], r["d"], r["f"]) for r in moe_rows}
    for (n, e, k, d, f) in sorted(res["moe_shapes"]):
        if (n, e, k, d, f) not in have:
            moe_rows.append(check_moe((k, d, f), gen, n, e))
    have = {(r["B"], r["Tq"], r["Tk"], r["H"]) for r in attn_bwd_rows}
    for shape in sorted(set(tr["attn_shapes"]).union(
            rec2a.shapes["attention"], *(rec.shapes["attention"] for rec in fwd_512[:2]))):
        if shape not in have:
            attn_bwd_rows.append(check_attention_bwd(shape, gen))
            log(f"[kernels] attention_bwd {json.dumps(attn_bwd_rows[-1])}")
    have = {(r["n"], r["e"], r["k"], r["d"], r["f"]) for r in moe_bwd_rows}
    for shape in sorted(tr["moe_shapes"]):
        if shape not in have:
            moe_bwd_rows.append(check_moe_bwd(shape, gen))
            log(f"[kernels] moe_ffn_bwd {json.dumps(moe_bwd_rows[-1])}")
    have = {(r["B"], r["T"], r["D"]) for r in adaln_rows}
    all_recs = fwd_512 + [ch["rec3"], ch["rec4"]]
    for shape in sorted(set(tn["adaln_step"]).union(*(rec.shapes["adaln"] for rec in all_recs))):
        if shape not in have:
            adaln_rows.append(check_adaln(shape, gen))
            log(f"[kernels] layernorm_modulate {json.dumps(adaln_rows[-1])}")
    em_rows, em_bwd_rows, bh_rows, bh_bwd_rows, fa_rows, fa_bwd_rows = [], [], [], [], [], []
    train_recs = [s3["train_rec"], s4["train_rec"], ch["rec3"], ch["rec4"]]
    for shape in sorted(set().union(*(rec.shapes["em"] for rec in all_recs))):
        em_rows.append(check_em(shape, gen))
        log(f"[kernels] moe_ffn_expert_major {json.dumps(em_rows[-1])}")
    for shape in sorted(set().union(*(rec.shapes["em"] for rec in train_recs))):
        em_bwd_rows.append(check_em_bwd(shape, gen))
        log(f"[kernels] moe_ffn_expert_major_bwd {json.dumps(em_bwd_rows[-1])}")
    for shape in sorted(set().union(*(rec.shapes["bh"] for rec in train_recs))):
        bh_rows.append(check_bh(shape, gen))
        log(f"[kernels] flash_attention_bh {json.dumps(bh_rows[-1])}")
        bh_bwd_rows.append(check_bh_bwd(shape, gen))
        log(f"[kernels] flash_attention_bh_bwd {json.dumps(bh_bwd_rows[-1])}")
    rec2 = s2["flash_bthd"]["train_rec"]
    for shape in sorted(set(rec2.shapes["fa"]).union(FA_EXTRA_SHAPES)):
        fwd, bwd = check_fa(shape, gen)
        fa_rows.append(fwd)
        fa_bwd_rows.append(bwd)
        log(f"[kernels] flash_attention {json.dumps(fwd)}")
        log(f"[kernels] flash_attention_bwd {json.dumps(bwd)}")
    log(f"[phase] path shapes {time.perf_counter() - t_phase:.1f} s")

    attn_key = lambda r: (r["B"], r["Tq"], r["Tk"], r["H"])
    moe_key = lambda r: (r["n"], r["e"], r["k"], r["d"], r["f"])
    fwd_per = "one XL 256px CFG forward (B=8), summed over its calls"
    step_per = f"one XL stage-1 train step (mb {TRAIN_MB}, K=1), summed over its calls"
    kernels = [
        summarize("flash_attention_lane",
                  "micro_diffusion_tpu_torch/csrc/flash_attention_lane.cu",
                  ATTN_REPLACES, attn_rows, res["attn_shapes"],
                  res["launches"]["attention"], attn_key, attn_flops_bytes, fwd_per),
        summarize("moe_ffn", "micro_diffusion_tpu_torch/csrc/moe_ffn.cu", MOE_REPLACES,
                  moe_rows, res["moe_shapes"], res["launches"]["moe"], moe_key,
                  moe_flops_bytes, fwd_per),
        summarize("flash_attention_lane_bwd",
                  "micro_diffusion_tpu_torch/csrc/flash_attention_lane_bwd.cu",
                  ATTN_BWD_REPLACES, attn_bwd_rows, tr["attn_shapes"],
                  tr["launches"]["attention_bwd"], attn_key, attn_bwd_flops_bytes,
                  step_per),
        summarize("moe_ffn_bwd", "micro_diffusion_tpu_torch/csrc/moe_ffn_bwd.cu",
                  MOE_BWD_REPLACES, moe_bwd_rows, tr["moe_shapes"],
                  tr["launches"]["moe_bwd"], moe_key, moe_bwd_flops_bytes, step_per),
        summarize("layernorm_modulate", "micro_diffusion_tpu_torch/csrc/adaln.cu",
                  ADALN_REPLACES, adaln_rows, tn["adaln_step"], tn["launches"]["adaln"],
                  lambda r: (r["B"], r["T"], r["D"]), adaln_flops_bytes,
                  f"one XL stage-1 trainer step (mb {TRAIN_MB}, K=1, remat "
                  f"'{tn['policy']}'), "
                  "summed over its calls", peak_flops=PEAK_FP32_FLOPS),
    ]
    # the forward kernels also run in the train step: their launches there
    kernels[0]["launches_train_step"] = tr["launches"]["attention"]
    kernels[1]["launches_train_step"] = tr["launches"]["moe"]
    em_key = lambda r: (r["e"], r["m"], r["d"], r["f"])
    bh_key = lambda r: (r["B"], r["Tq"], r["Tk"], r["H"], r["D"])
    rec4, k4 = s4["train_rec"], s4["k"]
    s4_per = (f"one XL stage-4 train step (batch {k4 * s4['mb']}, mb {s4['mb']}, K={k4}, "
              f"remat '{s4['policy']}'), summed over its calls")
    chain_rec, chain_k = ch["rec4"], max(1, CHAIN_BATCH // 16)
    chain_per = (f"one MicroDiT-Tiny stage-4 train step (batch {CHAIN_BATCH}, mb 16, "
                 f"K={chain_k}, remat '{s4['policy']}'), summed over its calls")
    kernels += [
        summarize("moe_ffn_expert_major", "micro_diffusion_tpu_torch/csrc/moe_ffn.cu",
                  EM_REPLACES, em_rows, rec4.step_shapes("em", k4), s4["want"]["em"],
                  em_key, em_flops_bytes, s4_per),
        summarize("moe_ffn_expert_major_bwd", "micro_diffusion_tpu_torch/csrc/moe_ffn_bwd.cu",
                  EM_BWD_REPLACES, em_bwd_rows, rec4.step_shapes("em", k4, True),
                  s4["want"]["em_bwd"], em_key, em_bwd_flops_bytes, s4_per),
        summarize("flash_attention_bh", "micro_diffusion_tpu_torch/csrc/flash_attention_lane.cu",
                  BH_REPLACES, bh_rows, chain_rec.step_shapes("bh", chain_k),
                  ch["want4"]["bh"], bh_key, bh_flops_bytes, chain_per),
        summarize("flash_attention_bh_bwd",
                  "micro_diffusion_tpu_torch/csrc/flash_attention_lane_bwd.cu",
                  BH_BWD_REPLACES, bh_bwd_rows, chain_rec.step_shapes("bh", chain_k, True),
                  ch["want4"]["bh_bwd"], bh_key, bh_bwd_flops_bytes, chain_per),
    ]
    s2b = s2["flash_bthd"]
    s2_per = (f"one XL stage-2 train step (batch {s2b['k'] * s2b['mb']}, mb {s2b['mb']}, "
              f"K={s2b['k']}, remat '{s2b['policy']}', attention_impl 'flash_bthd'), summed "
              "over its calls")
    kernels += [
        summarize("flash_attention", "micro_diffusion_tpu_torch/csrc/flash_attention_lane.cu",
                  FA_REPLACES, fa_rows, rec2.step_shapes("fa", s2b["k"]), s2b["want"]["fa"],
                  bh_key, fa_flops_bytes, s2_per),
        summarize("flash_attention_bwd",
                  "micro_diffusion_tpu_torch/csrc/flash_attention_lane_bwd.cu",
                  FA_BWD_REPLACES, fa_bwd_rows, rec2.step_shapes("fa", s2b["k"], True),
                  s2b["want"]["fa_bwd"], bh_key, fa_bwd_flops_bytes, s2_per),
    ]
    kernels[-1]["also_replaces"] = "micro_diffusion_tpu/ops/flash_attention.py:172"
    for entry in kernels[-6:-4]:
        entry["launches_stage3_step"] = s3["want"][
            "em" if entry["name"].endswith("major") else "em_bwd"]
    kernels[-6]["launches_sample512"] = sp["launches"]["em"]
    kernels[-6]["launches_prompt_generate_512"] = sv["launches"]["em"]
    kernels[0]["launches_prompt_generate_256"] = res["serve"]["launches"]["attention"]
    kernels[1]["launches_prompt_generate_256"] = res["serve"]["launches"]["moe"]
    kernels[-4]["launches_chain_stage3_step"] = ch["want3"]["bh"]
    kernels[-3]["launches_chain_stage3_step"] = ch["want3"]["bh_bwd"]
    # K1 and K1b over one XL stage-2 step under 'auto': the in-step yardstick of K5
    s2a = s2["auto"]
    s2a_per = s2_per.replace("'flash_bthd'", "'auto'")
    for entry, rows, fb, bwd in ((kernels[0], attn_rows, attn_flops_bytes, False),
                                 (kernels[2], attn_bwd_rows, attn_bwd_flops_bytes, True)):
        shapes = rec2a.step_shapes("attention", s2a["k"], bwd)
        sub = summarize(entry["name"], entry["source"], entry["replaces"], rows, shapes,
                        sum(shapes.values()), attn_key, fb, s2a_per)
        entry["stage2_step"] = {f: sub[f] for f in ("per", "launches", "ms", "plain_ms",
                                                   "bound_ms", "bound_by", "library_ms")}
    # K1, K1b and K6 over one XL stage-4 step, at the 512px shapes
    for entry, rows, kind, key, fb, bwd, peak in (
            (kernels[0], attn_rows, "attention", attn_key, attn_flops_bytes, False,
             PEAK_BF16_FLOPS),
            (kernels[2], attn_bwd_rows, "attention", attn_key, attn_bwd_flops_bytes, True,
             PEAK_BF16_FLOPS),
            (kernels[4], adaln_rows, "adaln", lambda r: (r["B"], r["T"], r["D"]),
             adaln_flops_bytes, False, PEAK_FP32_FLOPS)):
        sub = summarize(entry["name"], entry["source"], entry["replaces"], rows,
                        rec4.step_shapes(kind, k4, bwd), sum(rec4.step_shapes(
                            kind, k4, bwd).values()), key, fb, s4_per, peak_flops=peak)
        entry["stage4_step"] = {f: sub[f] for f in ("per", "launches", "ms", "plain_ms",
                                                   "bound_ms", "bound_by", "library_ms")}
    # K1 and K2 over one XL 512px CFG forward of the eval path (onehot, K2 at k = 256)
    ev_per = ("one XL 512px CFG forward (B=8) of the eval path (generate_images, onehot, "
              "fused adaLN off), summed over its calls")
    sub = summarize(kernels[0]["name"], kernels[0]["source"], ATTN_REPLACES, attn_rows,
                    ev["rec"].shapes["attention"], ev["launches"]["attention"], attn_key,
                    attn_flops_bytes, ev_per)
    kernels[0]["eval_512_forward"] = {f: sub[f] for f in (
        "per", "launches", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
    kernels.append(summarize("moe_ffn (512px eval)", kernels[1]["source"], MOE_REPLACES,
                             ev["moe_rows"], ev["rec"].shapes["moe"], ev["launches"]["moe"],
                             moe_key, moe_flops_bytes, ev_per))
    log(f"[slice] sampler {res['sampler_ms']:.1f} ms for {PROMPTS} images, "
        f"{res['img_per_s']:.4f} img/s at 256px; latents std {res['latents_std']:.4f}")
    log(f"[train] stage 1 mb {TRAIN_MB}: {tr['ms_per_step']:.1f} ms/step, "
        f"{tr['img_per_s']:.2f} img/s, peak {tr['peak_bytes'] / 2**30:.2f} GiB, "
        f"remat {REMAT}")
    log(f"[trainer] stage 1 through the entry point (remat '{tn['policy']}'): "
        f"{tn['trainer_ips']:.2f} img/s, bare step {tn['bare_ips']:.2f} img/s "
        f"({tn['bare']['ms']:.1f} ms, peak {tn['bare']['peak'] / 2**30:.2f} GiB), ratio "
        f"{tn['ratio']:.3f}; "
        f"resume: {rs['equal']}/{rs['tensors']} bitwise, rel L2 {rs['rel']:.3e}")
    for label, st in (("[stage3]", s3), ("[stage4]", s4)):
        pol = ", ".join(f"'{p}' {r['ms']:.1f} ms ({r['img_per_s']:.2f} img/s, peak "
                        f"{r['peak'] / 2**30:.2f} GiB)" for p, r in st["policies"].items())
        log(f"{label} through the entry point: {st['trainer_ips']:.2f} img/s (all "
            f"images over all the time after step 2), fit peak {st['fit_peak'] / 2**30:.2f} GiB; "
            f"bare steps {pol}")
    # stage 4 at a doubled microbatch, from each policy's peak: what a step adds to the
    # resident state, doubled (an upper estimate: the gradient accumulator and the
    # optimizer's temporaries do not grow with the microbatch)
    total = torch.cuda.get_device_properties(0).total_memory
    for p, r in s4["policies"].items():
        projected = r["resident"] + 2 * (r["peak"] - r["resident"])
        log(f"[stage4] mb {2 * s4['mb']} under '{p}': resident {r['resident'] / 2**30:.2f} + "
            f"2 x {(r['peak'] - r['resident']) / 2**30:.2f} = {projected / 2**30:.2f} GiB of "
            f"the card's {total / 2**30:.2f}: "
            f"{'fits' if projected < total else 'does not fit'}")
    for impl, run in s2.items():
        pol = ", ".join(f"'{p}' {r['ms']:.1f} ms ({r['img_per_s']:.2f} img/s, peak "
                        f"{r['peak'] / 2**30:.2f} GiB)" for p, r in run["policies"].items())
        log(f"[stage2 {impl}] through the entry point: {run['trainer_ips']:.2f} img/s (all "
            f"images over all the time after step 2), fit peak "
            f"{run['fit_peak'] / 2**30:.2f} GiB; bare steps {pol}")
    log(f"[stage2 flash_bthd] one microbatch kernels vs plain: loss rel "
        f"{s2['flash_bthd']['cmp']['rel_loss']:.3e}, gradient rel L2 "
        f"{s2['flash_bthd']['cmp']['rel_grad']:.3e}")
    rates = (tn["trainer_ips"], s2["auto"]["trainer_ips"], s3["trainer_ips"], s4["trainer_ips"])
    weighted = sum(RECIPE_BATCHES) / sum(n / r for n, r in zip(RECIPE_BATCHES, rates))
    log(f"[recipe] schedule-weighted rate through the entry point (the four overlays as "
        f"they stand, stage 2 'auto'): {weighted:.2f} img/s from stage rates "
        f"{', '.join(f'{r:.2f}' for r in rates)} over {RECIPE_BATCHES} batches")
    log(f"[stage4] one microbatch kernels vs plain: loss rel {s4['cmp']['rel_loss']:.3e}, "
        f"gradient rel L2 {s4['cmp']['rel_grad']:.3e}")
    log(f"[sample512] {sp['wall_ms']:.1f} ms for {SAMPLE512_PROMPTS} images, "
        f"{sp['img_per_s']:.4f} img/s at 512px; latents std {sp['latents_std']:.4f}")
    s256 = res["serve"]
    for label, run, base in (("256px", s256, res["img_per_s"]), ("512px", sv, sp["img_per_s"])):
        log(f"[serve {label}] prompt -> image {run['img_per_s']:.4f} img/s end to end "
            f"(latents only {base:.4f}); ms per image {json.dumps(run['ms_per_image'])}, "
            f"decode share {run['decode_share']:.4f}, peak {run['peak_gib']:.2f} GiB")
    log(f"[serve] {json.dumps(dict(serve_256=s256, serve_512=sv, t5=t5))}")
    log(f"[precompute] {json.dumps(pc)}")
    log(f"[prepare] {json.dumps(pr)}")
    log(f"[options] {json.dumps(op)}")
    log(f"[phase] total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dist-rank"]:  # a rank of [dist gloo] (run_dist_gloo)
        sys.exit(dist_rank_main(sys.argv[2]))
    sys.exit(main())
