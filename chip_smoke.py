#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``geo_deep_learning_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100::

    python3 chip_smoke.py

Phases, each printed with its wall time:

1. device  -- the card's name and power limit (``nvidia-smi``); the card
   must be Hopper (compute capability 9.0); the host: ``os.cpu_count()``,
   the cores this process may use and the cgroup's CPU quota, ``g++
   --version``, whether ``tiffio.h`` and libtiff are present, the free size
   of ``/dev/shm`` and torch's sharing strategy.
1b. host readers -- the C++ tar and TIFF readers (``data/_native.py``)
   built from this checkout, each kind's decoder and why; where libtiff is
   present, every tst patch and label decoded natively equal to the numpy
   codec bit for bit, with the ms a raster of each in one thread.
2. build   -- the port's CUDA kernels: one ``nvcc`` per source, all
   started together, then one link into one library; ptxas's registers,
   stack and spills of the wgmma kernels (the attention backward's, K10's
   bf16 instance, K11) and of every LayerNorm and K1 instance, read from
   the build's ``-Xptxas -v`` log (a spill in a head-dim-64 backward
   kernel, in K10 at head dim 32 or 64, in K11, in any LayerNorm or K1
   instance or in any f32 attention instance fails the run), and the
   dynamic shared memory of the 3xTF32 attention forward's and backward's
   kernels.
3. kernels -- each kernel (K1-K11) against its plain PyTorch
   version on the card, at the main paths' shapes and at ragged ones, with
   its time, the plain version's time, one library call's time where
   PyTorch has one (a yardstick only; the port never calls it) and the
   least time the card could take for the same bytes or operations; for
   K1, K2, K3, K5 and K6 and their library calls also ``clean_ms``, timed
   after an L2 flush that leaves no dirty lines, and the host time of one
   call of every kernel call on the DOFA 512^2 path (K1-K7 through their
   ``gdl::`` operators, the LayerNorm module and the attention with inputs
   requiring gradients) and of their library calls (``op_host_us``); for K1 one kernel a call (the profiler, which also
   gives the grid and the kernel's own time), its f32 instance and the
   cast ``img.to(bf16)`` of the same bytes (``cast_ms``); the 640^2
   attention route (transposes + K8) against K4
   on the same input; the f32 instances of K4/K7 (512^2) and K8/K9 (640^2)
   against their plain f32 versions (``F32_ATTN_REL`` of each output's
   largest value), with SDPA on f32 inputs as the library call and the
   bound of the 3xTF32 route, on which both run their products.
   Then the differentiable operators K2/K3/K4 and K10 (registered
   backwards K5/K6/K7 and torch math) on the card against the same
   operators on CPU copies of their inputs.
4. column  -- the UNet++ finest-column entry point
   (``python -m geo_deep_learning_tpu_torch.tools.bench_column --batch 32
   --size 256``): eight chained K11 legs against the cuDNN column, their
   relative error, and exactly 8 K11 launches per kernel-column call.
   Then the factored resize + 3x3 conv of the DOFA neck and UperNet
   (``ops/fused_upconv.py``) at the 512^2 and two 640^2 shapes, bf16
   autocast against the plain f32 composition (forward and gradients),
   its time and peak memory against resize + conv, and no output-sized
   copy in its forward; and every configured loss on the card against
   CPU copies in f64.

Then, for each model path -- DOFA-base + UperNet, SegFormer mit_b0 +
all-MLP decoder, and UNet++ (ResNet-34 + nested decoder) -- at full width
with seeded random weights:

5. serving path -- the full-width model on two crops (DOFA 128^2,
   SegFormer and UNet++ whole 512^2 patches) on the card (bf16, kernels)
   against the same weights on the CPU (f32, plain versions; for UNet++,
   whose BatchNorms are first calibrated on the two patches, with the
   plain bf16 path as the yardstick); the CLI's ``run(config, "test")``
   over the 100 patches of the ``tst`` split of ``data/waterloo``, then
   ``run(config, "predict")`` into a temporary directory, with exact launch
   counts per batch (DOFA K1-K4 1/4/20/12, SegFormer K1 1 and K10 6,
   UNet++ K1 1); a host-loader / eval-step breakdown; for SegFormer, one
   forward of the Dynamic MiT on a 4-band batch (K1 1, K10 6).
6. training path -- one full-width train step, card (bf16, kernels)
   against CPU (f32, plain versions) with the plain bf16 path as the
   yardstick: loss and gradient cosines (DOFA per encoder-block tensor on
   128^2 crops, then a frozen-encoder step that must launch no K5-K7;
   SegFormer per encoder stage on whole 512^2 patches; UNet++ per encoder
   stage and for the decoder on 256^2 crops); then ``run(config, "fit")``
   for 2 epochs over CSVs written to a temporary directory (``trn`` =
   ``tst`` rows 0-79, ``val`` = rows 80-99, ``tst`` = all 100), whose
   launch counts must be exact per train step (DOFA K1-K7
   1/4/20/12/4/20/12, SegFormer K1 1 and K10 6: its backward is torch
   math, UNet++ K1 1) plus the forward's per evaluated batch, and
   ``run(config, "test")`` from its best checkpoint, which must agree with
   the fit's auto-test. Each ``fit`` carries the recipes' ``trainer.logger``
   node and a ``VisualizationCallback`` with ``max_samples`` 2: its run
   directory must be ``<save_dir>/<run_name>-*`` with the metrics, params
   and archived config, each new best must give two figures (where
   matplotlib imports; else one logged rendering failure), and the first
   val batch's predictions handed to visualization must equal the eval
   step's for that batch from the best checkpoint. Train steps on resident
   batches, a checkpoint write and a profiler breakdown by kernel family
   are timed apart; for DOFA at 512^2 also ``tools/profiling.py``:
   ``StepTimer`` over 6 resident steps (p50 / p95), the first two inside
   ``trace()`` and ``annotate("train_step")``, whose exported Chrome trace
   must hold the annotation and K1-K7's kernels at 1/4/20/12/4/20/12 a step
   (no CUDA events fails the run), its seconds and size on disk, and
   ``device_memory_stats()``; for
   DOFA also the same ``fit`` with ``GrainCSVDataModule`` on 8 spawned
   worker processes (named by its JAX class path): last-epoch train
   patches/s, the workers' start-up apart, the threaded fit's launches, and
   ``test`` from the threaded fit's best checkpoint through both modules
   equal within 1e-6; train steps with the factored neck and UperNet on and
   off in turns, and fit's loop by hand (loader wait, copy to the card,
   step enqueue) on threads with pageable and pinned copies and on the
   worker processes' pinned batches. Every fit prints its reader threads,
   one-thread decode time and TIFF decoder, and after every ``run()`` no
   loader thread, pin-memory thread or worker process may be left.
6a. export -- ``inference/export.py`` on tst patches 0-7 (bs 8, 512^2,
   bf16-mixed, seeded weights): DOFA-base + UperNet with its wavelengths,
   SegFormer mit_b0 and UNet++ resnet34 through ``make_serving_fn`` ->
   ``export_model`` (``torch.export``, symbolic batch, ``.pt2``) ->
   ``load_exported``: export and load s, ``.pt2`` size, the graph's
   ``gdl::`` nodes (DOFA K2/K3/K4 4/20/12, SegFormer K10 6, UNet++
   none), one loaded call launching exactly those kernels, its
   probabilities within ``EXPORT_TOL`` of the eager serving module's;
   DOFA's program loaded again in a fresh process on the same batch
   (equal bit for bit, or the difference and why); DOFA with its
   patch embedding baked (``bake_dofa_embedding``); bs-8 patches/s of
   the eager module, the loaded program and the baked program in turns.
6b. the DOFA recipe -- a synthetic HF-layout DOFA-base artifact as
   ``torch_weights`` with ``freeze_layers: ["encoder"]``: ``fit`` for 2
   epochs (K1-K4 1/4/20/12 per train step, no K5-K7), the encoder equal
   to the converted artifact afterwards, and ``test`` with
   ``weights_from_checkpoint_path`` at the best checkpoint equal to
   ``test`` from it.
6c. the DOFA recipes on the multi-sensor shard stream -- ``tools/make_shards.py``
   writes two sensors from tst rows 0-79 / 80-99 / 80-99 (RGB, and RGB +
   band 0 as a synthetic NIR; 16 patches a shard; a JSON registry);
   ``configs/dofa_config_RGB.yaml``, mirrored as ``RECIPE_RGB``, with that
   registry, ``epoch_size`` 64, 2 epochs and the encoder training: ``fit``
   and ``test`` from its best checkpoint, every batch single-sensor with 3
   or 4 channels, both sensors seen, exact K2-K7 launches and no K1 (the
   stream normalizes on the host), ``valid_count`` summing to the split;
   then one epoch of the OneCycle recipe, whose step count must come from
   ``epoch_size``. The native tar reader must yield exactly ``tarfile``'s
   members of every shard; the ms a batch's members of each, train
   patches/s, host decode ms a batch (with the tar decoder), step ms and
   peak memory are printed.
6d. the round-robin CSV stream -- ``MultiSensorCSVDataModule`` over the tst
   CSV as an RGB and a 4-band sensor (own band indices, statistics and
   wavelengths, ``device_preprocess``): K1 on one batch of each sensor with
   ``[B, C]`` statistics against its plain version, then one DOFA-base
   512^2 ``fit`` epoch with exact K1-K7 launches.
6e. 32-true -- DOFA-base 512^2 ``fit`` of one epoch (10 steps) with exact
   launches of the f32 attention instances and no bf16 K4/K7; one train
   step card vs CPU in f32 (``F32_LIMITS`` per part of the model); two
   640^2 steps at bs 2 on the f32 head-major pair; one SegFormer and one
   UNet++ step (K10's f32 instance; cuDNN), TF32 off for each.
6f. remat -- DOFA-base 512^2 bs 8 bf16 steps with ``remat`` none, ``"mlp"``
   and ``"block"`` in turns: ms, peak memory, the attention forward's
   launches a step (12, 12, 24) and the same loss.
6g. data parallelism -- one process a rank (``core.mesh.launch``): (a) a
   DOFA-base 512^2 ``fit`` (1 epoch; trn tst 0-15, val 16-23, tst 24-31)
   with ``trainer.mesh: {data: -1}`` at NCCL ``device_count()`` ranks
   against the same ``fit`` with no mesh (every metric within
   ``DP_FIT_TOL``); (b)-(d) on two ranks sharing the card over gloo, in one
   launch whose rank 0 also runs the one-rank references: (b) DOFA-base
   512^2 bf16, global bs 8 (tst 0-7, 4 a rank), 3 resident-batch train
   steps: both ranks' parameters and buffers bit-equal, K1-K7 launched a
   rank exactly as a step's, the first loss within ``DP_LIMITS`` of one
   rank's and, against one f32 step, each block's and all gradients'
   cosine no more short of one rank's bf16 cosine than ``DP_LIMITS`` say,
   the norm ratio within them; (c) UNet++ resnet34 256^2 f32, one step:
   every BN running statistic within ``DP_BN_TOL`` of one rank's; (d) the
   sharded (hann) and halo (crop) scene paths over a 2048 x 1536 mosaic of
   tst 0-11 (512 tiles, overlap 128, one tile a batch) against one rank's
   maps: halo bit-identical outside its exchanged strips, strips and the
   sharded map within ``DP_SCENE_TOL`` of the largest logit. A step's ms
   of two ranks sharing the card is printed as correctness only.
6h. tensor parallelism -- (b) K8/K9 alone at a model rank's shape
   ``[8, 6, 1297, 64]`` bf16 against their plain versions (as in 4), with
   their times beside SDPA's and the bound; then one launch of two gloo
   ranks sharing the card as ``{data: 1, model: 2}`` (deadline
   ``DP_DEADLINE_S``), whose rank 0 also runs the one-rank references:
   (a) DOFA-base 512^2 bf16, global bs 8 (tst 0-7, every row on both
   ranks), 3 resident-batch train steps with 6 of the 12 heads a rank: 72
   tensors sharded, every replicated parameter and buffer bit-equal on the
   two ranks, K1-K3/K5/K6/K8/K9 launched a rank exactly
   1/4/20/4/20/12/12 a step and K4/K7 never (the route's mesh clause), the
   first loss and the gathered gradients' cosines to one f32 step within
   ``TP_LIMITS`` of one rank's bf16 step; the ms a step and the bytes
   all-reduced a step are printed as correctness only; (c) SegFormer
   mit_b0 512^2 bf16, one step (K10 on the local heads of the 2- and
   8-head stages): the loss within ``TP_SEG_LOSS`` of one rank's; (d) a
   DOFA-base 512^2 ``fit`` of 1 epoch (trn tst 0-15, val 16-23, tst
   24-31) with ``trainer.mesh: {data: 1, model: 2}``, whose whole best
   checkpoint a one-process ``test`` reads within ``DP_FIT_TOL`` of the
   fit's auto-test.

Then, from the tst split, in a temporary directory:

7. scene and 640^2 data -- the 100 tst patches mosaicked 10 x 10 into one
   5120^2 GeoTIFF with 0.3 m pixels and an EPSG code, and its 64 640^2
   crops (trn 0-47, val 48-55, tst 56-63) with their labels and CSVs.
8. DOFA-base + UperNet at 640^2 -- 2026 tokens, so every block runs K8
   (and K9 in training) in place of K4 (K7): a train step on two 576^2
   crops card against CPU as in 6, ``fit`` for 2 epochs over the crops,
   ``test`` and ``predict`` from its best checkpoint, exact launch counts
   (K1-K3 1/4/20, K8 12 per evaluated batch, and K5/K6/K9 4/20/12 more per
   train step, no K4 or K7), train steps on resident batches.
9. predict-scene -- ``run(config, "predict-scene", scene=SceneOptions(...))``
   (what the CLI's ``predict-scene`` calls) over the scene for each family at the defaults (tile 512, overlap 128, hann) and at tile
   512 / overlap 0 / uniform, where the tiles are the tst patches and the
   blended logits are held against the eval forward of the patches; then
   DOFA-640 from its best checkpoint with 640 tiles, whole and streamed
   (the maps may differ on at most 1e-4 of the pixels, and the f32
   blended logits of the two paths are compared); the maps must be 5120^2 uint8 with the scene's transform and EPSG code and
   the launch counts exact per tile batch (the forward's, without K1).

Every kernel must have been launched by the path that owns it: K1-K7 and
K10 by the ``fit`` runs of their model paths (K1-K4 also by the recipe's,
K2-K7 by the shard stream's, K1-K7 by the round-robin stream's), K11 by
the column entry point, K8 by the DOFA-640 ``fit`` and scene runs, K9 by
that ``fit``, the f32 instances of K4/K7 by the 32-true ``fit`` and of
K8/K9 by its 640^2 steps, K1-K7 by the data-parallel phase's ranks
(the NCCL ``fit``'s rank 0 and both gloo ranks' steps), and K1-K3, K5,
K6, K8 and K9 by the tensor-parallel phase's two ranks' steps (their
launches are added to those kernels' counts).
Prints one JSON line of kernel records (``launches``: the kernel's count
over those owning runs), the ``nvidia-smi`` line, and as the last line
``{"ok": true, "device": {...}}``. Any failed check raises and the script exits non-zero; without
CUDA, or outside a checkout, it exits non-zero before printing any result.
A watchdog ends a hung run after 1100 s; every launch of ranks has its
own deadline (``DP_DEADLINE_S``) and its collectives a timeout.
"""

from __future__ import annotations

import copy
import faulthandler
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable, NamedTuple

WATCHDOG_S = 1100  # under the 1200 s the run may take (a full run: 480-730 s by host)
ROOT = Path(__file__).resolve().parent
DATA = ROOT / "data" / "waterloo"

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_FLOPS = 989e12
TF32_TENSOR_FLOPS = 495e12
F32_FLOPS = 67e12

BATCH = 8
N_TST = 100
N_TRN, N_VAL = 80, 20  # fit: trn = tst rows 0-79, val = rows 80-99
FIT_EPOCHS = 2
VIZ_SAMPLES = 2  # fit_phase's VisualizationCallback max_samples
# kernel launches per 512^2 DOFA-base forward: K1 once; K2 at blocks 0, 5,
# 7, 11 (each starts without a pending branch: taps 4, 6, 10, 11); K3 at
# norm1 of the other 8 blocks and norm2 of all 12; K4 once per block
PER_BATCH = {
    "preprocess": 1,
    "layernorm_fwd": 4,
    "layernorm_residual_fwd": 20,
    "attention_fwd_packed": 12,
}
# and per train step, the forward's plus one backward per forward launch:
# K5 per K2, K6 per K3, K7 per K4 (the unused final norm launches nothing)
PER_TRAIN_STEP = {
    **PER_BATCH,
    "layernorm_bwd": 4,
    "layernorm_residual_bwd": 20,
    "attention_bwd_packed": 12,
}
BACKWARD = ("layernorm_bwd", "layernorm_residual_bwd", "attention_bwd_packed")
# SegFormer mit_b0 at 512^2: K10 in both blocks of stages 1-3 (Lq 16384,
# 4096, 1024 over Lk 256); stage 4 (Lq 256) takes the einsum; its backward
# is torch math, so a train step launches what its forward does
SEG_PER_BATCH = {"preprocess": 1, "sr_attention_fwd": 6}
SEG_PER_TRAIN_STEP = dict(SEG_PER_BATCH)
SEG_COS_GAP = 2.5e-4  # most 1 - cosine of a SegFormer stage's gradients to f32
SOURCES = {
    "preprocess": ("geo_deep_learning_tpu_torch/csrc/preprocess.cu",
                   "geo_deep_learning_tpu/ops/pallas/preprocess.py:33"),
    "layernorm_fwd": ("geo_deep_learning_tpu_torch/csrc/layernorm.cu",
                      "geo_deep_learning_tpu/ops/pallas/layernorm.py:50"),
    "layernorm_residual_fwd": ("geo_deep_learning_tpu_torch/csrc/layernorm.cu",
                               "geo_deep_learning_tpu/ops/pallas/layernorm.py:93"),
    "attention_fwd_packed": ("geo_deep_learning_tpu_torch/csrc/attention.cu",
                             "geo_deep_learning_tpu/ops/pallas/mha.py:255"),
    "layernorm_bwd": ("geo_deep_learning_tpu_torch/csrc/layernorm.cu",
                      "geo_deep_learning_tpu/ops/pallas/layernorm.py:64"),
    "layernorm_residual_bwd": ("geo_deep_learning_tpu_torch/csrc/layernorm.cu",
                               "geo_deep_learning_tpu/ops/pallas/layernorm.py:116"),
    "attention_bwd_packed": ("geo_deep_learning_tpu_torch/csrc/attention_bwd.cu",
                             "geo_deep_learning_tpu/ops/pallas/mha.py:299"),
    "sr_attention_fwd": ("geo_deep_learning_tpu_torch/csrc/sr_attention.cu",
                         "geo_deep_learning_tpu/ops/pallas/sr_attention.py:34"),
    "packed_conv_bn_stats": ("geo_deep_learning_tpu_torch/csrc/packed_conv.cu",
                             "geo_deep_learning_tpu/ops/pallas/packed_conv.py:83"),
    "attention_fwd_hm": ("geo_deep_learning_tpu_torch/csrc/attention_hm.cu",
                         "geo_deep_learning_tpu/ops/pallas/mha.py:56"),
    "attention_bwd_hm": ("geo_deep_learning_tpu_torch/csrc/attention_hm_bwd.cu",
                         "geo_deep_learning_tpu/ops/pallas/mha.py:85"),
    # the f32 instances (32-true) of K4, K7, K8 and K9
    "attention_fwd_f32": ("geo_deep_learning_tpu_torch/csrc/attention_fwd_tf32.cuh",
                          "geo_deep_learning_tpu/ops/pallas/mha.py:255"),
    "attention_bwd_f32": ("geo_deep_learning_tpu_torch/csrc/attention_bwd_tf32.cuh",
                          "geo_deep_learning_tpu/ops/pallas/mha.py:299"),
    "attention_fwd_hm_f32": ("geo_deep_learning_tpu_torch/csrc/attention_fwd_tf32.cuh",
                             "geo_deep_learning_tpu/ops/pallas/mha.py:56"),
    "attention_bwd_hm_f32": ("geo_deep_learning_tpu_torch/csrc/attention_bwd_tf32.cuh",
                             "geo_deep_learning_tpu/ops/pallas/mha.py:85"),
}
# DOFA-base at 640^2: 45 x 45 tokens + cls = 2026, past the packed kernels'
# budget (1592) and inside the head-major kernels' (a padded 2304), so every
# block runs K8 in place of K4 (and K9 in place of K7), as on one TPU
PER_BATCH_640 = {
    "preprocess": 1,
    "layernorm_fwd": 4,
    "layernorm_residual_fwd": 20,
    "attention_fwd_hm": 12,
}
PER_TRAIN_STEP_640 = {
    **PER_BATCH_640,
    "layernorm_bwd": 4,
    "layernorm_residual_bwd": 20,
    "attention_bwd_hm": 12,
}
# the 640^2 data, cut from the scene below: 64 non-overlapping crops, trn
# 0-47 (6 steps an epoch), val 48-55, tst 56-63 (one batch each)
SIZE_640 = 640
# the card-vs-CPU train step of that path: two 576^2 crops, 41 x 41 tokens
# + cls = 1682, inside the head-major band
TRAIN_CHECK_640 = 576
# train_reference_check's limits (loss off f32, a tensor's cosine short of
# the plain bf16 path's, all tensors' cosine short of it, norm ratio off 1):
# a priori at 128^2; at 576^2 from the readings on an H100 80GB HBM3 (loss
# off by 5e-6, shortfalls 0.0019 and 0.0004, ratio 0.9975), about ten times
# each reading and 1e-3 for the loss (128^2 reads 1.4e-4)
TRAIN_LIMITS = (2e-2, 0.1, 0.02, 0.1)
TRAIN_LIMITS_640 = (1e-3, 0.02, 0.005, 0.02)
N_TRN_640, N_VAL_640, N_TST_640 = 48, 8, 8
# the scene: the 100 tst patches (512^2) mosaicked 10 x 10 in row order,
# with 0.3 m pixels in UTM zone 17N
SCENE_GRID = 10
SCENE_PX = SCENE_GRID * 512
SCENE_TRANSFORM = (0.3, 0.0, 537000.0, 0.0, -0.3, 4815000.0)
SCENE_EPSG = 32617
# streamed and whole-scene class maps may differ where a tile's logits move
# with its batch's composition (bf16 GEMMs)
SCENE_STREAMED_DIFF = 1e-4
# ... and their f32 blended logits by at most this: the reading on an H100
# 80GB HBM3 was 2.9e-6 on logits up to 30 (f32 sum order in the rows two
# bands share); a band carry that drops or doubles a tile's share moves the
# overlap rows' logits by a sizable fraction of their value
SCENE_STREAMED_LOGITS = 1e-4
# UNet++ (resnet34): K1 once per evaluated batch and per train step; its
# convolutions are cuDNN's
UNETPP_PER_BATCH = {"preprocess": 1}
UNETPP_PER_TRAIN_STEP = dict(UNETPP_PER_BATCH)
# the finest-column measurement at the UNet++ shapes (bs 32, 256^2, C 64):
# the kernel column must agree with the cuDNN column to a relative 5e-2 (the
# columns round the statistics at different places and eight BatchNorm-
# normalised legs carry bf16 differences forward; 9.4e-3 measured on an
# H100 80GB HBM3)
COLUMN_ARGS = ["--batch", "32", "--size", "256", "--iters", "20"]
COLUMN_REL_ERR = 5e-2
COLUMN = "UNet++ finest column"
# the factored resize + 3x3 conv at DOFA-base 512^2, bs 8: the neck's x4
# and x2 branches (768 channels from the 32^2 taps) and UperNet's fuse conv
# over each FPN part (256 channels at 64^2, 32^2, 16^2) into 128^2; two
# cases of the 640^2 path
FACTORED_CASES = (
    ("neck x4", (BATCH, 768, 32, 32), 768, (128, 128)),
    ("neck x2", (BATCH, 768, 32, 32), 768, (64, 64)),
    ("UperNet part 64^2", (BATCH, 256, 64, 64), 256, (128, 128)),
    ("UperNet part 32^2", (BATCH, 256, 32, 32), 256, (128, 128)),
    ("UperNet part 16^2", (BATCH, 256, 16, 16), 256, (128, 128)),
    # and at 640^2 (45^2 taps), whose sizes are no multiples of 8
    ("neck x4 at 640^2", (BATCH, 768, 45, 45), 768, (180, 180)),
    ("UperNet part 22^2 at 640^2", (BATCH, 256, 22, 22), 256, (180, 180)),
)
# the factored bf16 branch (forward, dx, dw, db) against the plain f32
# composition, relative to each reference's largest magnitude: about twice
# the readings on an H100 80GB HBM3 (y 5.5e-3 to 6.4e-3, dx 3.5e-3 to
# 3.9e-3, dw 3.9e-3 to 5.4e-3, db 1.8e-3 to 3.5e-3); a tap or phase off by
# one moves y by a sizable fraction of its largest value
FACTORED_REL_ERR = 1.3e-2
# the configured losses on the card (f32 logits) against CPU copies in f64
LOSS_CASES = (
    ("DiceLoss", {"mode": "binary"}, 1),
    ("JaccardLoss", {"mode": "binary"}, 1),
    ("BinaryCrossEntropyLoss", {}, 1),
    ("FocalLoss", {"mode": "binary", "alpha": 0.25}, 1),
    ("DiceLoss", {"mode": "multiclass", "ignore_index": 255}, 5),
    ("JaccardLoss", {"mode": "multiclass"}, 5),
    ("SoftCrossEntropyLoss", {"smooth_factor": 0.1, "ignore_index": 255}, 5),
    ("CrossEntropyLoss", {"ignore_index": 255, "class_weights": [0.5, 1.0, 2.0, 1.5, 0.25]}, 5),
    ("FocalLoss", {"mode": "multiclass", "gamma": 2.0}, 5),
)
LOSS_REL_ERR = 1e-5
LOSS_SIZE = 256
RECIPE = "DOFA recipe: pretrained encoder, frozen"
# GrainCSVDataModule by the JAX class path, which the port's CLI aliases
GRAIN = "geo_deep_learning_tpu.data.grain_pipeline.GrainCSVDataModule"
GRAIN_WORKERS = 8
EVAL_EQUAL = 1e-6  # test metrics through the two data modules

# the port config (geo_deep_learning_tpu_torch/configs/dofa_upernet_waterloo.yaml)
# as a dict: the machine with the card has no YAML parser
CONFIG = {
    "seed_everything": 42,
    "trainer": {
        "max_epochs": 10,
        "precision": "bf16-mixed",
        "gradient_clip_val": 1.0,
        "default_root_dir": "runs/torch_dofa_waterloo",
        "callbacks": [
            {"class_path": "lightning.pytorch.callbacks.EarlyStopping",
             "init_args": {"monitor": "val_loss", "mode": "min", "patience": 20}},
            {"class_path": "lightning.pytorch.callbacks.ModelCheckpoint",
             "init_args": {"monitor": "val_loss", "mode": "min", "save_top_k": 1}},
        ],
    },
    "model": {
        "class_path": "geo_deep_learning_tpu_torch.tasks.SegmentationDOFA",
        "init_args": {
            "encoder": "dofa_base",
            "pretrained": False,
            "image_size": [512, 512],
            "num_classes": 1,
            "wavelengths": [0.665, 0.549, 0.481],
            # random weights, so the encoder trains too (the recipe freezes
            # a pretrained one); this is the path that runs K5-K7
            "freeze_layers": [],
            "loss": {
                "class_path": "geo_deep_learning_tpu_torch.ops.losses.DiceLoss",
                "init_args": {"mode": "binary"},
            },
            "optimizer": {"class_path": "torch.optim.Adam", "init_args": {"lr": 6.0e-5}},
            "scheduler": {
                "class_path": "torch.optim.lr_scheduler.ReduceLROnPlateau",
                "init_args": {"mode": "min", "factor": 0.1, "patience": 10, "cooldown": 1,
                              "min_lr": 6.0e-8},
            },
            "class_labels": ["background", "building"],
        },
    },
    "data": {
        "class_path": "geo_deep_learning_tpu_torch.data.datamodule.CSVDataModule",
        "init_args": {
            "csv_root_folder": "data/waterloo",
            "patches_root_folder": "data/waterloo",
            "batch_size": BATCH,
            "mean": [0.405, 0.432, 0.397],
            "std": [0.165, 0.161, 0.174],
            "patch_size": [512, 512],
            "device_preprocess": True,
        },
    },
    "ckpt_path": None,
}

# the port config (geo_deep_learning_tpu_torch/configs/segformer_waterloo.yaml)
# as a dict
SEGFORMER_CONFIG = {
    "seed_everything": 42,
    "trainer": {
        "max_epochs": 10,
        "precision": "bf16-mixed",
        "gradient_clip_val": 1.0,
        "default_root_dir": "runs/torch_segformer_waterloo",
        "callbacks": CONFIG["trainer"]["callbacks"],
    },
    "model": {
        "class_path": "geo_deep_learning_tpu_torch.tasks.SegmentationSegformer",
        "init_args": {
            "encoder": "mit_b0",
            "image_size": [512, 512],
            "in_channels": 3,
            # the recipe's ImageNet weights are not in the repository
            "weights": None,
            "num_classes": 1,
            "use_dynamic_encoder": False,
            "loss": CONFIG["model"]["init_args"]["loss"],
            "optimizer": CONFIG["model"]["init_args"]["optimizer"],
            "scheduler": CONFIG["model"]["init_args"]["scheduler"],
            "scheduler_config": {"interval": "epoch", "frequency": 1, "monitor": "val_loss"},
            "class_labels": ["background", "building"],
        },
    },
    "data": CONFIG["data"],
    "ckpt_path": None,
}

# the port config (geo_deep_learning_tpu_torch/configs/unetplus_waterloo.yaml)
# as a dict
UNETPLUS_CONFIG = {
    "seed_everything": 42,
    "trainer": {
        "max_epochs": 10,
        "precision": "bf16-mixed",
        "gradient_clip_val": 1.0,
        "default_root_dir": "runs/torch_unetplus_waterloo",
        "callbacks": CONFIG["trainer"]["callbacks"],
    },
    "model": {
        "class_path": "geo_deep_learning_tpu_torch.tasks.SegmentationUnetPlus",
        "init_args": {
            "encoder": "resnet34",
            "image_size": [512, 512],
            "in_channels": 3,
            # the recipe's ImageNet weights are not in the repository
            "weights": None,
            "num_classes": 1,
            "loss": CONFIG["model"]["init_args"]["loss"],
            "optimizer": {"class_path": "torch.optim.Adam", "init_args": {"lr": 1.0e-4}},
            "scheduler": {
                "class_path": "torch.optim.lr_scheduler.ReduceLROnPlateau",
                "init_args": {"mode": "min", "factor": 0.1, "patience": 10, "cooldown": 1,
                              "min_lr": 1.0e-8},
            },
            "scheduler_config": SEGFORMER_CONFIG["model"]["init_args"]["scheduler_config"],
            "class_labels": ["background", "building"],
        },
    },
    "data": CONFIG["data"],
    "ckpt_path": None,
}


# the DOFA port config at 640^2 (image_size and patch_size 640), whose data
# the run makes from the tst split
CONFIG_640 = copy.deepcopy(CONFIG)
CONFIG_640["trainer"]["default_root_dir"] = "runs/torch_dofa_waterloo_640"
CONFIG_640["model"]["init_args"]["image_size"] = [SIZE_640, SIZE_640]
CONFIG_640["data"]["init_args"]["patch_size"] = [SIZE_640, SIZE_640]


class ModelPath(NamedTuple):
    """One model family's main path: its config, its exact kernel launches
    per evaluated batch and per train step, the crop size of its card-vs-CPU
    forward check, its train-step check and any further serving checks,
    each called as ``check(torch, config)``, and the forward check itself
    where the path has its own (``reference(torch, config, ref_size)``;
    :func:`reference_check` otherwise)."""

    label: str
    config: dict
    per_batch: dict
    per_step: dict
    ref_size: int
    train_check: Callable
    serving_checks: tuple = ()
    reference: Callable | None = None


class Phase:
    def __init__(self, name: str) -> None:
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        print(f"== {self.name}", flush=True)
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            print(f"== {self.name}: ok in {time.perf_counter() - self.t0:.1f} s", flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def loader_threads(wait_s: float = 5.0) -> list[str]:
    """Names of the loader's reader threads still alive after up to ``wait_s``."""
    import threading

    from geo_deep_learning_tpu_torch.data.loader import THREAD_PREFIX

    end = time.monotonic() + wait_s
    while True:
        alive = [t.name for t in threading.enumerate() if t.name.startswith(THREAD_PREFIX)]
        if not alive or time.monotonic() > end:
            return alive
        time.sleep(0.01)


def pin_threads() -> list[str]:
    """Names of live threads running torch's pin-memory loop."""
    import threading

    return [t.name for t in threading.enumerate()
            if getattr(getattr(t, "_target", None), "__name__", "") == "_pin_memory_loop"]


def worker_processes(wait_s: float = 5.0) -> list[str]:
    """Child processes (loader workers) still alive after up to ``wait_s``."""
    import multiprocessing

    end = time.monotonic() + wait_s
    while True:
        alive = [f"{p.name} (pid {p.pid})" for p in multiprocessing.active_children()]
        if not alive or time.monotonic() > end:
            return alive
        time.sleep(0.01)


def run_checked(config: dict, sub: str, *args, **kwargs):
    """``run(config, sub, "cuda", ...)``, then no loader thread, pin-memory
    thread or worker process may be left."""
    from geo_deep_learning_tpu_torch.cli.main import run

    result = run(config, sub, "cuda", *args, **kwargs)
    alive = loader_threads()
    check(not alive, f"{sub}: loader threads left alive: {alive}")
    alive = worker_processes() + pin_threads()
    check(not alive, f"{sub}: worker processes or pin threads left alive: {alive}")
    return result


def host_probe(torch) -> None:
    """The host the loaders run on: cores (those this process may use and
    the cgroup's CPU quota), the C++ compiler, libtiff's header and library,
    /dev/shm (where worker processes hand batches over) and torch's sharing
    strategy."""
    import ctypes.util
    import os
    import shutil

    gxx = shutil.which("g++")
    version = "absent"
    header = False
    if gxx:
        version = subprocess.run([gxx, "--version"], capture_output=True, text=True,
                                 timeout=60, check=False).stdout.splitlines()[0]
        header = subprocess.run([gxx, "-E", "-x", "c++", "-", "-o", os.devnull],
                                input="#include <tiffio.h>\n", capture_output=True, text=True,
                                timeout=60, check=False).returncode == 0
    shm = shutil.disk_usage("/dev/shm") if Path("/dev/shm").is_dir() else None
    shm_text = "absent" if shm is None else (
        f"{shm.free / 2**20:.1f} MiB free of {shm.total / 2**20:.1f} MiB")
    quota = Path("/sys/fs/cgroup/cpu.max")  # "<quota> <period>" or "max <period>"
    quota_text = quota.read_text().strip() if quota.exists() else "absent"
    print(f"  host: os.cpu_count() {os.cpu_count()}, usable {len(os.sched_getaffinity(0))}, "
          f"cgroup cpu.max {quota_text}; g++: {version}; tiffio.h: "
          f"{'present' if header else 'absent'}; libtiff: "
          f"{ctypes.util.find_library('tiff') or 'absent'}; /dev/shm: {shm_text}; torch "
          f"sharing strategy: {torch.multiprocessing.get_sharing_strategy()}")


def device_phase(torch) -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    cap = torch.cuda.get_device_capability(0)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, capability {cap}")
    check(cap == (9, 0), f"expected a Hopper card (9, 0), got {cap}")
    host_probe(torch)
    return smi


def host_readers_phase(smi: str) -> None:
    """The C++ host readers built from this checkout's sources (the decoder
    of each kind and why), then, where libtiff is present, the native
    decode of every tst patch and label against the numpy codec, bit for
    bit, and the ms a patch of each in one thread."""
    import numpy as np

    from geo_deep_learning_tpu_torch.data import _native
    from geo_deep_learning_tpu_torch.data.geotiff import read_geotiff_numpy

    t0 = time.perf_counter()
    decoders = _native.decoders()
    print(f"  decoders: {decoders} (built or found in {time.perf_counter() - t0:.2f} s); on {smi}")
    check(decoders["tar"].startswith("native"), f"the tar reader did not build: {decoders}")
    files = sorted((DATA / "tst").rglob("*.tif"))
    if _native.get_lib() is None:
        print(f"  tiff: libtiff reader absent here ({decoders['tiff']}); the numpy codec reads "
              "the patches")
        return
    times = {"native": 0.0, "numpy": 0.0}
    for f in files:
        t0 = time.perf_counter()
        native = _native.read_pixels_native(f)
        t1 = time.perf_counter()
        plain, _ = read_geotiff_numpy(f)
        t2 = time.perf_counter()
        times["native"] += t1 - t0
        times["numpy"] += t2 - t1
        check(native is not None and native.dtype == plain.dtype and np.array_equal(native, plain),
              f"native decode of {f.name} differs from the numpy codec")
    images = sum(1 for f in files if f.parent.name == "image")
    print(f"  tiff: {len(files)} tst rasters ({images} images, {len(files) - images} labels) "
          f"native = numpy codec bit for bit; one thread, warm page cache, ms a raster: native "
          f"{1e3 * times['native'] / len(files):.2f}, numpy codec "
          f"{1e3 * times['numpy'] / len(files):.2f}; on {smi}")


# the wgmma kernels ptxas_report reads (K10's instances with the head dim,
# " ring" where its K/V stream), and those of them that must not spill, or
# draw a ptxas note (serialized wgmma), at the head dims the main paths run
WGMMA_KERNELS = (r"(attention_fwd_wgmma|attention_bwd_\w+?|sr_attention_fwd_wgmma|packed_conv_\w+?)"
                 r"_kernel(?:ILi(\d+)E(Lb1E)?)?")
NO_SPILL = ("attention_fwd_wgmma hd 32", "attention_fwd_wgmma hd 64",
            "attention_bwd_dkdv_wgmma hd 64", "attention_bwd_dq_wgmma hd 64",
            "sr_attention_fwd_wgmma hd 32", "sr_attention_fwd_wgmma hd 64", "packed_conv_wgmma")
# the LayerNorm kernels (every instance: type, vectors per lane, residual),
# none of which may spill; DOFA's width (768: 3 vectors a lane in bf16)
LN_KERNELS = r"(layernorm_(?:fwd|bwd))_kernelI(13__nv_bfloat16|f)Li(\d+)ELb([01])E"
LN_MAIN = ("layernorm_fwd bf16 nv 3", "layernorm_fwd bf16 nv 3 residual",
           "layernorm_bwd bf16 nv 3", "layernorm_bwd bf16 nv 3 residual")
# K1's instances (output type, channels: 3, 4 or 0 for any other count),
# all six of which must be built without a spill
PP_KERNELS = r"preprocess_kernelI(13__nv_bfloat16|f)Li(\d+)E"
# the f32 attention instances (32-true): the 3xTF32 forward and the 3xTF32
# backward's two kernels, every head dim, none of which may spill
F32_KERNELS = r"(attention_(?:fwd_tf32|bwd_dkdv_tf32|bwd_dq_tf32))_kernelILi(\d+)E"
F32_INSTANCES = tuple(f"{k} hd {hd}" for k in ("attention_fwd_tf32", "attention_bwd_dkdv_tf32",
                                               "attention_bwd_dq_tf32") for hd in (32, 64, 128))
PP_INSTANCES = tuple(f"preprocess {t} C {c}" for t in ("bf16", "f32") for c in ("3", "4", "any"))


def ptxas_report(log: str) -> dict[str, dict]:
    """Registers, stack, spills and any ptxas warnings or numbered notes
    (wgmma serialization, setmaxnreg) of the wgmma kernels (the attention
    forward's and backward's, K10's bf16 instance, K11 and its pre-pass),
    per kernel and head dim, and of the LayerNorm and K1 instances, from
    the ``-Xptxas -v`` output the build
    keeps. A note that names its function (ptxas prints some before that
    function's entry line) goes to that function."""
    import re

    def entry(mangled: str) -> dict | None:
        k = re.search(WGMMA_KERNELS, mangled)
        if k is not None:
            name = k.group(1) + (f" hd {k.group(2)}" if k.group(2) else "") + (
                " ring" if k.group(3) else "")
        elif (k := re.search(LN_KERNELS, mangled)) is not None:
            name = (f"{k.group(1)} {'f32' if k.group(2) == 'f' else 'bf16'} nv {k.group(3)}"
                    + (" residual" if k.group(4) == "1" else ""))
        elif (k := re.search(F32_KERNELS, mangled)) is not None:
            name = f"{k.group(1)} hd {k.group(2)}"
        elif (k := re.search(PP_KERNELS, mangled)) is not None:
            name = (f"preprocess {'f32' if k.group(1) == 'f' else 'bf16'} C "
                    f"{'any' if k.group(2) == '0' else k.group(2)}")
        else:
            return None
        return report.setdefault(name, {"notes": []})

    report: dict[str, dict] = {}
    cur = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = entry(m.group(1))
            continue
        m = re.search(r"for the function '(\S+)'", line)
        named = entry(m.group(1)) if m else cur
        if named is not None and re.search(r"\(C\d+\)", line) and line.strip() not in named["notes"]:
            named["notes"].append(line.strip())
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur["stack"], cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
        if "warning" in line and line.strip() not in cur["notes"]:
            cur["notes"].append(line.strip())
    return report


# host time in a counting profiler session before the first launch and
# after the last synchronize: the profiler keeps a device record only if its
# timestamps, converted to the host clock, fall inside the session, and a
# kernel at the session's very edge can land just outside it
PROFILE_MARGIN_S = 0.05


def time_ms(torch, fn, iters: int, clean: bool = False) -> float:
    """Mean device time of ``fn`` over ``iters`` launches, each after
    flushing the 50 MB L2 with a 64 MB write (the main path finds its
    inputs cold), timed with CUDA events around ``fn`` alone. A spin of
    about 0.5 ms on the card before each launch lets the host enqueue the
    events and ``fn``'s launches ahead of the card, so the events time the
    device work and not the Python wrapper's overhead. The write leaves the
    L2 full of dirty lines, which ``fn``'s own traffic then writes back;
    with ``clean`` a read of a second 64 MB buffer follows it, so ``fn``
    finds the L2 cold and clean (the kernels' tables keep the first
    reading, ``clean_ms`` is printed beside it)."""
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
    reread = torch.ones(64 * 2**20, dtype=torch.uint8, device="cuda") if clean else None
    for _ in range(3):
        fn()
    pairs = []
    for _ in range(iters):
        flush.zero_()
        if clean:
            reread.sum()
        torch.cuda._sleep(1_000_000)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        pairs.append((e0, e1))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / iters


def ulp_tol(want) -> float:
    """One bf16 ulp of the largest |value| of ``want``, 0 where it is all
    zero: kernel and plain version each round one f32 result."""
    top = float(want.float().abs().max())
    return 2.0 ** (math.floor(math.log2(top)) - 7) if top > 0 else 0.0


def max_err(got, want) -> float:
    if isinstance(got, tuple):
        return max(max_err(g, w) for g, w in zip(got, want))
    return float((got.float() - want.float()).abs().max())


# K4 (b, l, h, hd, input scale, q = 0): DOFA-base at 512^2, bs 8, first
K4_CASES = ((BATCH, 1297, 12, 64, 1.0, False), (2, 1297, 12, 64, 1.0, True),
            (2, 1297, 12, 64, 4.0, False), (2, 1297, 12, 64, 1.0, False),
            (2, 197, 12, 64, 1.0, False), (2, 37, 4, 32, 1.0, False),
            (1, 300, 2, 128, 1.0, False), (2, 5, 3, 64, 1.0, False))


def kernels_phase(torch) -> dict[str, dict]:
    import torch.nn.functional as F

    from geo_deep_learning_tpu_torch.ops.cuda import mha as MHA

    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16, f32 = torch.bfloat16, torch.float32

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    def compare(name, got, want, tol):
        err = max_err(got, want)
        print(f"  {name}: max_abs_err {err:.3g} (tolerance {tol:g})")
        check(math.isfinite(err) and err <= tol, f"{name}: error {err} above {tol}")
        return err

    records = {}
    # tolerances: f32 kernels repeat the plain arithmetic up to summation
    # order; bf16 outputs may differ by rounding of the last bit (1 ulp is
    # 2^-6 for |y| in [2, 4)); attention outputs and gradients to one bf16
    # ulp of their own largest |value| (ulp_tol)
    tol = {("preprocess", f32): 1e-6, ("preprocess", bf16): 1.6e-2,
           ("ln", f32): 1e-5, ("ln", bf16): 3.2e-2}

    records["preprocess"] = preprocess_records(torch, gen, compare, tol[("preprocess", bf16)],
                                               tol[("preprocess", f32)])

    records |= layernorm_records(torch, randn, compare, tol[("ln", bf16)], tol[("ln", f32)])

    # K4: ragged last key chunks (1297 = 10 x 128 + 17; 197, 37 and 5 keys;
    # 300 = 4 x 64 + 44 at head dim 128), and at 1297 tokens a head of
    # equal scores (q = 0) and inputs x 4 (a large lse, |o| up to 16), as
    # K8's cases; o to one bf16 ulp of its largest |o|, lse 1e-4, equal
    # over two runs
    for b, l, h, hd, amp, zero_q in K4_CASES:
        qkv = randn((b, l, 3 * h * hd), bf16) * amp
        if zero_q:
            qkv[..., : h * hd] = 0
        scale = 1.0 / math.sqrt(hd)
        (o, lse), (wo, wlse) = MHA.attention_packed(qkv, h), MHA.attention_reference(qkv, h, scale)
        tag = f"attention_fwd_packed [{b},{l},{3 * h * hd}] H={h}" + (
            " equal scores" if zero_q else "") + (f" inputs x{amp:g}" if amp != 1.0 else "")
        err = max(compare(f"{tag} o", o, wo, ulp_tol(wo)),
                  compare(f"{tag} lse", lse, wlse, 1e-4))
        check(all(torch.equal(a, c) for a, c in zip((o, lse), MHA.attention_packed(qkv, h))),
              "attention_fwd_packed: not deterministic")
        if b == BATCH:
            q, k, v = (t.unflatten(-1, (h, hd)).transpose(1, 2) for t in qkv.chunk(3, dim=-1))
            records["attention_fwd_packed"] = {
                "max_abs_err": err,
                "ms": time_ms(torch, lambda: MHA.attention_packed(qkv, h), 20),
                "plain_ms": time_ms(torch, lambda: MHA.attention_reference(qkv, h, scale), 5),
                "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(q, k, v), 20),
                "bytes": qkv.numel() * 2 + b * l * h * hd * 2 + b * h * l * 4,
                "tensor_flops": 4.0 * b * h * l * l * hd,
                "f32_flops": 5.0 * b * h * l * l,
            }

    # K7: dq, dk and dv (the three column sections of dqkv) each to one
    # bf16 ulp of its own largest |value|, exactly where that is zero; two
    # hard cases at full length: a head whose scores are all equal (q = 0:
    # dk is all zero) and rows with a large lse (inputs x 4)
    cases = [(BATCH, 1297, 12, 64, 1.0, False), (2, 1297, 12, 64, 1.0, True),
             (2, 1297, 12, 64, 4.0, False), (2, 197, 12, 64, 1.0, False),
             (2, 37, 4, 32, 1.0, False), (1, 300, 2, 128, 1.0, False)]
    for b, l, h, hd, amp, zero_q in cases:
        qkv = randn((b, l, 3 * h * hd), bf16) * amp
        if zero_q:
            qkv[..., : h * hd] = 0
        g = randn((b, l, h * hd), bf16)
        scale = 1.0 / math.sqrt(hd)
        o, lse = MHA.attention_packed(qkv, h, scale)
        want = MHA.attention_bwd_reference(qkv, o, g, lse, h, scale)
        got = MHA.attention_bwd_packed(qkv, o, g, lse, h, scale)
        tag = " equal scores" if zero_q else (f" inputs x{amp:g}, lse up to {float(lse.max()):.1f}" if amp != 1.0 else "")
        err = max(compare(f"attention_bwd_packed [{b},{l},{3 * h * hd}] H={h}{tag} {name}", a, w,
                          ulp_tol(w))
                  for name, a, w in zip(("dq", "dk", "dv"), got.chunk(3, dim=-1),
                                        want.chunk(3, dim=-1)))
        check(torch.equal(got, MHA.attention_bwd_packed(qkv, o, g, lse, h, scale)),
              "attention_bwd_packed: not deterministic")
        if b == BATCH:
            q, k, v = (t.unflatten(-1, (h, hd)).transpose(1, 2).detach().requires_grad_()
                       for t in qkv.chunk(3, dim=-1))
            lib_out = F.scaled_dot_product_attention(q, k, v)
            lib_g = g.unflatten(-1, (h, hd)).transpose(1, 2)
            records["attention_bwd_packed"] = {
                "max_abs_err": err,
                "ms": time_ms(torch, lambda: MHA.attention_bwd_packed(qkv, o, g, lse, h, scale), 20),
                "plain_ms": time_ms(torch, lambda: MHA.attention_bwd_reference(qkv, o, g, lse, h, scale), 5),
                "library_ms": time_ms(torch, lambda: torch.autograd.grad(
                    lib_out, (q, k, v), lib_g, retain_graph=True), 20),
                "bytes": qkv.numel() * 2 * 2 + 2 * b * l * h * hd * 2 + b * h * l * 4,
                "tensor_flops": 10.0 * b * h * l * l * hd,
                "f32_flops": 5.0 * b * h * l * l,
            }
    records["sr_attention_fwd"] = sr_attention_records(torch, randn, compare)
    records["packed_conv_bn_stats"] = packed_conv_records(torch, gen, compare)
    records["attention_fwd_hm"], records["attention_bwd_hm"] = head_major_records(
        torch, randn, compare)
    route_timing(torch, randn)
    records |= f32_attention_records(torch, randn, compare)
    return records


def preprocess_records(torch, gen, compare, tol_bf16: float, tol_f32: float) -> dict:
    """K1 against its plain version at DOFA's batches ``[8,512,512,3]`` and
    ``[8,640,640,3]``, the 4-band batch ``[8,512,512,4]`` (the Dynamic
    MiT's path) and a ragged ``[3,37,41,3]`` (the generic path), ``[C]``
    and ``[B,C]`` statistics, bf16 and f32, equal over two runs; one kernel
    a call (the profiler). The record of DOFA's 512^2 shape in bf16 with
    the public wrapper's ``ms`` and ``clean_ms`` (what the step calls), and
    printed beside it: the f32 instance's, the cast yardstick
    ``img.to(bf16)`` (``cast_ms``: the same bytes, none of the arithmetic),
    and the kernel's own device time by the profiler and its grid."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from geo_deep_learning_tpu_torch.ops.cuda import preprocess as PP

    bf16, f32 = torch.bfloat16, torch.float32
    tol = {bf16: tol_bf16, f32: tol_f32}
    means = torch.tensor([0.405, 0.432, 0.397, 0.371], device="cuda")
    stds = torch.tensor([0.165, 0.161, 0.174, 0.152], device="cuda")
    side = torch.Generator(device="cuda").manual_seed(1)
    errs = {}
    for shape in ((BATCH, 512, 512, 3), (BATCH, 640, 640, 3), (BATCH, 512, 512, 4), (3, 37, 41, 3)):
        img = torch.randint(0, 256, shape, generator=gen, device="cuda", dtype=torch.uint8)
        b, c = shape[0], shape[-1]
        per_sample = (means[:c] + 0.02 * torch.rand((b, c), generator=side, device="cuda"),
                      stds[:c] + 0.01 * torch.rand((b, c), generator=side, device="cuda"))
        for stats, (m_in, s_in) in (("[C]", (means[:c], stds[:c])), ("[B,C]", per_sample)):
            m, inv = PP._stats(m_in, s_in, img)
            for dt in (bf16, f32):
                got = PP.fused_normalize_standardize(img, m_in, s_in, dt)
                err = compare(f"preprocess {list(shape)} {stats} {dt}", got,
                              PP.normalize_reference(img, m, inv, dt), tol[dt])
                check(torch.equal(got, PP.fused_normalize_standardize(img, m_in, s_in, dt)),
                      "preprocess: not deterministic")
                errs[shape, stats, dt] = err
    mean, std = means[:3], stds[:3]
    img = torch.randint(0, 256, (BATCH, 512, 512, 3), generator=side, device="cuda",
                        dtype=torch.uint8)
    n = img.numel()
    m, inv = PP._stats(mean, std, img)

    def call(dt):
        return lambda: PP.fused_normalize_standardize(img, mean, std, dt)

    # one kernel a call; then the kernel's own device time after the same
    # 64 MB flush as time_ms
    call(bf16)()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_MARGIN_S)
        for _ in range(5):
            call(bf16)()
        torch.cuda.synchronize()
        time.sleep(PROFILE_MARGIN_S)
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    check(len(names) == 5 and all("preprocess_kernel" in k for k in names),
          f"preprocess: expected one kernel a call, got {names}")
    with tempfile.TemporaryDirectory() as tmp:
        prof.export_chrome_trace(f"{tmp}/trace.json")
        trace = json.loads(Path(f"{tmp}/trace.json").read_text())
    args = next((e.get("args", {}) for e in trace.get("traceEvents", [])
                 if "preprocess_kernel" in str(e.get("name"))), {})
    print(f"  preprocess launch (profiler trace): grid {args.get('grid')}, block "
          f"{args.get('block')}, blocks per SM {args.get('blocks per SM')}")

    def kernel_ms(fn) -> float:
        flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILE_MARGIN_S)
            for _ in range(20):
                flush.zero_()
                fn()
            torch.cuda.synchronize()
            time.sleep(PROFILE_MARGIN_S)
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == DeviceType.CUDA and "preprocess_kernel" in e.name]
        check(len(us) == 20, "preprocess: the profiler missed kernels")
        return sum(us) / len(us) / 1e3

    key = (BATCH, 512, 512, 3)
    rec = {
        "max_abs_err": errs[key, "[C]", bf16],
        "ms": time_ms(torch, call(bf16), 50),
        "clean_ms": time_ms(torch, call(bf16), 50, clean=True),
        "plain_ms": time_ms(torch, lambda: PP.normalize_reference(img, m, inv, bf16), 20),
        "library_ms": None,
        "bytes": n * (1 + 2) + 2 * 4 * mean.numel(),
        "tensor_flops": 0.0,
        "f32_flops": 3.0 * n,
    }
    f32_rec = {"ms": time_ms(torch, call(f32), 50),
               "clean_ms": time_ms(torch, call(f32), 50, clean=True),
               "bytes": n * (1 + 4) + 2 * 4 * mean.numel(), "tensor_flops": 0.0,
               "f32_flops": 3.0 * n}
    print(f"  preprocess f32: {f32_rec['ms']:.4f} ms, clean_ms {f32_rec['clean_ms']:.4f} ms, "
          f"kernel alone {kernel_ms(call(f32)):.4f} ms, bound {bound(f32_rec)[0]:.4f} ms "
          f"(bytes), max_abs_err {errs[key, '[C]', f32]:.3g}")
    print(f"  preprocess cast_ms: {time_ms(torch, lambda: img.to(bf16), 50):.4f} ms "
          f"(img.to(torch.bfloat16): the bf16 instance's bytes, none of its arithmetic); "
          f"to f32 {time_ms(torch, lambda: img.to(f32), 50):.4f} ms")
    print(f"  preprocess kernel alone (profiler, after the flush): {kernel_ms(call(bf16)):.4f} ms")
    return rec


# K2/K3 and K5/K6 row counts: DOFA-base at 512^2, bs 8 (10376 rows = 648
# tiles of 16 + 8), then a ragged last tile of every ring shape (2594,
# 394, 111 rows) and one row
LN_CASES = ((BATCH, 1297), (2, 1297), (2, 197), (3, 37), (1, 1))


def layernorm_records(torch, randn, compare, tol_bf16: float, tol_f32: float) -> dict:
    """K2/K3 and K5/K6 against their plain versions at ``LN_CASES`` (d 768,
    bf16 and f32), K5/K6 equal over two runs; the records of DOFA's shape,
    each with ``clean_ms`` (a cold and clean L2) and its library call's
    ``library_ms`` and ``library_clean_ms``."""
    import torch.nn.functional as F

    from geo_deep_learning_tpu_torch.ops.cuda import layernorm as LN

    bf16, f32 = torch.bfloat16, torch.float32
    records = {}

    def timed(fn, plain, library) -> dict:
        return {"ms": time_ms(torch, fn, 50), "clean_ms": time_ms(torch, fn, 50, clean=True),
                "plain_ms": time_ms(torch, plain, 20), "library_ms": time_ms(torch, library, 50),
                "library_clean_ms": time_ms(torch, library, 50, clean=True),
                "tensor_flops": 0.0}

    # K2 / K3
    d = 768
    gamma = 1.0 + 0.1 * randn((d,), f32)
    beta = 0.1 * randn((d,), f32)
    for b, l in LN_CASES:
        for dt in (bf16, f32):
            tol = tol_bf16 if dt == bf16 else tol_f32
            x, br = randn((b, l, d), dt), randn((b, l, d), dt)
            e2 = compare(f"layernorm_fwd [{b},{l},{d}] {dt}", LN.layernorm(x, gamma, beta),
                         LN.layernorm_reference(x, gamma, beta), tol)
            e3 = compare(f"layernorm_residual_fwd [{b},{l},{d}] {dt}",
                         LN.layernorm_residual(x, br, gamma, beta),
                         LN.layernorm_residual_reference(x, br, gamma, beta), tol)
            if b == BATCH and dt == bf16:
                rows = b * l
                gd, bd = gamma.to(dt), beta.to(dt)
                records["layernorm_fwd"] = {
                    "max_abs_err": e2,
                    **timed(lambda: LN.layernorm(x, gamma, beta),
                            lambda: LN.layernorm_reference(x, gamma, beta),
                            lambda: F.layer_norm(x, (d,), gd, bd, 1e-6)),
                    "bytes": rows * d * 2 * 2 + 2 * d * 4 + rows * 8,
                    "f32_flops": 8.0 * rows * d,
                }
                records["layernorm_residual_fwd"] = {
                    "max_abs_err": e3,
                    **timed(lambda: LN.layernorm_residual(x, br, gamma, beta),
                            lambda: LN.layernorm_residual_reference(x, br, gamma, beta),
                            lambda: F.layer_norm(x + br, (d,), gd, bd, 1e-6)),
                    "bytes": rows * d * 2 * 4 + 2 * d * 4 + rows * 8,
                    "f32_flops": 9.0 * rows * d,
                }

    # K5 / K6: dx to the LayerNorm tolerances; dgamma/dbeta are f32 sums
    # over up to 10376 rows taken in another order (1e-2 on sums of order
    # 100 in bf16 inputs, 1e-3 in f32)
    aten = torch.ops.aten
    for b, l in LN_CASES:
        if (b, l) == (2, 1297):
            continue
        for dt in (bf16, f32):
            tol = tol_bf16 if dt == bf16 else tol_f32
            x, dy, ds = randn((b, l, d), dt), randn((b, l, d), dt), randn((b, l, d), dt)
            _, mu, rstd = LN.layernorm(x, gamma, beta)
            sum_tol = 1e-2 if dt == bf16 else 1e-3
            errs = []
            for name, fn, ref in (
                ("layernorm_bwd", lambda: LN.layernorm_bwd(x, dy, gamma, mu, rstd),
                 lambda: LN.layernorm_bwd_reference(x, dy, gamma, mu, rstd)),
                ("layernorm_residual_bwd", lambda: LN.layernorm_residual_bwd(x, dy, ds, gamma, mu, rstd),
                 lambda: LN.layernorm_residual_bwd_reference(x, dy, ds, gamma, mu, rstd)),
            ):
                got, want = fn(), ref()
                errs.append(compare(f"{name} [{b},{l},{d}] {dt} dx", got[0], want[0], tol))
                compare(f"{name} [{b},{l},{d}] {dt} dgamma, dbeta", got[1:], want[1:], sum_tol)
                check(all(torch.equal(u, v) for u, v in zip(got, fn())), f"{name}: not deterministic")
            if b == BATCH and dt == bf16:
                rows = b * l
                gd, bd = gamma.to(dt), beta.to(dt)
                _, amean, arstd = aten.native_layer_norm(x, [d], gd, bd, 1e-6)
                lib_bwd = lambda: aten.native_layer_norm_backward(  # noqa: E731
                    dy, x, [d], amean, arstd, gd, bd, [True, True, True])
                records["layernorm_bwd"] = {
                    "max_abs_err": errs[0],
                    **timed(lambda: LN.layernorm_bwd(x, dy, gamma, mu, rstd),
                            lambda: LN.layernorm_bwd_reference(x, dy, gamma, mu, rstd), lib_bwd),
                    "bytes": rows * d * 2 * 3 + d * 4 * 3 + rows * 8,
                    "f32_flops": 14.0 * rows * d,
                }
                records["layernorm_residual_bwd"] = {
                    "max_abs_err": errs[1],
                    **timed(lambda: LN.layernorm_residual_bwd(x, dy, ds, gamma, mu, rstd),
                            lambda: LN.layernorm_residual_bwd_reference(x, dy, ds, gamma, mu, rstd),
                            lambda: lib_bwd()[0] + ds),
                    "bytes": rows * d * 2 * 4 + d * 4 * 3 + rows * 8,
                    "f32_flops": 15.0 * rows * d,
                }
    return records


def host_us(torch, fns: dict, calls: int = 200, repeats: int = 9) -> dict[str, float]:
    """Host time of one call of each of ``fns``, in microseconds: the least
    over ``repeats`` rounds of the mean of ``calls`` calls in a row, the
    callables taking turns within a round so that a slow spell of the
    host's shared cores falls on all of them alike. Each run starts on an
    idle card and is read before the card has done its work (a call only
    enqueues it): what the Python wrapper and its launch cost the host."""
    for fn in fns.values():
        for _ in range(3):
            fn()
    torch.cuda.synchronize()
    best = dict.fromkeys(fns, math.inf)
    for _ in range(repeats):
        for name, fn in fns.items():
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            best[name] = min(best[name], (time.perf_counter() - t0) / calls * 1e6)
            torch.cuda.synchronize()
    return best


def op_host_us(torch) -> dict[str, tuple[float, float | None]]:
    """``{call: (host_us, library host_us or None)}`` of every kernel call
    on the DOFA-base 512^2 bf16 path, at its shapes (K1 ``[8,512,512,3]``;
    K2/K3/K5/K6 ``[8,1297,768]``; K4/K7 ``[8,1297,2304]``, 12 heads), and of
    the two differentiable calls the blocks make (the LayerNorm module and
    the attention, inputs requiring gradients: the autograd path), through
    the public wrappers only, so that it times any tree's ``ops/cuda``
    alike."""
    import torch.nn.functional as F

    from geo_deep_learning_tpu_torch.models.layers import LayerNorm
    from geo_deep_learning_tpu_torch.ops.cuda import layernorm as LN
    from geo_deep_learning_tpu_torch.ops.cuda import mha as MHA
    from geo_deep_learning_tpu_torch.ops.cuda import preprocess as PP

    gen = torch.Generator(device="cuda").manual_seed(0)
    d, h, l = 768, 12, 1297
    x, br, dy, ds = (torch.randn((BATCH, l, d), generator=gen, device="cuda").bfloat16()
                     for _ in range(4))
    gamma = 1.0 + 0.1 * torch.randn((d,), generator=gen, device="cuda")
    beta = 0.1 * torch.randn((d,), generator=gen, device="cuda")
    gd, bd = gamma.bfloat16(), beta.bfloat16()
    _, mu, rstd = LN.layernorm(x, gamma, beta)
    aten = torch.ops.aten
    _, amean, arstd = aten.native_layer_norm(x, [d], gd, bd, 1e-6)
    qkv = torch.randn((BATCH, l, 3 * d), generator=gen, device="cuda").bfloat16()
    g = torch.randn((BATCH, l, d), generator=gen, device="cuda").bfloat16()
    scale = 1.0 / math.sqrt(d // h)
    o, lse = MHA.attention_packed(qkv, h, scale)
    q, k, v = (t.unflatten(-1, (h, d // h)).transpose(1, 2) for t in qkv.chunk(3, dim=-1))
    img = torch.randint(0, 256, (BATCH, 512, 512, 3), generator=gen, device="cuda",
                        dtype=torch.uint8)
    mean = torch.tensor(CONFIG["data"]["init_args"]["mean"], device="cuda")
    std = torch.tensor(CONFIG["data"]["init_args"]["std"], device="cuda")
    norm = LayerNorm(d).cuda()
    xg, qg = x.detach().requires_grad_(), qkv.detach().requires_grad_()

    def lib_bwd():
        return aten.native_layer_norm_backward(dy, x, [d], amean, arstd, gd, bd, [True] * 3)

    pairs = {
        "preprocess": (lambda: PP.fused_normalize_standardize(img, mean, std, torch.bfloat16),
                       None),
        "layernorm_fwd": (lambda: LN.layernorm(x, gamma, beta),
                          lambda: F.layer_norm(x, (d,), gd, bd, 1e-6)),
        "layernorm_residual_fwd": (lambda: LN.layernorm_residual(x, br, gamma, beta),
                                   lambda: F.layer_norm(x + br, (d,), gd, bd, 1e-6)),
        "attention_fwd_packed": (lambda: MHA.attention_packed(qkv, h, scale),
                                 lambda: F.scaled_dot_product_attention(q, k, v)),
        "layernorm_bwd": (lambda: LN.layernorm_bwd(x, dy, gamma, mu, rstd), lib_bwd),
        "layernorm_residual_bwd": (lambda: LN.layernorm_residual_bwd(x, dy, ds, gamma, mu, rstd),
                                   lambda: lib_bwd()[0] + ds),
        "attention_bwd_packed": (lambda: MHA.attention_bwd_packed(qkv, o, g, lse, h, scale),
                                 None),
        "LayerNorm module (grad)": (lambda: norm(xg),
                                    lambda: F.layer_norm(xg, (d,), gd, bd, 1e-6)),
        "attention (grad)": (lambda: MHA.attention(qg, h, scale), None),
    }
    fns = {(name, i): fn for name, pair in pairs.items() for i, fn in enumerate(pair)
           if fn is not None}
    times = host_us(torch, fns)
    return {name: (times[name, 0], times.get((name, 1))) for name in pairs}


# K8/K9 shapes: DOFA-base at 640^2, bs 8 (12 heads of 64 over 2026 tokens);
# the band's inside edge and end for DOFA's heads (1601 tokens, not a
# multiple of the kernels' 64-row tile; 2304); a short sequence; head dims
# 32 and 128
HM_SHAPES = ((BATCH, 12, 2026, 64), (2, 12, 1601, 64), (1, 12, 2304, 64), (2, 12, 300, 64),
             (2, 4, 1601, 32), (1, 2, 2026, 128))


def head_major_records(torch, randn, compare, cases=None) -> tuple[dict, dict]:
    """K8 and K9 against their plain versions at ``HM_SHAPES`` and, at the
    640^2 shape, on a head of equal scores (q = 0) and on inputs x 4 (rows
    with a large lse, and |o| up to 16): o and each gradient to one bf16
    ulp of its largest |value| (both sides round one f32 result), exactly
    where the plain version is all zero (dk of equal scores), lse to 1e-4;
    K8 and K9 equal over two runs. The operators take the packed
    ``[B, L, 3*H*hd]`` tensor and read and write its head slices, as the
    model's attention route gives them.
    Returns the records of the first case (the 640^2 shape unless
    ``cases`` names others); their library call is SDPA forward (K8) and
    SDPA backward (K9) on contiguous copies of q, k, v."""
    import torch.nn.functional as F

    from geo_deep_learning_tpu_torch.ops.cuda import mha as MHA

    if cases is None:
        cases = [(*shape, 1.0, False) for shape in HM_SHAPES]
        cases[1:1] = [(2, 12, 2026, 64, 1.0, True), (2, 12, 2026, 64, 4.0, False)]
    rec8 = rec9 = None
    for b, h, l, hd, amp, zero_q in cases:
        qkv = randn((b, l, 3 * h * hd), torch.bfloat16) * amp
        g = randn((b, l, h * hd), torch.bfloat16)
        if zero_q:
            qkv[..., :h * hd].zero_()
        scale = 1.0 / math.sqrt(hd)
        tag = f"[{b},{h},{l},{hd}]" + (" equal scores" if zero_q else "") + (
            f" inputs x{amp:g}" if amp != 1.0 else "")
        o, lse = MHA.attention_hm(qkv, h, scale)
        wo, wlse = MHA.attention_reference(qkv, h, scale)
        err8 = max(compare(f"attention_fwd_hm {tag} o", o, wo, ulp_tol(wo)),
                   compare(f"attention_fwd_hm {tag} lse", lse, wlse, 1e-4))
        check(all(torch.equal(a, c) for a, c in zip((o, lse), MHA.attention_hm(qkv, h, scale))),
              "attention_fwd_hm: not deterministic")
        got = MHA.attention_hm_bwd(qkv, o, g, lse, h, scale)
        want = MHA.attention_bwd_reference(qkv, o, g, lse, h, scale)
        err9 = max(compare(f"attention_bwd_hm {tag} {name}", a, w, ulp_tol(w)) for name, a, w in
                   zip(("dq", "dk", "dv"), got.chunk(3, dim=-1), want.chunk(3, dim=-1)))
        check(torch.equal(got, MHA.attention_hm_bwd(qkv, o, g, lse, h, scale)),
              "attention_bwd_hm: not deterministic")
        if rec8 is not None:
            continue
        n, rows = b * h * l * hd, b * h * l
        q, k, v = (t.unflatten(-1, (h, hd)).transpose(1, 2).contiguous()
                   for t in qkv.chunk(3, dim=-1))
        gh = g.unflatten(-1, (h, hd)).transpose(1, 2).contiguous()
        ql, kl, vl = (t.detach().clone().requires_grad_() for t in (q, k, v))
        lib_out = F.scaled_dot_product_attention(ql, kl, vl)
        rec8 = {
            "max_abs_err": err8,
            "ms": time_ms(torch, lambda: MHA.attention_hm(qkv, h, scale), 20),
            "plain_ms": time_ms(torch, lambda: MHA.attention_reference(qkv, h, scale), 5),
            "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(q, k, v), 20),
            "bytes": 4 * n * 2 + rows * 4,
            "tensor_flops": 4.0 * rows * l * hd,
            "f32_flops": 5.0 * rows * l,
        }
        rec9 = {
            "max_abs_err": err9,
            "ms": time_ms(torch, lambda: MHA.attention_hm_bwd(qkv, o, g, lse, h, scale), 20),
            "plain_ms": time_ms(
                torch, lambda: MHA.attention_bwd_reference(qkv, o, g, lse, h, scale), 5),
            "library_ms": time_ms(torch, lambda: torch.autograd.grad(
                lib_out, (ql, kl, vl), gh, retain_graph=True), 20),
            # q, k, v, o, g in; dq, dk, dv out; lse
            "bytes": 8 * n * 2 + rows * 4,
            "tensor_flops": 10.0 * rows * l * hd,
            "f32_flops": 5.0 * rows * l,
        }
    return rec8, rec9


def route_timing(torch, randn) -> None:
    """The whole 640^2 attention route of a DOFA-base block (K8 on the head
    slices of the packed tensor, read and written in place) against K4 on
    the same packed ``[8, 2026, 2304]`` input, forward and forward +
    backward (K8 + K9 against K4 + K7)."""
    from geo_deep_learning_tpu_torch.ops.cuda import mha as MHA

    l, h, hd = 2026, 12, 64
    check(MHA.route(h, l, hd) == "head_major", "2026 tokens do not take the head-major route")
    qkv = randn((BATCH, l, 3 * h * hd), torch.bfloat16)
    go = randn((BATCH, l, h * hd), torch.bfloat16)
    leaf = qkv.detach().requires_grad_()
    scale = 1.0 / math.sqrt(hd)
    route_fwd = time_ms(torch, lambda: MHA.attention(qkv, h), 20)
    k4_fwd = time_ms(torch, lambda: MHA.attention_packed(qkv, h), 20)
    route_step = time_ms(torch, lambda: torch.autograd.grad(MHA.attention(leaf, h), leaf, go), 10)
    packed_step = time_ms(torch, lambda: torch.autograd.grad(
        MHA.ATTENTION_FWD_PACKED(leaf, h, scale)[0], leaf, go), 10)
    print(f"  640^2 attention route [{BATCH},{l},{3 * h * hd}] H={h}: forward {route_fwd:.4f} ms "
          f"(route: K8) against K4 {k4_fwd:.4f} ms; forward + backward {route_step:.4f} ms "
          f"(K8 + K9) against K4 + K7 {packed_step:.4f} ms")


# K10 shapes: SegFormer mit_b0 at 512^2, bs 8 (stages 1-3), the b1-b5
# head dim at stage 1, and a ragged longer KV (Lk 1000: not a multiple of
# the kernel's 32-row K/V tile)
SR_SHAPES = ((BATCH, 1, 16384, 256, 32), (BATCH, 2, 4096, 256, 32), (BATCH, 5, 1024, 256, 32),
             (BATCH, 1, 16384, 256, 64), (2, 3, 1536, 1000, 32))
SR_RAGGED = tuple((2, 3, 1000, lk, 64) for lk in (1, 12, 65, 256, 1000)) + ((1, 1, 192, 1000, 64),)


def sr_attention_records(torch, randn, compare) -> dict:
    """K10 against its plain version in bf16 and f32, twice (it must be
    deterministic), on q/k/v laid out as the path makes them: views of the
    projections' [B, L, H, D] and [B, Lk, 2, H, D] outputs. f32 to 1e-5;
    bf16 to one bf16 ulp of the largest |o| of the plain version (its f32
    result rounded to bf16; |o| <= max |v|, every row a convex mix of v
    rows). Returns the record of the stage-1 bf16 shape; prints the times
    of the others."""
    import torch.nn.functional as F

    from geo_deep_learning_tpu_torch.ops.cuda import sr_attention as SR

    record = None
    for b, h, lq, lk, d in SR_SHAPES:
        for dt in (torch.bfloat16, torch.float32):
            q = randn((b, lq, h, d), dt).transpose(1, 2)
            kv = randn((b, lk, 2, h, d), dt)
            k, v = kv[:, :, 0].transpose(1, 2), kv[:, :, 1].transpose(1, 2)
            scale = d**-0.5
            want = SR.sr_attention_plain(q, k, v, scale)
            top = float(want.float().abs().max())
            tol = 1e-5 if dt == torch.float32 else 2.0 ** (math.floor(math.log2(top)) - 7)
            got = SR.sr_attention_fwd(q, k, v, scale)
            err = compare(f"sr_attention_fwd q [{b},{h},{lq},{d}] kv {lk} {dt}", got, want, tol)
            check(torch.equal(got, SR.sr_attention_fwd(q, k, v, scale)),
                  "sr_attention_fwd: not deterministic")
            if dt != torch.bfloat16:
                continue
            rec = sr_record(torch, SR, F, q, k, v, scale, err)
            print_times(rec, "SDPA")
            record = record or rec
    # the bf16 instance at ragged lengths: Lq 1000 (not a multiple of the
    # 64-row q tile) over KV from one key to two chunk rings' worth, and a
    # one-tile block whose second consumer walks the K/V ring idle
    for b, h, lq, lk, d in SR_RAGGED:
        q = randn((b, lq, h, d), torch.bfloat16).transpose(1, 2)
        kv = randn((b, lk, 2, h, d), torch.bfloat16)
        k, v = kv[:, :, 0].transpose(1, 2), kv[:, :, 1].transpose(1, 2)
        scale = d**-0.5
        want = SR.sr_attention_plain(q, k, v, scale)
        got = SR.sr_attention_fwd(q, k, v, scale)
        err = compare(f"sr_attention_fwd q [{b},{h},{lq},{d}] kv {lk} bf16", got, want, ulp_tol(want))
        check(torch.equal(got, SR.sr_attention_fwd(q, k, v, scale)),
              "sr_attention_fwd: not deterministic")
        print_times(sr_record(torch, SR, F, q, k, v, scale, err), "SDPA")
    return record


def sr_record(torch, SR, F, q, k, v, scale: float, err: float) -> dict:
    """K10's record on bf16 q, k, v: times, bytes and operations."""
    b, h, lq, d = q.shape
    n_s = b * h * lq * k.shape[2]
    return {
        "max_abs_err": err,
        "ms": time_ms(torch, lambda: SR.sr_attention_fwd(q, k, v, scale), 20),
        "plain_ms": time_ms(torch, lambda: SR.sr_attention_plain(q, k, v, scale), 5),
        "library_ms": time_ms(
            torch, lambda: F.scaled_dot_product_attention(q, k, v, scale=scale), 20),
        "bytes": 2 * (2 * b * h * lq * d + 2 * b * h * k.shape[2] * d),
        # the card's fastest route at f32 accuracy: q k^T on bf16 tensor
        # cores, and p v there too as two bf16 passes (p split into hi +
        # lo halves, v exact in bf16); only the softmax and exp work runs
        # at the f32 rate
        "tensor_flops": 2.0 * n_s * d + 2 * 2.0 * n_s * d,
        "f32_flops": 5.0 * n_s,
    }


def print_times(rec: dict, library: str) -> None:
    bound_ms, bound_by = bound(rec)
    print(f"    {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, {library} "
          f"{rec['library_ms']:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")


# K11 shapes: the UNet++ finest column (bs 32, 256^2, 64 channels, W-packed
# to [32, 256, 128, 128]) and ragged ones (H odd and not a multiple of the
# kernel's 4-row tile or of the TPU kernel's 32-row strip; Wp not a
# multiple of the 16-column tile)
PACKED_SHAPES = ((32, 256, 128), (2, 37, 45), (3, 9, 33))


def block_kernel(torch, PC, gen, kind: str, k):
    """kp for K11: pack_w_kernel of ``k`` ("structured", the path's),
    "dense" (no all-zero 64 x 64 block: the weights stream as a ring),
    "single" (the structured kp plus one entry in a block that is zero
    there: 19 blocks, a ring too) or "zero" (no block at all)."""
    if kind == "dense":
        return (0.05 * torch.randn((3, 3, 128, 128), generator=gen, device="cuda")).bfloat16()
    kp = PC.pack_w_kernel(k)
    if kind == "single":
        kp[0, 0, 5, 7] = 0.25
    return (kp if kind != "zero" else torch.zeros_like(kp)).bfloat16()


def packed_conv_records(torch, gen, compare) -> dict:
    """K11 against its plain version with the BN prologue on and off, for
    block kernels of every structure (``block_kernel``): bf16 y to one bf16
    ulp of the plain version's largest |y| (both round one f32 result;
    exactly where it is all zero); the f32 statistics to 1e-5 of the
    largest of their row (sums over up to 1M pixels in another order); y
    and the statistics equal over two runs. Prints the times of each kind
    at the column shape with the prologue; returns the record of the
    path's (structured) kp there. Its library call is the cuDNN conv alone
    (bf16, channels-last, 64 -> 64 on the unpacked [32, 64, 256, 256] map,
    no statistics); its bound counts the products of the flagged blocks."""
    import torch.nn.functional as F

    from geo_deep_learning_tpu_torch.ops.cuda import packed_conv as PC

    record = None
    for b, h, wp in PACKED_SHAPES:
        x = torch.randn((b, h, wp, 128), generator=gen, device="cuda").bfloat16()
        k = 0.05 * torch.randn((3, 3, 64, 64), generator=gen, device="cuda")
        scale = 0.5 + torch.rand(128, generator=gen, device="cuda")
        shift = 0.2 * torch.randn(128, generator=gen, device="cuda")
        for kind in ("structured", "dense", "single", "zero"):
            kp = block_kernel(torch, PC, gen, kind, k)
            blocks = int(PC.block_flags(kp).sum())
            for apply in (True, False):
                tag = (f"packed_conv_bn_stats [{b},{h},{wp},128] {kind} kp ({blocks} blocks) "
                       f"{'prologue' if apply else 'no prologue'}")
                y, stats = PC.packed_conv_bn_stats(x, kp, scale, shift, apply)
                want_y, want_stats = PC.packed_conv_bn_stats_plain(x, kp, scale, shift, apply)
                err = compare(f"{tag}, y", y, want_y, ulp_tol(want_y))
                rel = max(float((g - w).abs().max() / w.abs().max()) if w.any()
                          else (0.0 if not g.any() else math.inf)  # zero rows exactly
                          for g, w in zip(stats, want_stats))
                print(f"  {tag}, stats: max error {rel:.3g} of their row's largest (tolerance 1e-5)")
                check(math.isfinite(rel) and rel <= 1e-5, f"{tag}: statistics disagree")
                y2, stats2 = PC.packed_conv_bn_stats(x, kp, scale, shift, apply)
                check(torch.equal(y, y2) and torch.equal(stats, stats2), f"{tag}: not deterministic")
                if b != PACKED_SHAPES[0][0] or not apply:
                    continue
                n = x.numel()
                x_cl = PC.unpack_nhwc(x).permute(0, 3, 1, 2)  # NHWC memory: channels-last NCHW
                w_cl = k.bfloat16().permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
                rec = {
                    "max_abs_err": err,
                    "ms": time_ms(torch, lambda: PC.packed_conv_bn_stats(x, kp, scale, shift), 20),
                    "plain_ms": time_ms(
                        torch, lambda: PC.packed_conv_bn_stats_plain(x, kp, scale, shift), 5),
                    "library_ms": time_ms(torch, lambda: F.conv2d(x_cl, w_cl, padding=1), 20),
                    # bf16 x and y, the block kernel, scale/shift and the stats
                    "bytes": 2 * 2 * n + kp.numel() * 2 + 4 * 128 * 4,
                    # the flagged blocks' products (18 for the path's kp:
                    # the unpacked conv's work); prologue and statistics 3
                    # f32 operations an element
                    "tensor_flops": 2.0 * b * h * wp * blocks * 64 * 64,
                    "f32_flops": 6.0 * n,
                }
                print_times(rec, "cuDNN conv")
                if kind == "structured":
                    record = rec
    return record


def functions_phase(torch) -> None:
    """The differentiable operators K2/K3/K4 and K10 on the card (forward
    and registered backward kernels) against the same operators on CPU
    copies of the inputs (plain versions), bf16 activations and f32
    parameters as under autocast: dx, dqkv to the kernels' bf16
    tolerances, dgamma/dbeta to 1e-2 (f32 sums over 394 rows of bf16
    products)."""
    from geo_deep_learning_tpu_torch.ops.cuda import layernorm as LN
    from geo_deep_learning_tpu_torch.ops.cuda import mha as MHA
    from geo_deep_learning_tpu_torch.ops.cuda import sr_attention as SR

    gen = torch.Generator().manual_seed(1)
    b, l, d, h = 2, 197, 768, 12
    x, br, dy, ds = (torch.randn((b, l, d), generator=gen).bfloat16() for _ in range(4))
    gamma = 1 + 0.1 * torch.randn(d, generator=gen)
    beta = 0.1 * torch.randn(d, generator=gen)
    qkv = torch.randn((b, l, 3 * d), generator=gen).bfloat16()
    go = torch.randn((b, l, d), generator=gen).bfloat16()

    def grads(device):
        leaves = [t.to(device).requires_grad_() for t in (x, br, gamma, beta, qkv)]
        xt, brt, gt, bt, qt = leaves
        y = LN.layernorm(xt, gt, bt, 1e-6)[0]
        s, y2, _, _ = LN.layernorm_residual(xt, brt, gt, bt, 1e-6)
        o = MHA.attention(qt, h)
        loss = sum((t.float() * w.to(device).float()).sum()
                   for t, w in ((y, dy), (s, ds), (y2, dy), (o, go)))
        loss.backward()
        return [t.grad for t in leaves]

    names = ("dx", "dbranch", "dgamma", "dbeta", "dqkv")
    tols = (3.2e-2, 3.2e-2, 1e-2, 1e-2, 1e-2)
    for name, tol, got, want in zip(names, tols, grads("cuda"), grads("cpu")):
        check(got.device.type == "cuda" and got.dtype == want.dtype, f"{name}: {got.dtype} on {got.device}")
        err = max_err(got.cpu(), want)
        print(f"  operators, card vs CPU, {name} {tuple(got.shape)} {got.dtype}: "
              f"max_abs_err {err:.3g} (tolerance {tol:g})")
        check(math.isfinite(err) and err <= tol, f"{name}: card and CPU operators disagree")

    # gdl::sr_attention_fwd: K10 forward, torch-math backward; bf16 q/k/v of order
    # 1, outputs and gradients of order 1 (one or two bf16 ulps: 1.6e-2)
    q, k, v = (torch.randn(s, generator=gen).bfloat16() for s in ((2, 2, 1024, 32),) + ((2, 2, 64, 32),) * 2)
    g = torch.randn(q.shape, generator=gen).bfloat16()

    def sr_grads(device):
        leaves = [t.to(device).requires_grad_() for t in (q, k, v)]
        o = SR.sr_attention(*leaves, 32**-0.5)
        check(o.grad_fn.name() == "GeneratedBackwardFor_gdl_sr_attention_fwd_defaultBackward",
              "gdl::sr_attention_fwd not taken")
        o.backward(g.to(device))
        return [o.detach()] + [t.grad for t in leaves]

    for name, got, want in zip(("o", "dq", "dk", "dv"), sr_grads("cuda"), sr_grads("cpu")):
        err = max_err(got.cpu(), want)
        print(f"  gdl::sr_attention_fwd, card vs CPU, {name} {tuple(got.shape)} {got.dtype}: "
              f"max_abs_err {err:.3g} (tolerance 1.6e-2)")
        check(got.dtype == want.dtype and math.isfinite(err) and err <= 1.6e-2,
              f"gdl::sr_attention_fwd {name}: card and CPU disagree")


def bound(rec: dict) -> tuple[float, str]:
    """The least time for a record's work: its bytes at the HBM rate, or its
    operations (bf16 and tf32 tensor-core flops at their rates, the rest on
    the f32 pipe), whichever is longer."""
    t_bytes = rec["bytes"] / HBM_BYTES_PER_S * 1e3
    t_ops = (rec["tensor_flops"] / BF16_TENSOR_FLOPS
             + rec.get("tf32_flops", 0.0) / TF32_TENSOR_FLOPS + rec["f32_flops"] / F32_FLOPS) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def reference_check(torch, config: dict, size: int) -> None:
    """Two ``size``^2 crops of tst patches through the config's model at
    full width: on the card (bf16 autocast, kernels) against the same
    weights on the CPU (f32, plain versions). A small crop keeps the CPU
    side short."""
    from geo_deep_learning_tpu_torch.cli.config import instantiate
    from geo_deep_learning_tpu_torch.core.precision import PrecisionPolicy
    from geo_deep_learning_tpu_torch.training.steps import make_predict_step

    model_node = copy.deepcopy(config["model"])
    model_node["init_args"]["image_size"] = [size, size]
    spec = instantiate(model_node)
    model = spec.task.materialize(torch.device("cuda"), config["seed_everything"])
    batch = _crops(torch, config, size)
    del batch["mask"]
    outs = {}
    for device, precision in (("cuda", "bf16-mixed"), ("cpu", "32-true")):
        spec.task.model = model.to(device)
        step = make_predict_step(spec.task, PrecisionPolicy.create(precision))
        outs[device] = step({k: v.to(device) for k, v in batch.items()})
    got, want = outs["cuda"]["probs"].float().cpu(), outs["cpu"]["probs"]
    err = float((got - want).abs().max())
    agree = float((outs["cuda"]["preds"].cpu() == outs["cpu"]["preds"]).float().mean())
    print(f"  card bf16 vs CPU f32, 2 x {size}^2: max |d prob| {err:.3g} (tolerance 0.05), "
          f"pixel agreement {agree:.5f} (at least 0.99)")
    check(torch.isfinite(got).all().item(), "non-finite probabilities on the card")
    check(err <= 0.05 and agree >= 0.99, "card output disagrees with the CPU reference")


def unetpp_reference_check(torch, config: dict, size: int) -> None:
    """Two ``size``^2 tst patches through the full-width UNet++ on the card
    (bf16 autocast, K1) against the same weights on the CPU in f32, with the
    CPU's plain bf16-mixed path as the yardstick. The BatchNorms are first
    calibrated on the two patches (one f32 train-mode forward on the CPU
    takes their batch statistics as running statistics): with the init's
    (0, 1) statistics the random network's eval forward is near constant,
    which no comparison can read. Limits: the card's largest and mean
    |d prob| from f32 at most twice the plain path's (and at least 0.01 and
    1e-3), its pixel agreement with f32 at least the plain path's less 0.01."""
    from geo_deep_learning_tpu_torch.cli.config import instantiate
    from geo_deep_learning_tpu_torch.core.precision import PrecisionPolicy
    from geo_deep_learning_tpu_torch.training.steps import make_predict_step, prepare_image

    node = copy.deepcopy(config["model"])
    node["init_args"]["image_size"] = [size, size]
    spec = instantiate(node)
    model = spec.task.materialize(torch.device("cpu"), config["seed_everything"])
    batch = _crops(torch, config, size)
    del batch["mask"]
    norms = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    for m in norms:
        m.momentum = 1.0
    with torch.no_grad():
        model.train()(prepare_image(batch, PrecisionPolicy.create("32-true")).permute(0, 3, 1, 2))
    for m in norms:
        m.momentum = 0.1
    model.eval()
    outs = {}
    for name, device, precision in (("card", "cuda", "bf16-mixed"), ("f32", "cpu", "32-true"),
                                    ("plain", "cpu", "bf16-mixed")):
        spec.task.model = model.to(device=device, memory_format=torch.channels_last)
        step = make_predict_step(spec.task, PrecisionPolicy.create(precision))
        out = step({k: v.to(device) for k, v in batch.items()})
        outs[name] = {k: v.float().cpu() for k, v in out.items()}

    def distance(name):
        d = (outs[name]["probs"] - outs["f32"]["probs"]).abs()
        return (float(d.max()), float(d.mean()),
                float((outs[name]["preds"] == outs["f32"]["preds"]).float().mean()))

    card, plain = distance("card"), distance("plain")
    spread = float(torch.logit(outs["f32"]["probs"].double()).std())
    print(f"  card bf16 vs CPU f32, 2 x {size}^2, BatchNorms calibrated (f32 logit spread "
          f"{spread:.3g}): max |d prob| {card[0]:.3g}, mean {card[1]:.3g}, pixel agreement "
          f"{card[2]:.5f}; plain bf16 {plain[0]:.3g}, {plain[1]:.3g}, {plain[2]:.5f}")
    check(torch.isfinite(outs["card"]["probs"]).all().item(), "non-finite probabilities on the card")
    check(card[0] <= max(2 * plain[0], 0.01) and card[1] <= max(2 * plain[1], 1e-3)
          and card[2] >= plain[2] - 0.01, "card output disagrees with the CPU reference")


def breakdown(torch, config: dict) -> None:
    """Where the ``test`` wall time goes: the host loader alone over the
    split, then the eval steps alone on batches already on the card."""
    from geo_deep_learning_tpu_torch.cli.config import instantiate
    from geo_deep_learning_tpu_torch.core.precision import PrecisionPolicy
    from geo_deep_learning_tpu_torch.training.steps import make_eval_step, to_device

    t0 = time.perf_counter()
    batches = list(instantiate(config["data"]).test_dataloader())
    host_s = time.perf_counter() - t0
    spec = instantiate(config["model"])
    spec.task.materialize(torch.device("cuda"), config["seed_everything"])
    step = make_eval_step(spec.task, PrecisionPolicy.create("bf16-mixed"))
    on_card = [to_device(b, torch.device("cuda")) for b in batches]
    step(on_card[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in on_card:
        step(b)
    torch.cuda.synchronize()
    steps_s = time.perf_counter() - t0
    print(f"  breakdown: host loader {host_s:.3f} s for {N_TST} patches "
          f"({1e3 * host_s / N_TST:.2f} ms/patch); eval steps on resident batches "
          f"{steps_s:.3f} s ({1e3 * steps_s / len(on_card):.2f} ms per bs-{BATCH} batch)")


def main_path_phase(torch, smi: str, path: ModelPath) -> None:
    """The reference check at the path's ``ref_size``^2, then ``test`` and
    ``predict`` through the CLI over the tst split with exact launch counts,
    then the host-loader / eval-step breakdown and the path's further
    serving checks."""
    from geo_deep_learning_tpu_torch.data.geotiff import read_geotiff
    from geo_deep_learning_tpu_torch.ops.cuda import _lib

    n_batches = -(-N_TST // BATCH)
    with tempfile.TemporaryDirectory(prefix="gdl_chip_smoke_") as tmp:
        config = data_config(path)
        config["trainer"]["default_root_dir"] = tmp

        (path.reference or reference_check)(torch, config, path.ref_size)

        for sub in ("test", "predict"):
            torch.cuda.synchronize()
            _lib.reset_launches()
            t0 = time.perf_counter()
            result = run_checked(config, sub)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            got = dict(_lib.LAUNCHES)
            print(f"  {sub}: {result}")
            print(f"  {sub}: {N_TST} patches in {seconds:.2f} s = {N_TST / seconds:.2f} patches/s "
                  f"(bs {BATCH}, 512^2, {path.label}, bf16-mixed) on {smi}")
            print(f"  {sub}: launches {got}")
            want = {k: v * n_batches for k, v in path.per_batch.items()}
            check(got == want, f"{sub}: launches {got}, expected {want}")
            if sub == "test":
                check(all(math.isfinite(v) for v in result.values()), "non-finite test metric")
                check(0.0 <= result["test_miou"] <= 1.0, "test_miou out of [0, 1]")
            else:
                files = sorted(Path(result["output_dir"]).glob("*_pred.tif"))
                check(result["num_predictions"] == N_TST and len(files) == N_TST,
                      f"expected {N_TST} rasters, found {len(files)}")
                raster, _ = read_geotiff(files[0])
                check(raster.shape == (512, 512, 1) and raster.dtype.name == "uint8"
                      and set(raster.ravel().tolist()) <= {0, 1}, "bad prediction raster")
        breakdown(torch, config)
        for extra in path.serving_checks:
            extra(torch, config)


def dynamic_check(torch, config: dict) -> None:
    """One bs-8 512^2 forward of SegFormer with the channel-agnostic
    Dynamic MiT on a 4-band batch (tst patches with their first band
    repeated): finite logits of the input's size, K1 once and K10 six
    times."""
    import numpy as np

    from geo_deep_learning_tpu_torch.cli.config import instantiate
    from geo_deep_learning_tpu_torch.core.precision import PrecisionPolicy
    from geo_deep_learning_tpu_torch.ops.cuda import _lib
    from geo_deep_learning_tpu_torch.training.steps import make_predict_step

    node = copy.deepcopy(config["model"])
    node["init_args"]["use_dynamic_encoder"] = True
    spec = instantiate(node)
    spec.task.materialize(torch.device("cuda"), config["seed_everything"])
    data = instantiate(config["data"])
    data.setup("test")
    images = np.stack([data.datasets["tst"][i]["image"] for i in range(BATCH)])
    mean, std = config["data"]["init_args"]["mean"], config["data"]["init_args"]["std"]
    batch = {
        "image": torch.from_numpy(np.concatenate([images, images[..., :1]], axis=-1)).cuda(),
        "mean": torch.tensor(mean + mean[:1], device="cuda"),
        "std": torch.tensor(std + std[:1], device="cuda"),
    }
    step = make_predict_step(spec.task, PrecisionPolicy.create("bf16-mixed"))
    torch.cuda.synchronize()
    _lib.reset_launches()
    probs = step(batch)["probs"]
    torch.cuda.synchronize()
    got = dict(_lib.LAUNCHES)
    print(f"  Dynamic MiT, 4 bands, bs {BATCH} 512^2: probs {tuple(probs.shape)}, launches {got}")
    check(probs.shape == (BATCH, 1, 512, 512) and torch.isfinite(probs).all().item(),
          "Dynamic MiT: bad output")
    check(got == SEG_PER_BATCH, f"Dynamic MiT: launches {got}, expected {SEG_PER_BATCH}")


def _crops(torch, config: dict, size: int) -> dict:
    """Two ``size``^2 crops of tst patches 0 and 1 as a host batch."""
    import numpy as np

    from geo_deep_learning_tpu_torch.cli.config import instantiate

    data = instantiate(config["data"])
    data.setup("test")
    samples = [data.datasets["tst"][i] for i in (0, 1)]
    return {
        "image": torch.from_numpy(np.stack([s["image"][:size, :size] for s in samples])),
        "mask": torch.from_numpy(np.stack([s["mask"][:size, :size] for s in samples])),
        "mean": torch.from_numpy(samples[0]["mean"]),
        "std": torch.from_numpy(samples[0]["std"]),
    }


def _train_once(torch, spec, model, batch: dict, precision: str, freeze=None):
    """One train step of ``model`` (no augmentation, no clipping) -> (loss,
    gradients by name, launches). The optimizer's LR is 0 (the weights do
    not move) unless the encoder is frozen, where Adam at 1e-3 shows what
    moves."""
    import dataclasses

    from geo_deep_learning_tpu_torch.core.precision import PrecisionPolicy
    from geo_deep_learning_tpu_torch.core.train_state import TrainState
    from geo_deep_learning_tpu_torch.ops.cuda import _lib
    from geo_deep_learning_tpu_torch.training import optim
    from geo_deep_learning_tpu_torch.training.steps import make_train_step

    optim.freeze(model, freeze)
    params = [p for p in model.parameters() if p.requires_grad]
    opt = optim.build_optimizer(params, "adam", 1e-3) if freeze else torch.optim.SGD(params, lr=0.0)
    grads = {}
    opt.register_step_pre_hook(lambda o, a, k: grads.update(
        {n: p.grad.detach().float().cpu() for n, p in model.named_parameters() if p.grad is not None}))
    task = dataclasses.replace(spec.task, model=model)
    step = make_train_step(task, PrecisionPolicy.create(precision), augment=None, grad_clip=None)
    device = next(model.parameters()).device
    _lib.reset_launches()
    out = step(TrainState.create(model, opt, 0), {k: v.to(device) for k, v in batch.items()})
    if device.type == "cuda":
        torch.cuda.synchronize()
    return float(out["loss"]), grads, dict(_lib.LAUNCHES)


def cosine(a, b) -> float:
    a, b = a.double(), b.double()  # an f32 sum over ~1e6 terms can exceed 1
    return float((a * b).sum() / (a.norm() * b.norm()))


def _three_steps(torch, config: dict, size: int, launches_want: dict):
    """The config's model at full width, DropPath and dropout off, one train
    step on two ``size``^2 crops: on the card (bf16, kernels; its launches
    must be ``launches_want``), and on CPU copies in f32 and in bf16-mixed
    (plain versions). Returns ``(spec, batch, (card loss, card grads), (f32
    loss, f32 grads), (plain bf16 loss, plain bf16 grads))``."""
    from geo_deep_learning_tpu_torch.cli.config import instantiate
    from geo_deep_learning_tpu_torch.models.layers import DropPath, Dropout

    node = copy.deepcopy(config["model"])
    node["init_args"]["image_size"] = [size, size]
    spec = instantiate(node)
    model = spec.task.materialize(torch.device("cuda"), config["seed_everything"])
    for m in model.modules():
        if isinstance(m, (DropPath, Dropout)):
            m.rate = 0.0
    cpu_models = [copy.deepcopy(model).to("cpu") for _ in range(2)]
    batch = _crops(torch, config, size)
    loss, grads, launches = _train_once(torch, spec, model, batch, "bf16-mixed")
    check(launches == launches_want, f"train step launches {launches}, expected {launches_want}")
    f32_loss, f32_grads, _ = _train_once(torch, spec, cpu_models[0], batch, "32-true")
    plain_loss, plain_grads, _ = _train_once(torch, spec, cpu_models[1], batch, "bf16-mixed")
    check(set(grads) == set(f32_grads) == set(plain_grads), "steps reached different parameters")
    return spec, batch, (loss, grads), (f32_loss, f32_grads), (plain_loss, plain_grads)


def train_reference_check(torch, config: dict, size: int = 128,
                          per_step: dict = PER_TRAIN_STEP, limits=TRAIN_LIMITS) -> None:
    """One full-width train step on two ``size``^2 crops, on the card (bf16
    autocast, kernels K1-K3, K5, K6 and the attention pair of the crops'
    token count: K4/K7 at 128^2, K8/K9 at 576^2) and with the same weights
    on the CPU, in f32 and in bf16-mixed (plain versions); DropPath and
    dropout off.

    With the 128^2 ``limits``: the Dice loss must agree with f32 to 2e-2.
    Gradients are held against
    f32 for the weight and LayerScale tensors of the encoder's blocks, the
    tensors that K5-K7 reach (their biases are left out: ahead of the
    neck's BatchNorm their token sums cancel to ~1e-13, pure rounding
    noise in any precision). bf16 alone takes these gradients well away
    from f32 at random weights (per-tensor cosines of 0.92-0.98 on the
    CPU's plain path, measured at a narrow width), so the bound is
    relative: per tensor, the card's cosine to f32 must be at least 0.5
    (a wrong sign or scrambled heads gives about 0 or less) and at least
    the plain bf16 path's cosine minus 0.1; over all of them together,
    the card's cosine must be at least the plain path's minus 0.02 and the
    gradients' norm within 10 % of f32's (``TRAIN_LIMITS_640`` at 576^2).
    Then, at 128^2, a frozen-encoder step on the card must launch no K5-K7
    and leave the encoder as it was."""
    loss_tol, tensor_gap, all_gap, norm_tol = limits
    spec, batch, (loss, grads), (f32_loss, f32_grads), (_, plain_grads) = _three_steps(
        torch, config, size, per_step)
    names = [n for n in f32_grads if n.startswith("encoder.blocks.") and not n.endswith(".bias")]
    card = {n: cosine(grads[n], f32_grads[n]) for n in names}
    plain = {n: cosine(plain_grads[n], f32_grads[n]) for n in names}
    flat = [torch.cat([g[n].flatten() for n in names]) for g in (grads, plain_grads, f32_grads)]
    all_card, all_plain = cosine(flat[0], flat[2]), cosine(flat[1], flat[2])
    ratio = float(flat[0].norm() / flat[2].norm())
    worst = min(names, key=lambda n: card[n] - plain[n])
    print(f"  train step, card bf16 vs CPU f32, 2 x {size}^2: loss {loss:.6f} vs {f32_loss:.6f} "
          f"(tolerance {loss_tol:g})")
    print(f"  {len(names)} encoder-block gradients vs f32: cosine card {min(card.values()):.4f} "
          f"lowest, {all_card:.4f} all together (norm ratio {ratio:.4f}); plain bf16 "
          f"{min(plain.values()):.4f} lowest, {all_plain:.4f} together; largest shortfall "
          f"{plain[worst] - card[worst]:.4f} ({worst})")
    check(math.isfinite(loss) and abs(loss - f32_loss) <= loss_tol, "train loss disagrees with f32")
    check(all(card[n] >= max(0.5, plain[n] - tensor_gap) for n in names),
          "encoder gradients disagree")
    check(all_card >= all_plain - all_gap and abs(ratio - 1.0) <= norm_tol,
          "encoder gradients disagree")
    if size != 128:
        return

    frozen = spec.task.materialize(torch.device("cuda"), config["seed_everything"])
    before = {n: p.detach().clone() for n, p in frozen.named_parameters()}
    _, fgrads, launches = _train_once(torch, spec, frozen, batch, "bf16-mixed", ["encoder"])
    moved = {n for n, p in frozen.named_parameters() if not torch.equal(p.detach(), before[n])}
    print(f"  frozen-encoder step: launches {launches}; {len(moved)} tensors moved, none in the encoder")
    check(not any(k in launches for k in BACKWARD), "a frozen encoder launched a backward kernel")
    check(all(launches.get(k) == v for k, v in PER_BATCH.items()), "frozen step: forward launches")
    check(moved and not any(n.startswith("encoder.") for n in moved | set(fgrads)),
          "a frozen encoder moved or got gradients")


def segformer_train_check(torch, config: dict) -> None:
    """One full-width SegFormer mit_b0 train step on two whole 512^2
    patches, on the card (bf16 autocast, K1 and K10 at all three of its
    path shapes) and with the same weights on the CPU in f32 and in
    bf16-mixed (plain versions); DropPath and dropout off. Gradients are
    compared per encoder stage (its patch embedding, blocks and norm, all
    weights but the biases, which ahead of a LayerNorm or the decoder's
    BatchNorm carry rounding noise) and over the whole encoder.

    Limits, from the readings on an H100 80GB HBM3 (the plain bf16 path is
    printed beside them as the yardstick): 1 - cosine to f32 at most
    SEG_COS_GAP per stage and over the encoder (card 9e-6 to 2.5e-5, plain
    bf16 3.1e-5 to 1.0e-4: ten times the card's worst, and 2.4 times the
    plain path's, while a scrambled head or tile is off by 1e-2 or more);
    the encoder gradients' norm within 1e-2 of f32's (card 1.1e-3); the
    Dice loss within 5e-4 of f32 (card 1.2e-5, plain bf16 8.2e-5)."""
    size = 512
    _, _, (loss, grads), (f32_loss, f32_grads), (plain_loss, plain_grads) = _three_steps(
        torch, config, size, SEG_PER_TRAIN_STEP)

    def flat(g, names):
        return torch.cat([g[n].flatten() for n in names])

    print(f"  SegFormer train step, 2 x {size}^2: loss card bf16 {loss:.7f}, CPU f32 "
          f"{f32_loss:.7f}, plain bf16 {plain_loss:.7f}; |card - f32| {abs(loss - f32_loss):.3e}, "
          f"|plain - f32| {abs(plain_loss - f32_loss):.3e} (tolerance 5e-4)")
    check(math.isfinite(loss) and abs(loss - f32_loss) <= 5e-4, "train loss disagrees with f32")
    every = []
    for stage in range(1, 5):
        names = [n for n in f32_grads if not n.endswith(".bias") and any(
            n.startswith(f"encoder.{part}{stage}") for part in ("patch_embed", "block", "norm"))]
        every += names
        card = cosine(flat(grads, names), flat(f32_grads, names))
        plain = cosine(flat(plain_grads, names), flat(f32_grads, names))
        print(f"  stage {stage}, {len(names)} weight gradients vs f32: 1 - cosine card "
              f"{1 - card:.3e}, plain bf16 {1 - plain:.3e} (tolerance {SEG_COS_GAP:g})")
        check(1 - card <= SEG_COS_GAP, f"stage {stage} gradients disagree")
    card = cosine(flat(grads, every), flat(f32_grads, every))
    plain = cosine(flat(plain_grads, every), flat(f32_grads, every))
    ratio = float(flat(grads, every).norm() / flat(f32_grads, every).norm())
    print(f"  encoder, {len(every)} gradients: 1 - cosine card {1 - card:.3e}, plain bf16 "
          f"{1 - plain:.3e} (tolerance {SEG_COS_GAP:g}), norm ratio {ratio:.6f} (within 1e-2 of 1)")
    check(1 - card <= SEG_COS_GAP and abs(ratio - 1.0) <= 1e-2, "encoder gradients disagree")


# UNet++ gradient groups: the encoder's stem and stages, the decoder, the head
UNETPP_GROUPS = (
    ("stem", ("encoder.conv1.", "encoder.bn1.")),
    *((f"layer{i}", (f"encoder.layer{i}.",)) for i in range(1, 5)),
    ("decoder", ("decoder.",)),
    ("head", ("segmentation_head.",)),
)


def unetpp_train_check(torch, config: dict) -> None:
    """One full-width UNet++ train step (train-mode BatchNorm) on two 256^2
    crops, on the card (bf16 autocast, K1, cuDNN convs) and with the same
    weights on the CPU in f32 and in bf16-mixed (plain versions).

    bf16 alone takes the encoder's gradients far from f32 at random weights
    (1 - cosine 0.054-0.15 per stage on the plain path, 1.8e-3 for the
    decoder), so the plain bf16 path is the yardstick. Limits, from the
    readings on an H100 80GB HBM3 (card / plain: stages 0.90-1.14, decoder
    1.08, head 1.09; norm ratio off 1 by 4.6e-4, plain 3.7e-4; loss off f32
    by 6.5e-5, plain 2.7e-5): per group (stem, layer1-4, decoder, head)
    1 - cosine to f32 at most twice the plain path's, and at least 1e-3 (a
    wrong or scrambled gradient is off by far more); over all of them, the
    norm ratio within max(3 x the plain path's distance, 5e-3) of 1; the
    Dice loss within max(3 x the plain path's distance, 5e-4) of f32."""
    size = 256
    _, _, (loss, grads), (f32_loss, f32_grads), (plain_loss, plain_grads) = _three_steps(
        torch, config, size, UNETPP_PER_TRAIN_STEP)

    def flat(g, names):
        return torch.cat([g[n].flatten() for n in names])

    loss_gap, plain_gap = abs(loss - f32_loss), abs(plain_loss - f32_loss)
    print(f"  UNet++ train step, 2 x {size}^2: loss card bf16 {loss:.7f}, CPU f32 {f32_loss:.7f}, "
          f"plain bf16 {plain_loss:.7f}; |card - f32| {loss_gap:.3e}, |plain - f32| "
          f"{plain_gap:.3e} (tolerance {max(3 * plain_gap, 5e-4):.3e})")
    check(math.isfinite(loss) and loss_gap <= max(3 * plain_gap, 5e-4),
          "train loss disagrees with f32")
    every = []
    for group, prefixes in UNETPP_GROUPS:
        names = [n for n in f32_grads if n.startswith(prefixes)]
        check(bool(names), f"no gradients in group {group}")
        every += names
        card = 1 - cosine(flat(grads, names), flat(f32_grads, names))
        plain = 1 - cosine(flat(plain_grads, names), flat(f32_grads, names))
        tol = max(2 * plain, 1e-3)
        print(f"  {group}, {len(names)} gradients vs f32: 1 - cosine card {card:.3e}, plain bf16 "
              f"{plain:.3e} (tolerance {tol:.3e})")
        check(card <= tol, f"{group} gradients disagree")
    check(set(every) == set(f32_grads), "a gradient outside the groups")
    ratio = float(flat(grads, every).norm() / flat(f32_grads, every).norm())
    plain_ratio = float(flat(plain_grads, every).norm() / flat(f32_grads, every).norm())
    tol = max(3 * abs(plain_ratio - 1), 5e-3)
    print(f"  all {len(every)} gradients: norm ratio card {ratio:.6f}, plain bf16 {plain_ratio:.6f} "
          f"(within {tol:.3e} of 1)")
    check(abs(ratio - 1) <= tol, "gradient norms disagree")


def train_timing(torch, config: dict, smi: str, tmp: Path, label: str) -> None:
    """Train steps on bs-8 batches of the config's patches already on the
    card (augmentation on, as in fit), and one checkpoint write of the whole
    train state."""
    from geo_deep_learning_tpu_torch.cli.config import instantiate
    from geo_deep_learning_tpu_torch.core.precision import PrecisionPolicy
    from geo_deep_learning_tpu_torch.core.train_state import TrainState
    from geo_deep_learning_tpu_torch.training import optim
    from geo_deep_learning_tpu_torch.training.checkpoint import CheckpointManager
    from geo_deep_learning_tpu_torch.training.steps import make_train_step, to_device

    spec = instantiate(config["model"])
    model = spec.task.materialize(torch.device("cuda"), config["seed_everything"])
    state = TrainState.create(model, optim.build_optimizer(model.parameters(), "adam", 6e-5), 0)
    step = make_train_step(spec.task, PrecisionPolicy.create("bf16-mixed"))
    loader = instantiate(config["data"]).test_dataloader()
    batches = [to_device(b, torch.device("cuda")) for b, _ in zip(loader, range(3))]
    for b in batches[:2]:
        step(state, b)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    n = 6
    t0 = time.perf_counter()
    for i in range(n):
        step(state, batches[i % len(batches)])
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / n
    t0 = time.perf_counter()
    path = CheckpointManager(tmp / "timing").save_last(state)
    write_s = time.perf_counter() - t0
    size = config["model"]["init_args"]["image_size"][0]
    print(f"  {label} train steps on resident batches: {ms:.2f} ms per bs-{BATCH} {size}^2 step "
          f"= {1e3 * BATCH / ms:.2f} patches/s; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; on {smi}")
    print(f"  checkpoint write: {write_s:.3f} s for {path.stat().st_size / 2**30:.3f} GiB; on {smi}")
    path.unlink()
    profile_steps(torch, lambda i: step(state, batches[i % len(batches)]), ms, smi)
    if hasattr(model, "neck") and size == 512:  # the profiling tools and the A/B at 512^2 only
        profiling_check(torch, lambda i: step(state, batches[i % len(batches)]), ms, smi, tmp)
        fused_ab(torch, model, lambda: step(state, batches[0]), smi, label)


# K1-K7 in profiling_check's trace: each kernel's launch counter and a
# pattern of its device kernel's name, demangled or mangled (K7 by its dQ
# kernel: a launch runs the delta, dK/dV and dQ kernels)
TRACE_KERNELS = (
    ("preprocess", r"preprocess_kernel"),
    ("layernorm_fwd", r"layernorm_fwd_kernel(<[^>]*false>|I.*Lb0E)"),
    ("layernorm_residual_fwd", r"layernorm_fwd_kernel(<[^>]*true>|I.*Lb1E)"),
    ("attention_fwd_packed", r"attention_fwd_wgmma_kernel"),
    ("layernorm_bwd", r"layernorm_bwd_kernel(<[^>]*false>|I.*Lb0E)"),
    ("layernorm_residual_bwd", r"layernorm_bwd_kernel(<[^>]*true>|I.*Lb1E)"),
    ("attention_bwd_packed", r"attention_bwd_dq_wgmma_kernel"),
)
TRACE_STEPS = 2  # traced, and StepTimer's warmup
TIMER_STEPS = 6


def profiling_check(torch, step, step_ms: float, smi: str, tmp: Path) -> None:
    """``tools/profiling.py`` over the resident DOFA-base 512^2 bf16 train
    step: ``StepTimer(warmup=TRACE_STEPS)`` over ``TIMER_STEPS`` steps, the
    first ``TRACE_STEPS`` inside ``trace()``, each in
    ``annotate("train_step")``. The exported Chrome trace must hold the
    annotation and K1-K7's device kernels at ``PER_TRAIN_STEP`` launches a
    step (no CUDA events fails the run), and ``device_memory_stats()`` the
    allocator's numbers."""
    import re

    from geo_deep_learning_tpu_torch.ops.cuda import _lib
    from geo_deep_learning_tpu_torch.tools.profiling import (
        StepTimer,
        annotate,
        device_memory_stats,
        trace,
    )

    print(f"  profiling tools: StepTimer over {TIMER_STEPS} steps, the first {TRACE_STEPS} "
          "(its warmup) traced")
    timer = StepTimer(warmup=TRACE_STEPS, device="cuda")
    log_dir = tmp / "trace"
    torch.cuda.synchronize()
    _lib.reset_launches()
    t0 = time.perf_counter()
    with trace(log_dir, device="cuda"):
        for i in range(TRACE_STEPS):
            with timer.step(), annotate("train_step"):
                step(i)
    trace_s = time.perf_counter() - t0
    launches = dict(_lib.LAUNCHES)
    for i in range(TRACE_STEPS, TIMER_STEPS):
        with timer.step():
            step(i)
    summary = timer.summary(items_per_step=BATCH)
    files = list(log_dir.glob("*.pt.trace.json"))
    check(len(files) == 1, f"trace(): {len(files)} trace files in {log_dir}")
    events = json.loads(files[0].read_text())["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    check(bool(kernels), "trace(): no CUDA kernel in the trace (the CPU alone was recorded)")
    spans = {e.get("cat") for e in events if e.get("name") == "train_step"}
    found = {name: sum(bool(re.search(pattern, k)) for k in kernels)
             for name, pattern in TRACE_KERNELS}
    want = {name: PER_TRAIN_STEP[name] * TRACE_STEPS for name, _ in TRACE_KERNELS}
    print(f"  trace: {len(events)} events, {len(kernels)} CUDA kernels; K1-K7 by kernel name "
          f"{found} in {TRACE_STEPS} steps; launch counters {launches}; train_step spans "
          f"{sorted(map(str, spans))}")
    if found != want:  # the launches the trace holds no kernel record for
        recorded = {e.get("args", {}).get("correlation") for e in events
                    if e.get("cat") == "kernel"}
        lost = [e["ts"] for e in events if e.get("cat") == "cuda_runtime"
                and "aunch" in e.get("name", "")
                and e.get("args", {}).get("correlation") not in recorded]
        print(f"  trace: {len(lost)} kernel launches without a kernel record, at {lost[:8]} us")
    stats = device_memory_stats()
    total = torch.cuda.mem_get_info()[1]
    print(f"  StepTimer: {summary['steps_timed']} steps, p50 {1e3 * summary['p50_step_s']:.2f} ms, "
          f"p95 {1e3 * summary['p95_step_s']:.2f} ms, mean {1e3 * summary['mean_step_s']:.2f} ms "
          f"({summary['items_per_sec']:.2f} patches/s); resident step {step_ms:.2f} ms; trace of "
          f"{TRACE_STEPS} steps {trace_s:.2f} s (export included), "
          f"{files[0].stat().st_size / 2**20:.2f} MiB on disk; device_memory_stats {stats}; "
          f"on {smi}")
    check("user_annotation" in spans, "trace(): no annotate('train_step') span in the trace")
    check(found == want, f"trace(): K1-K7 kernels {found}, expected {want}")
    check(launches == want, f"trace(): launches {launches}, expected {want}")
    check(len(stats) == torch.cuda.device_count() and stats[0]["bytes_in_use"] > 0
          and stats[0]["peak_bytes_in_use"] >= stats[0]["bytes_in_use"]
          and stats[0]["bytes_limit"] == total, f"device_memory_stats: {stats}")


def loader_probe(torch, config: dict, smi: str, csv_dir: Path, n: int = 10) -> None:
    """``fit``'s train loop by hand over ``n`` bs-8 batches of the threaded
    train loader: host ms a step waiting for the loader, in ``to_device``
    and enqueuing the step, and the wall ms a step; with the batch copied
    to the card from pageable memory (``to_device``, as ``fit`` does) and
    from pinned memory with a non-blocking copy, in turns pageable, pinned,
    pinned, pageable. A pageable copy waits for the card's queue before the
    host goes on, so host and card take turns instead of overlapping."""
    import numpy as np

    from geo_deep_learning_tpu_torch.cli.config import instantiate
    from geo_deep_learning_tpu_torch.core.precision import PrecisionPolicy
    from geo_deep_learning_tpu_torch.core.train_state import TrainState
    from geo_deep_learning_tpu_torch.training import optim
    from geo_deep_learning_tpu_torch.training.steps import _DEVICE_KEYS, make_train_step, to_device

    cuda = torch.device("cuda")

    def pinned(batch: dict) -> dict:
        out = dict(batch)
        for key in _DEVICE_KEYS:
            if key in batch:
                host = torch.from_numpy(np.ascontiguousarray(batch[key])).pin_memory()
                out[key] = host.to(cuda, non_blocking=True)
        return out

    spec = instantiate(config["model"])
    model = spec.task.materialize(cuda, config["seed_everything"])
    state = TrainState.create(model, optim.build_optimizer(model.parameters(), "adam", 6e-5), 0)
    step = make_train_step(spec.task, PrecisionPolicy.create("bf16-mixed"))
    node = copy.deepcopy(config["data"])
    node["init_args"].update(csv_root_folder=str(csv_dir))
    data = instantiate(node)
    data.setup("fit")
    procs = instantiate(grain_node(node))
    procs.set_device(cuda)
    procs.setup("fit")
    to_card = lambda b: to_device(b, cuda)  # noqa: E731
    for label, module, copy_fn in (
            ("threads, pageable", data, to_card), ("threads, pinned", data, pinned),
            (f"{GRAIN_WORKERS} worker processes, pinned by the loader", procs, to_card),
            (f"{GRAIN_WORKERS} worker processes, pinned by the loader", procs, to_card),
            ("threads, pinned", data, pinned), ("threads, pageable", data, to_card)):
        it = iter(module.train_dataloader())
        t0 = time.perf_counter()
        first = next(it)
        if module is procs and procs.startup_s is not None:
            print(f"  loader probe: worker processes up, first batch after {procs.startup_s:.2f} s "
                  f"({time.perf_counter() - t0:.2f} s this wait); on {smi}")
            procs.startup_s = None
        step(state, copy_fn(first))
        torch.cuda.synchronize()
        wait = put = enqueue = 0.0
        t_start = time.perf_counter()
        for _ in range(n - 1):
            t0 = time.perf_counter()
            batch = next(it)
            t1 = time.perf_counter()
            dev = copy_fn(batch)
            t2 = time.perf_counter()
            step(state, dev)
            t3 = time.perf_counter()
            wait, put, enqueue = wait + t1 - t0, put + t2 - t1, enqueue + t3 - t2
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_start
        del it
        k = 1e3 / (n - 1)
        print(f"  loader probe, {label} copies: {wall * k:.2f} ms a step (loader wait "
              f"{wait * k:.2f}, to the card {put * k:.2f}, step enqueue {enqueue * k:.2f}); "
              f"{BATCH * (n - 1) / wall:.2f} train patches/s; on {smi}")
    procs.close()
    check(not loader_threads(), "loader probe: loader threads left alive")
    check(not worker_processes() and not pin_threads(), "loader probe: workers left alive")


def fused_ab(torch, model, step, smi: str, label: str, n: int = 6) -> None:
    """Train steps with the neck's and UperNet's factored forms on (the
    default) and off (resize, then conv): ``n`` steps a turn in the order
    on, off, off, on, three times, each side's median ms a step and peak memory,
    then the plain side's profile by family (the fused side's is the one
    :func:`train_timing` printed)."""
    import statistics

    def set_fused(on: bool) -> None:
        model.neck.fuse_scale4 = model.decoder.fuse_bottleneck = on

    times: dict[bool, list[float]] = {True: [], False: []}
    peaks: dict[bool, float] = {}
    for on in (True, False, False, True) * 3:
        set_fused(on)
        step()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        times[on].append(1e3 * (time.perf_counter() - t0) / n)
        peaks[on] = torch.cuda.max_memory_allocated() / 2**30
    med = {on: statistics.median(t) for on, t in times.items()}
    print(f"  {label} factored neck + UperNet A/B, ms per train step: fused median "
          f"{med[True]:.2f} ({', '.join(f'{t:.2f}' for t in times[True])}), plain median "
          f"{med[False]:.2f} ({', '.join(f'{t:.2f}' for t in times[False])}); peak memory fused "
          f"{peaks[True]:.2f} GiB, plain {peaks[False]:.2f} GiB; on {smi}")
    set_fused(False)
    print("  plain (resize, then conv) profile:")
    profile_steps(torch, lambda i: step(), med[False], smi)
    set_fused(True)


# kernel-name fragments -> family, tried in order (cuDNN's convolution
# kernels are xmma kernels too, so they are matched first)
FAMILIES = (
    ("K1-K11", ("preprocess_kernel", "layernorm_fwd_kernel", "layernorm_bwd_kernel",
                "attention_fwd_wgmma_kernel", "attention_bwd_", "sr_attention_fwd_",
                "attention_fwd_tf32_kernel", "attention_delta_f32_kernel",
                "packed_conv_", "column_sum_kernel")),
    ("convolution", ("conv", "fprop", "dgrad", "wgrad", "cudnn", "implicit")),
    ("GEMM", ("gemm", "nvjet", "cutlass", "xmma")),
)


def profile_steps(torch, step, step_ms: float, smi: str, n: int = 2) -> None:
    """Device time of ``n`` train steps by kernel family and the largest
    kernels. The card's idle share is taken against ``step_ms``, the step
    time measured without the profiler, whose own host work slows the
    profiled window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n):
            step(i)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    kernels: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            kernels[e.name] = kernels.get(e.name, 0.0) + e.time_range.elapsed_us()
    check(bool(kernels), "the profiler recorded no kernel on the card")
    families = {name: 0.0 for name, _ in FAMILIES} | {"other": 0.0}
    for name, us in kernels.items():
        low = name.lower()
        fam = next((f for f, keys in FAMILIES if any(k.lower() in low for k in keys)), "other")
        families[fam] += us
    busy = sum(kernels.values())
    print(f"  profile of {n} train steps: {busy / n / 1e3:.2f} ms of kernels per step "
          f"({wall_us / n / 1e3:.2f} ms wall under the profiler); against the unprofiled "
          f"{step_ms:.2f} ms step the card is idle {100 * (1 - busy / n / 1e3 / step_ms):.1f} %; "
          f"on {smi}")
    print("  by family, ms per step: " + ", ".join(
        f"{f} {us / n / 1e3:.2f}" for f, us in sorted(families.items(), key=lambda kv: -kv[1])))
    for name, us in sorted(kernels.items(), key=lambda kv: -kv[1])[:12]:
        print(f"    {us / n / 1e3:8.3f} ms  {name[:110]}")


def column_phase(torch, smi: str) -> dict[str, int]:
    """The UNet++ finest-column entry point at its shapes: the kernel column
    (eight K11 legs) against the cuDNN column, their relative error below
    ``COLUMN_REL_ERR``, and exactly 8 K11 launches per kernel-column call.
    Returns the run's launch counts."""
    from geo_deep_learning_tpu_torch.ops.cuda import _lib
    from geo_deep_learning_tpu_torch.tools import bench_column

    torch.cuda.synchronize()
    _lib.reset_launches()
    result = bench_column.main(COLUMN_ARGS)
    torch.cuda.synchronize()
    counts = dict(_lib.LAUNCHES)
    want = {"packed_conv_bn_stats": 8 * result["kernel_calls"]}
    print(f"  column (8 legs at [32,256,256,64] bf16, BN statistics included): kernel "
          f"{result['kernel_ms']:.3f} ms, cuDNN {result['torch_ms']:.3f} ms, bound "
          f"{result['bound_ms']:.3f} ms; on {smi}")
    print(f"  column: relative error {result['rel_err']:.3g} (limit {COLUMN_REL_ERR:g}); "
          f"launches {counts} over {result['kernel_calls']} kernel-column calls")
    check(math.isfinite(result["rel_err"]) and result["rel_err"] < COLUMN_REL_ERR,
          "the kernel column disagrees with the cuDNN column")
    check(counts == want, f"column: launches {counts}, expected {want}")
    return counts


class FitClock:
    """``fit``'s train loop split by host time a step (``training.loop``'s
    ``to_device`` and ``make_train_step`` wrapped for the run): waiting for
    the loader (from the end of one train step to the next ``to_device``),
    ``to_device`` and the train step's enqueue. An epoch's first step has
    no wait of its own (the val pass and the checkpoint come before it)."""

    def __enter__(self):
        from geo_deep_learning_tpu_torch.training import loop

        self.loop, self.real = loop, (loop.to_device, loop.make_train_step)
        self.steps: list[tuple[float, float, float, float]] = []  # start, copy end, end, wait
        self.copied: tuple[float, float] | None = None
        clock = self

        def to_device(batch, device):
            t0 = time.perf_counter()
            out = clock.real[0](batch, device)
            clock.copied = (t0, time.perf_counter())
            return out

        def make_train_step(*args, **kwargs):
            step = clock.real[1](*args, **kwargs)

            def timed(state, batch):
                (t0, t1), end = clock.copied, clock.steps[-1][2] if clock.steps else None
                out = step(state, batch)
                clock.steps.append((t0, t1, time.perf_counter(),
                                    float("nan") if end is None else t0 - end))
                return out

            return timed

        loop.to_device, loop.make_train_step = to_device, make_train_step
        return self

    def __exit__(self, *exc):
        self.loop.to_device, self.loop.make_train_step = self.real

    def report(self, per_epoch: int, last_epoch_s: float) -> str:
        """Per epoch: ms a step from its first step's copy to its last step's
        end, and the mean loader wait (steps 2 on), copy and enqueue; and
        the last epoch's train-loop time outside that span (``fit``'s
        ``epoch_time_s`` less it: the wait for the pass's first batch)."""
        out = []
        for e in range(0, len(self.steps), per_epoch):
            ep = self.steps[e : e + per_epoch]
            waits = [s[3] for s in ep[1:]]
            k = 1e3 / len(ep)
            wait = 1e3 * sum(waits) / len(waits) if waits else float("nan")
            out.append(f"epoch {e // per_epoch}: {(ep[-1][2] - ep[0][0]) * k:.2f} ms a step "
                       f"(loader wait {wait:.2f}, to the card "
                       f"{sum(s[1] - s[0] for s in ep) * k:.2f}, step enqueue "
                       f"{sum(s[2] - s[1] for s in ep) * k:.2f})")
        last = self.steps[-per_epoch:]
        out.append(f"last epoch's first-batch wait "
                   f"{1e3 * (last_epoch_s - (last[-1][2] - last[0][0])):.1f} ms")
        return "; ".join(out)


class VizLog:
    """The samples ``fit`` hands to visualization on each new best
    (``Trainer._log_visualizations`` wrapped for the run), and the
    rendering failures the trainer logs (matplotlib is absent on the
    card's machine)."""

    def __enter__(self):
        import logging

        from geo_deep_learning_tpu_torch.training import loop

        self.trainer, self.real = loop.Trainer, loop.Trainer._log_visualizations
        self.samples: list[tuple[int, dict]] = []
        self.failures = 0
        viz = self

        def record(trainer, task, sample, epoch):
            viz.samples.append((epoch, sample))
            return viz.real(trainer, task, sample, epoch)

        class Failures(logging.Handler):
            def emit(self, record):
                viz.failures += record.getMessage() == "visualization failed"

        self.logger, self.handler = logging.getLogger(loop.__name__), Failures()
        self.logger.addHandler(self.handler)
        self.trainer._log_visualizations = record
        return self

    def __exit__(self, *exc):
        self.trainer._log_visualizations = self.real
        self.logger.removeHandler(self.handler)


def run_record_check(torch, config: dict, tmp: Path, viz: VizLog, best: str) -> None:
    """What ``fit`` recorded: its run directory at ``<save_dir>/<run_name>-*``
    (the ``trainer.logger`` node) with the metrics, params and archived
    config, none under the checkpoints; ``VIZ_SAMPLES`` figures on each new
    best where matplotlib imports, else one logged rendering failure a new
    best; and the first val batch's predictions handed over on the last new
    best equal to the eval step's for that batch from the best checkpoint."""
    import importlib.util

    import numpy as np

    from geo_deep_learning_tpu_torch.cli.config import instantiate
    from geo_deep_learning_tpu_torch.cli.main import build_trainer_config
    from geo_deep_learning_tpu_torch.core.precision import PrecisionPolicy
    from geo_deep_learning_tpu_torch.training.checkpoint import CheckpointManager
    from geo_deep_learning_tpu_torch.training.steps import make_eval_step

    args = config["trainer"]["logger"]["init_args"]
    runs = sorted(Path(args["save_dir"]).glob(f"{args['run_name']}-*"))
    check(len(runs) == 1, f"fit: {len(runs)} run directories at {args['save_dir']}")
    files = ("metrics.jsonl", "params.json", "artifacts/config/run_config.yaml")
    check(all((runs[0] / f).is_file() for f in files), f"fit: {runs[0]} lacks one of {files}")
    check(not list((tmp / "fit" / "checkpoints").glob("run-*")),
          "fit: a run directory under the checkpoints")
    best_epochs = [e for e, _ in viz.samples]
    check(bool(best_epochs) and best_epochs[0] == 0, f"fit: samples at epochs {best_epochs}")
    if importlib.util.find_spec("matplotlib") is not None:
        names = sorted(p.name for p in (runs[0] / "figures").glob("*.png"))
        want = [f"epoch{e:03d}_sample{i}.png" for e in best_epochs for i in range(VIZ_SAMPLES)]
        check(names == want and viz.failures == 0, f"fit: figures {names}, expected {want}")
        shown = f"figures {names}"
    else:
        shown = "figures not rendered (no matplotlib on this host)"
        check(viz.failures == len(best_epochs),
              f"fit: {viz.failures} rendering failures logged for {len(best_epochs)} new bests")
    epoch, sample = viz.samples[-1]
    spec = instantiate(copy.deepcopy(config["model"]))
    model = spec.task.materialize(torch.device("cuda"), config["seed_everything"])
    CheckpointManager.load_model(best, model)
    policy = PrecisionPolicy.create(build_trainer_config(config["trainer"], 0).precision)
    want = make_eval_step(spec.task, policy)(to_card(torch, sample["batch"]))["preds"]
    same = float(np.mean(want.cpu().numpy() == sample["preds"]))
    print(f"  fit's run record: {runs[0].relative_to(args['save_dir'])} under save_dir; new bests "
          f"at epochs {best_epochs}; {shown}; the epoch-{epoch} sample's {sample['preds'].shape} "
          f"predictions equal to the best checkpoint's eval step at {100 * same:.4f} % of pixels")
    check(same == 1.0, "the predictions handed to visualization differ from the eval step's")


def write_split_csvs(tmp: Path, trn: range, val: range, tst: range) -> Path:
    """trn/val/tst CSVs of the given rows of the tst split of data/waterloo."""
    rows = [r for r in (DATA / "tst.csv").read_text().splitlines() if r.strip()]
    check(len(rows) == N_TST, f"expected {N_TST} tst rows, found {len(rows)}")
    csv_dir = tmp / "csv"
    csv_dir.mkdir(exist_ok=True)
    for split, part in (("trn", trn), ("val", val), ("tst", tst)):
        (csv_dir / f"{split}.csv").write_text("\n".join(rows[i] for i in part) + "\n")
    return csv_dir


def write_fit_csvs(tmp: Path) -> Path:
    """trn = tst rows 0-79, val = rows 80-99, tst = all 100."""
    return write_split_csvs(tmp, range(N_TRN), range(N_TRN, N_TRN + N_VAL), range(N_TST))


def fit_phase(torch, smi: str, tmp: Path, path: ModelPath, csv_dir: Path, patches: Path,
              splits: tuple[int, int, int] = (N_TRN, N_VAL, N_TST)) -> tuple[dict, dict, str]:
    """``run(config, "fit")`` for 2 epochs over the trn/val/tst CSVs in
    ``csv_dir`` (``splits`` rows each), with the recipes' ``trainer.logger``
    node and ``VisualizationCallback`` (``max_samples`` ``VIZ_SAMPLES``), its
    run record (:func:`run_record_check`), then ``run(config, "test")``
    from its best checkpoint. Returns the fit's launch counts, its config
    and the best checkpoint's path."""
    from geo_deep_learning_tpu_torch.ops.cuda import _lib

    import os

    from geo_deep_learning_tpu_torch.cli.config import instantiate

    n_trn, n_val, n_tst = splits
    config = copy.deepcopy(path.config)
    config["trainer"].update(default_root_dir=str(tmp / "fit"), max_epochs=FIT_EPOCHS)
    config["trainer"]["logger"] = {
        "class_path": RECIPE_RGB["trainer"]["logger"]["class_path"],
        "init_args": {"save_dir": str(tmp / "fit" / "runs"), "run_name": "chip_smoke_fit",
                      "experiment_name": "gdl_tpu_experiment"}}
    config["trainer"]["callbacks"] = [*config["trainer"].get("callbacks", []), {
        "class_path": RECIPE_RGB["trainer"]["callbacks"][-1]["class_path"],
        "init_args": {"max_samples": VIZ_SAMPLES}}]
    config["data"]["init_args"].update(csv_root_folder=str(csv_dir), patches_root_folder=str(patches))
    size = config["model"]["init_args"]["image_size"][0]
    data = instantiate(config["data"])
    data.setup("fit")
    n_decode = min(16, len(data.datasets["trn"]))
    t0 = time.perf_counter()
    for i in range(n_decode):
        data.datasets["trn"][i]
    decode_ms = 1e3 * (time.perf_counter() - t0) / n_decode
    from geo_deep_learning_tpu_torch.data import _native

    print(f"  loader: num_workers {data.num_workers}, os.cpu_count() {os.cpu_count()}, host "
          f"decode {decode_ms:.2f} ms a {size}^2 patch in one thread (tiff: "
          f"{_native.DECODERS.get('tiff')}); on {smi}")

    torch.cuda.synchronize()
    _lib.reset_launches()
    t0 = time.perf_counter()
    with FitClock() as clock, VizLog() as viz:
        result = run_checked(copy.deepcopy(config), "fit")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = dict(_lib.LAUNCHES)
    n_train = FIT_EPOCHS * (n_trn // BATCH)
    n_eval = FIT_EPOCHS * -(-n_val // BATCH) + -(-n_tst // BATCH)
    want = {k: v * n_train + path.per_batch.get(k, 0) * n_eval for k, v in path.per_step.items()}
    per_step = {k: (counts.get(k, 0) - path.per_batch.get(k, 0) * n_eval) / n_train for k in want}
    print(f"  fit: {FIT_EPOCHS} epochs x {n_trn // BATCH} steps, {n_eval} evaluated batches, "
          f"{seconds:.2f} s in all; last epoch {result['patches_per_sec']:.2f} train patches/s "
          f"(loader included; bs {BATCH}, {size}^2, {path.label}, bf16-mixed) on {smi}")
    print(f"  fit: {result}")
    print(f"  fit, {data.num_workers} reader threads, host split: "
          f"{clock.report(n_trn // BATCH, result['epoch_time_s'])}; on {smi}")
    print(f"  fit: launches {counts}; per train step {per_step}")
    check(counts == want, f"fit: launches {counts}, expected {want}")
    check(all(math.isfinite(v) for v in result.values()), "non-finite fit metric")
    index = json.loads((tmp / "fit" / "checkpoints" / "index.json").read_text())
    best = index["best_path"]
    check(best is not None and Path(best).exists(), "fit wrote no best checkpoint")
    run_record_check(torch, config, tmp, viz, best)

    tested = run_checked(copy.deepcopy(config), "test", ckpt_path=best)
    auto = {k: v for k, v in result.items() if k.startswith("test_")}
    diff = max(abs(tested[k] - auto[k]) for k in auto)
    print(f"  test from {Path(best).name}: {tested}; largest difference from the auto-test "
          f"{diff:.3g} (tolerance 1e-4)")
    check(set(tested) == set(auto) and diff <= 1e-4, "restored test disagrees with the auto-test")
    return counts, config, best


def grain_node(node: dict) -> dict:
    """A CSV data node as ``GrainCSVDataModule`` on GRAIN_WORKERS spawned
    worker processes, by its JAX class path (the CLI's alias)."""
    node = copy.deepcopy(node)
    node["class_path"] = GRAIN
    node["init_args"]["num_workers"] = GRAIN_WORKERS
    return node


class StartupLog:
    """The worker start-up times ``GrainCSVDataModule`` logs during a run."""

    def __enter__(self):
        import logging

        self.seconds: list[float] = []
        log = self

        class Handler(logging.Handler):
            def emit(self, record):
                if hasattr(record, "startup_s"):
                    log.seconds.append(record.startup_s)

        self.logger = logging.getLogger("geo_deep_learning_tpu_torch.data.grain_pipeline")
        self.level, self.handler = self.logger.level, Handler()
        self.logger.setLevel(logging.INFO)
        self.logger.addHandler(self.handler)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self.handler)
        self.logger.setLevel(self.level)


def grain_fit_phase(torch, smi: str, tmp: Path, config: dict, counts: dict, best: str,
                    n_trn: int = N_TRN) -> None:
    """The same ``fit`` as :func:`fit_phase`'s with ``GrainCSVDataModule`` on
    GRAIN_WORKERS spawned worker processes in place of the reader threads:
    train patches/s of the last epoch and the workers' start-up apart, the
    same launches as the threaded fit, no worker left; then ``test`` on the
    threaded fit's best checkpoint through both modules, with equal metrics
    (EVAL_EQUAL)."""
    from geo_deep_learning_tpu_torch.ops.cuda import _lib

    procs = copy.deepcopy(config)
    procs["data"] = grain_node(config["data"])
    procs["trainer"]["default_root_dir"] = str(tmp / "fit_processes")
    torch.cuda.synchronize()
    _lib.reset_launches()
    t0 = time.perf_counter()
    with StartupLog() as log, FitClock() as clock:
        result = run_checked(copy.deepcopy(procs), "fit")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    got = dict(_lib.LAUNCHES)
    size = config["model"]["init_args"]["image_size"][0]
    print(f"  fit on {GRAIN_WORKERS} spawned worker processes: {seconds:.2f} s in all, worker "
          f"start-up {', '.join(f'{s:.2f}' for s in log.seconds)} s (first batch); last epoch "
          f"{result['patches_per_sec']:.2f} train patches/s (loader included; bs {BATCH}, "
          f"{size}^2, bf16-mixed) on {smi}")
    print(f"  fit on worker processes: {result}")
    print(f"  fit, {GRAIN_WORKERS} worker processes, host split: "
          f"{clock.report(n_trn // BATCH, result['epoch_time_s'])}; on {smi}")
    check(got == counts, f"fit on worker processes: launches {got}, the threaded fit's {counts}")
    check(len(log.seconds) == 1, "the workers started more than once in one fit")
    check(all(math.isfinite(v) for v in result.values()), "non-finite fit metric")
    tested = {name: run_checked(copy.deepcopy(cfg), "test", ckpt_path=best)
              for name, cfg in (("threads", config), ("processes", procs))}
    diff = max(abs(tested["processes"][k] - tested["threads"][k]) for k in tested["threads"])
    print(f"  test from {Path(best).name} on worker processes: {tested['processes']}; largest "
          f"difference from the threads' {diff:.3g} (tolerance {EVAL_EQUAL:g})")
    check(set(tested["processes"]) == set(tested["threads"]) and diff <= EVAL_EQUAL,
          "test through GrainCSVDataModule disagrees with CSVDataModule's")


def scene_data(tmp: Path) -> tuple[Path, Path]:
    """The run's scene and 640^2 patches, made from the tst split.

    The scene: the 100 tst images mosaicked 10 x 10 in the CSV's row order
    into one 5120 x 5120 x 3 uint8 GeoTIFF (Deflate strips) with 0.3 m
    pixels and an EPSG code. The patches: its 64 non-overlapping 640^2
    crops and the label mosaic's, in row order, written as data/waterloo
    is (``{split}/image/{i}.tif``, ``{split}/label/{i}_lbl.tif``, one
    ``{split}.csv`` each): trn crops 0-47, val 48-55, tst 56-63. Returns
    (scene path, patches root)."""
    import numpy as np

    from geo_deep_learning_tpu_torch.data.geotiff import Affine, GeoInfo, read_geotiff, write_geotiff
    from geo_deep_learning_tpu_torch.data.geotiff_stream import GeoTiffStripWriter

    rows = [r.split(";") for r in (DATA / "tst.csv").read_text().splitlines() if r.strip()]
    check(len(rows) >= SCENE_GRID**2, f"expected {SCENE_GRID**2} tst rows, found {len(rows)}")
    image = np.zeros((SCENE_PX, SCENE_PX, 3), np.uint8)
    label = np.zeros((SCENE_PX, SCENE_PX, 1), np.uint8)
    for i, (img, lbl) in enumerate(rows[: SCENE_GRID**2]):
        r, c = divmod(i, SCENE_GRID)
        window = (slice(512 * r, 512 * (r + 1)), slice(512 * c, 512 * (c + 1)))
        image[window] = read_geotiff(DATA / img)[0]
        label[window] = read_geotiff(DATA / lbl)[0]
    scene = tmp / "scene.tif"
    with GeoTiffStripWriter(scene, SCENE_PX, 3, np.uint8,
                            geo=GeoInfo(Affine(*SCENE_TRANSFORM), SCENE_EPSG)) as w:
        w.write_rows(image)
    root = tmp / "patches640"
    per_side = SCENE_PX // SIZE_640
    csv = {"trn": [], "val": [], "tst": []}
    for i in range(per_side**2):
        split = "trn" if i < N_TRN_640 else "val" if i < N_TRN_640 + N_VAL_640 else "tst"
        r, c = divmod(i, per_side)
        window = (slice(SIZE_640 * r, SIZE_640 * (r + 1)), slice(SIZE_640 * c, SIZE_640 * (c + 1)))
        for kind, src, name in (("image", image, f"{i}.tif"), ("label", label, f"{i}_lbl.tif")):
            (root / split / kind).mkdir(parents=True, exist_ok=True)
            write_geotiff(root / split / kind / name, src[window])
        csv[split].append(f"{split}/image/{i}.tif;{split}/label/{i}_lbl.tif")
    for split, lines in csv.items():
        (root / f"{split}.csv").write_text("\n".join(lines) + "\n")
    print(f"  scene {scene.stat().st_size / 2**20:.1f} MiB on disk ({image.nbytes / 1e6:.1f} MB "
          f"decoded), {per_side**2} crops of {SIZE_640}^2: trn {len(csv['trn'])}, val "
          f"{len(csv['val'])}, tst {len(csv['tst'])}")
    return scene, root


def dofa640_phase(torch, smi: str, tmp: Path, patches: Path) -> tuple[dict, str]:
    """DOFA-base + UperNet at 640^2, whose 2026 tokens take K8/K9: a train
    step on two 576^2 crops (1682 tokens) card against CPU, ``fit`` for 2
    epochs over the 640^2 crops and ``test`` from its best checkpoint (in
    :func:`fit_phase`), then ``predict`` from it, exact launch counts
    throughout (no K4 or K7), and train steps on resident batches with the
    profiler. Returns the fit's launch counts and the best checkpoint."""
    from geo_deep_learning_tpu_torch.data.geotiff import read_geotiff
    from geo_deep_learning_tpu_torch.ops.cuda import _lib

    config = copy.deepcopy(CONFIG_640)
    config["data"]["init_args"].update(csv_root_folder=str(patches), patches_root_folder=str(patches))
    train_reference_check(torch, config, TRAIN_CHECK_640, PER_TRAIN_STEP_640, TRAIN_LIMITS_640)
    counts, config, best = fit_phase(torch, smi, tmp, DOFA640, patches, patches,
                                     (N_TRN_640, N_VAL_640, N_TST_640))
    torch.cuda.synchronize()
    _lib.reset_launches()
    result = run_checked(copy.deepcopy(config), "predict", ckpt_path=best)
    torch.cuda.synchronize()
    got = dict(_lib.LAUNCHES)
    files = sorted(Path(result["output_dir"]).glob("*_pred.tif"))
    print(f"  predict from {Path(best).name}: {result}; launches {got}")
    check(got == PER_BATCH_640, f"predict: launches {got}, expected {PER_BATCH_640}")
    check(result["num_predictions"] == N_TST_640 and len(files) == N_TST_640,
          f"expected {N_TST_640} rasters, found {len(files)}")
    raster, _ = read_geotiff(files[0])
    check(raster.shape == (SIZE_640, SIZE_640, 1) and raster.dtype.name == "uint8",
          "bad prediction raster")
    train_timing(torch, config, smi, tmp, DOFA640.label)
    return counts, best


def _scene_tiles(tile: int, overlap: int, band_tile_rows: int | None) -> tuple[int, int]:
    """(tiles, tile batches) of one pass over the scene: whole, or by bands
    of ``band_tile_rows`` tile rows."""
    from geo_deep_learning_tpu_torch.inference.sliding_window import _tile_origins

    n = len(_tile_origins(SCENE_PX, tile, tile - overlap))
    groups = [n] if band_tile_rows is None else [
        min(band_tile_rows, n - g) for g in range(0, n, band_tile_rows)]
    return n * n, sum(-(-g * n // BATCH) for g in groups)


def predict_scene_run(torch, smi: str, tmp: Path, path: ModelPath, scene: Path, tile: int,
                      overlap: int, blend: str, streamed: bool = False,
                      ckpt: str | None = None):
    """``run(config, "predict-scene", ...)`` over the scene, as the CLI's
    ``predict-scene`` calls it: exact launch counts per tile batch (the
    path's forward without K1: the scene is normalized in f32 torch ops), a
    5120^2 uint8 map with the scene's transform and EPSG code. Returns
    (class map, launch counts)."""
    from geo_deep_learning_tpu_torch.cli.main import SceneOptions
    from geo_deep_learning_tpu_torch.data.geotiff_stream import GeoTiffWindowReader
    from geo_deep_learning_tpu_torch.ops.cuda import _lib

    config = copy.deepcopy(path.config)
    config["trainer"]["default_root_dir"] = str(tmp / "scene_run")
    out = tmp / f"map_{tile}_{overlap}_{blend}{'_streamed' if streamed else ''}.tif"
    opts = SceneOptions(str(scene), str(out), tile, overlap, BATCH, blend, streamed)
    torch.cuda.synchronize()
    _lib.reset_launches()
    t0 = time.perf_counter()
    result = run_checked(config, "predict-scene", ckpt, opts)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    got = dict(_lib.LAUNCHES)
    n_tiles, n_batches = _scene_tiles(tile, overlap, 4 if streamed else None)
    print(f"  predict-scene {path.label}, tile {tile}, overlap {overlap}, {blend}"
          f"{', streamed' if streamed else ''}: {seconds:.2f} s a scene, {n_tiles / seconds:.2f} "
          f"tiles/s, {SCENE_GRID**2 / seconds:.2f} patches/s (the scene's 100 512^2 patches), "
          f"{n_batches} tile batches of {BATCH}; launches {got}; on {smi}")
    want = {k: v * n_batches for k, v in path.per_batch.items() if k != "preprocess"}
    check(result["streamed"] == streamed, f"predict-scene: streamed {result['streamed']}")
    check(got == want, f"predict-scene: launches {got}, expected {want}")
    with GeoTiffWindowReader(out) as reader:
        check((reader.height, reader.width, reader.channels, reader.dtype.name)
              == (SCENE_PX, SCENE_PX, 1, "uint8"), "predict-scene: bad map shape")
        t = reader.geo.transform
        check((t.a, t.b, t.c, t.d, t.e, t.f) == SCENE_TRANSFORM and reader.geo.epsg == SCENE_EPSG,
              f"predict-scene: the map's georeference {reader.geo} is not the scene's")
        classes = reader.read_rows(0, SCENE_PX)[..., 0]
    check(set(classes[::97, ::89].ravel().tolist()) <= {0, 1}, "predict-scene: classes not 0/1")
    return classes, got


def aligned_check(torch, path: ModelPath, scene: Path, map_aligned) -> None:
    """At tile 512, overlap 0, uniform blend the tiles are the tst patches:
    the blended logits (``sliding_window_logits`` with the CLI's
    ``tile_forward``, on the scene normalized in f32) against the eval
    forward of the same patches (K1 into bf16, the model under autocast),
    and the CLI's class map at those settings against the thresholded
    blended logits. The two differ by K1's bf16 normalization against the
    scene's f32 one. Limits, from the readings on an H100 80GB HBM3 (max
    |d prob| 6.1e-5 DOFA, 4.8e-4 SegFormer, 0 UNet++; agreement 1, 0.999933,
    1): max |d prob| 5e-3 and class agreement 0.9995; the CLI's map on
    0.9999 of the scene."""
    import numpy as np

    from geo_deep_learning_tpu_torch.cli.config import instantiate
    from geo_deep_learning_tpu_torch.cli.main import tile_forward
    from geo_deep_learning_tpu_torch.core.precision import PrecisionPolicy
    from geo_deep_learning_tpu_torch.data.geotiff import read_geotiff
    from geo_deep_learning_tpu_torch.inference.sliding_window import (
        SlidingWindowConfig,
        logits_to_classes,
        normalize,
        sliding_window_logits,
    )
    from geo_deep_learning_tpu_torch.training.steps import prepare_image, to_device

    config = data_config(path)
    spec = instantiate(config["model"])
    task = spec.task
    task.materialize(torch.device("cuda"), config["seed_everything"])
    policy = PrecisionPolicy.create("bf16-mixed")
    stats = config["data"]["init_args"]
    x = normalize(torch.from_numpy(read_geotiff(scene)[0]).cuda(), stats["mean"], stats["std"])
    blended = sliding_window_logits(tile_forward(task, policy), x, task.num_classes,
                                    SlidingWindowConfig(512, 0, BATCH, "uniform"))
    del x
    d_logit = d_prob = 0.0
    agree = n = 0
    i = 0
    with torch.inference_mode():
        for batch in instantiate(config["data"]).test_dataloader():
            if i == SCENE_GRID**2:
                break
            dev = to_device(batch, torch.device("cuda"))
            image = prepare_image(dev, policy).permute(0, 3, 1, 2)
            with policy.autocast(image.device):
                logits = task.forward(dev, image).out.float().permute(0, 2, 3, 1)
            for lg in logits[: int(batch.get("valid_count", len(logits)))]:
                if i == SCENE_GRID**2:
                    break
                r, c = divmod(i, SCENE_GRID)
                tile = blended[512 * r : 512 * (r + 1), 512 * c : 512 * (c + 1)]
                d_logit = max(d_logit, float((tile - lg).abs().max()))
                d_prob = max(d_prob, float((torch.sigmoid(tile) - torch.sigmoid(lg)).abs().max()))
                agree += int(((tile > 0) == (lg > 0)).sum())
                n += lg.numel()
                i += 1
    check(i == SCENE_GRID**2, f"compared {i} patches")
    cli_same = float(np.mean(
        map_aligned == logits_to_classes(blended, task.num_classes, task.threshold).cpu().numpy()))
    print(f"  {path.label}, tile 512 / overlap 0 / uniform vs the eval forward of the same "
          f"patches: max |d logit| {d_logit:.4g}, max |d prob| {d_prob:.4g}, class agreement "
          f"{agree / n:.6f}; the CLI's map equals the thresholded blended logits on "
          f"{cli_same:.6f} of the scene")
    check(d_prob <= 5e-3 and agree / n >= 0.9995, f"{path.label}: blended tiles disagree with "
          "the eval forward of the same patches")
    # the same code on the same inputs: only run-to-run differences of a
    # library kernel could move a pixel
    check(cli_same >= 0.9999, f"{path.label}: the CLI's map is not the thresholded blended logits")


def scene_phase(torch, smi: str, tmp: Path, scene: Path, best640: str) -> dict[str, int]:
    """``predict-scene`` over the scene: each family at the defaults (tile
    512, overlap 128, hann) and at tile 512 / overlap 0 / uniform (with
    :func:`aligned_check`), then DOFA-640 from its best checkpoint with
    640 tiles (K8 12 a tile batch, K4 none), whole and streamed, whose
    maps may differ on at most ``SCENE_STREAMED_DIFF`` of the pixels.
    Returns the DOFA-640 runs' launch counts."""
    import collections

    import numpy as np

    from geo_deep_learning_tpu_torch.data.geotiff import read_geotiff
    from geo_deep_learning_tpu_torch.data.geotiff_stream import GeoTiffStripWriter

    t0 = time.perf_counter()
    read_geotiff(scene)
    read_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with GeoTiffStripWriter(tmp / "io_probe.tif", SCENE_PX, 1, np.uint8) as w:
        w.write_rows((np.arange(SCENE_PX * SCENE_PX) % 7 < 3).astype(np.uint8).reshape(
            SCENE_PX, SCENE_PX))
    print(f"  scene I/O on the host: decoding the scene {read_s:.3f} s, writing a {SCENE_PX}^2 "
          f"uint8 map {time.perf_counter() - t0:.3f} s")
    for path in PATHS:
        predict_scene_run(torch, smi, tmp, path, scene, 512, 128, "hann")
        aligned, _ = predict_scene_run(torch, smi, tmp, path, scene, 512, 0, "uniform")
        aligned_check(torch, path, scene, aligned)
    whole, got = predict_scene_run(torch, smi, tmp, DOFA640, scene, SIZE_640, 128, "hann",
                                   ckpt=best640)
    streamed, got_streamed = predict_scene_run(torch, smi, tmp, DOFA640, scene, SIZE_640, 128,
                                               "hann", streamed=True, ckpt=best640)
    diff = int((whole != streamed).sum())
    print(f"  {DOFA640.label}: streamed and whole-scene maps differ on {diff} of {whole.size} "
          f"pixels (at most {SCENE_STREAMED_DIFF:g} of them); foreground share "
          f"{float(whole.mean()):.4f}")
    check(diff <= SCENE_STREAMED_DIFF * whole.size, "streamed map disagrees with the whole-scene map")
    streamed_logits_check(torch, scene, best640)
    return dict(collections.Counter(got) + collections.Counter(got_streamed))


def streamed_logits_check(torch, scene: Path, best640: str) -> None:
    """The f32 blended logits of DOFA-640 (its best checkpoint, 640 tiles,
    overlap 128, hann, the CLI's ``tile_forward``) from the band-streamed
    path (``streamed_scene_logits_writer``, 4 tile rows a band) against the
    whole-scene path (``sliding_window_logits``): the same tiles, blended
    with the same weights, the bands carrying the rows they share. They
    may differ by the order of the f32 sums in those rows (and could by a
    tile's bf16 logits moving with its batch's composition, which the
    readings do not show). Limit: ``SCENE_STREAMED_LOGITS`` on the largest
    |d logit|."""
    from geo_deep_learning_tpu_torch.cli.config import instantiate
    from geo_deep_learning_tpu_torch.cli.main import tile_forward
    from geo_deep_learning_tpu_torch.core.precision import PrecisionPolicy
    from geo_deep_learning_tpu_torch.data.geotiff import read_geotiff
    from geo_deep_learning_tpu_torch.data.geotiff_stream import GeoTiffWindowReader
    from geo_deep_learning_tpu_torch.inference.sliding_window import (
        SlidingWindowConfig,
        normalize,
        sliding_window_logits,
    )
    from geo_deep_learning_tpu_torch.inference.streaming import streamed_scene_logits_writer
    from geo_deep_learning_tpu_torch.training.checkpoint import CheckpointManager

    config = data_config(DOFA640)
    task = instantiate(config["model"]).task
    CheckpointManager.load_model(best640, task.materialize(torch.device("cuda"),
                                                           config["seed_everything"]))
    forward = tile_forward(task, PrecisionPolicy.create("bf16-mixed"))
    mean, std = (config["data"]["init_args"][k] for k in ("mean", "std"))
    cfg = SlidingWindowConfig(SIZE_640, 128, BATCH, "hann")
    x = normalize(torch.from_numpy(read_geotiff(scene)[0]).cuda(), mean, std)
    whole = sliding_window_logits(forward, x, task.num_classes, cfg)
    del x
    d_logit, rows = 0.0, 0

    def write(row0: int, logits) -> None:
        nonlocal d_logit, rows
        check(row0 == rows, f"streamed rows start at {row0}, expected {rows}")
        d_logit = max(d_logit, float((logits - whole[row0 : row0 + len(logits)]).abs().max()))
        rows += len(logits)

    with GeoTiffWindowReader(scene) as reader:
        streamed_scene_logits_writer(
            forward, reader, write, task.num_classes, cfg, band_tile_rows=4,
            preprocess=lambda block: normalize(torch.from_numpy(block).cuda(), mean, std))
    print(f"  {DOFA640.label}: streamed against whole-scene f32 blended logits over "
          f"{rows} rows: max |d logit| {d_logit:.4g} (limit {SCENE_STREAMED_LOGITS:g}; "
          f"logits up to {float(whole.abs().max()):.4g})")
    check(rows == SCENE_PX and d_logit <= SCENE_STREAMED_LOGITS,
          "streamed logits disagree with the whole-scene logits")


def _copies_of_size(prof, numel: int) -> list[str]:
    """The profiled copy ops whose input holds at least ``numel`` elements."""
    out = []
    for e in prof.events():
        if e.name in ("aten::copy_", "aten::clone", "aten::contiguous", "aten::_to_copy"):
            shapes = [s for s in e.input_shapes if s]
            if shapes and math.prod(shapes[0]) >= numel:
                out.append(f"{e.name} {shapes[0]}")
    return out


def factored_phase(torch, smi: str) -> None:
    """The factored resize + 3x3 conv (``ops/fused_upconv.py``) at the DOFA-base
    512^2 shapes of the neck's x4 / x2 branches and UperNet's fuse conv parts.
    Under bf16 autocast (as on the main path), forward and the gradients of
    input, weight and bias against the plain resize + conv of the same
    weights in f32 on the card, within ``FACTORED_REL_ERR`` of each
    reference's largest magnitude; the device time of forward + backward of
    the factored branch and of the plain composition under the same
    autocast, and the peak memory of each; and, in the profiler, no copy of
    a tensor of the output's size in the factored forward (its backward's
    are printed)."""
    from torch.profiler import ProfilerActivity, profile

    from geo_deep_learning_tpu_torch.ops import fused_upconv as FU

    gen = torch.Generator(device="cuda").manual_seed(3)
    for label, shape, cout, size in FACTORED_CASES:
        cin = shape[1]
        x = torch.randn(shape, generator=gen, device="cuda").to(memory_format=torch.channels_last)
        w = torch.randn((cout, cin, 3, 3), generator=gen, device="cuda") / (9 * cin) ** 0.5
        b = 0.1 * torch.randn(cout, generator=gen, device="cuda")
        # the gradient arrives channels-last, as from the BatchNorm after it
        g = torch.randn((shape[0], cout, *size), generator=gen, device="cuda").to(
            memory_format=torch.channels_last)
        x16, g16 = x.bfloat16(), g.bfloat16()

        def fwd_bwd(fn, autocast: bool, xin, grad):
            xi, wi, bi = (t.detach().requires_grad_() for t in (xin, w, b))
            with torch.autocast("cuda", torch.bfloat16, enabled=autocast):
                y = fn(xi, wi, bi, size)
            y.backward(grad.to(y.dtype))
            return y.detach(), xi.grad, wi.grad, bi.grad

        got = fwd_bwd(FU.resize_conv3x3_factored, True, x16, g16)
        want = fwd_bwd(FU.reference, False, x16.float(), g16.float())
        errs = [float((a.float() - r).abs().max() / r.abs().max()) for a, r in zip(got, want)]
        times, peaks = {}, {}
        for name, fn in (("factored", FU.resize_conv3x3_factored), ("plain", FU.reference)):
            times[name] = time_ms(torch, lambda fn=fn: fwd_bwd(fn, True, x16, g16), 5)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            fwd_bwd(fn, True, x16, g16)
            torch.cuda.synchronize()
            peaks[name] = (torch.cuda.max_memory_allocated() - base) / 2**30
        with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as fwd:
            with torch.autocast("cuda", torch.bfloat16):
                y = FU.resize_conv3x3_factored(x16.detach().requires_grad_(), w, b, size)
        with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as bwd:
            y.backward(g16)
        torch.cuda.synchronize()
        big_fwd, big_bwd = _copies_of_size(fwd, y.numel()), _copies_of_size(bwd, y.numel())
        print(f"  {label} {list(shape)} -> {list(size)}, {cout} out: factored bf16 vs plain f32, "
              f"relative max err y {errs[0]:.3g}, dx {errs[1]:.3g}, dw {errs[2]:.3g}, db "
              f"{errs[3]:.3g} (limit {FACTORED_REL_ERR:g})")
        print(f"  {label}: fwd+bwd factored {times['factored']:.3f} ms, plain resize + conv "
              f"{times['plain']:.3f} ms (bf16 autocast); peak memory above the inputs "
              f"{peaks['factored']:.3f} / {peaks['plain']:.3f} GiB; on {smi}")
        print(f"  {label}: output-sized copies, forward {big_fwd}, backward {big_bwd}")
        check(all(math.isfinite(e) and e <= FACTORED_REL_ERR for e in errs),
              f"{label}: the factored form disagrees with the plain composition")
        check(not big_fwd, f"{label}: the factored forward copies an output-sized tensor")


def losses_phase(torch) -> None:
    """Each configured loss on the card (f32 logits ``[8, C, 256, 256]``,
    binary and 5-class, with and without ``sample_weights`` masking the
    last two samples; a stripe of ignore_index 255 where the loss takes
    one): value and logit gradient against the same call on CPU copies in
    f64, within ``LOSS_REL_ERR`` of the reference's value and of its
    largest gradient."""
    from geo_deep_learning_tpu_torch.ops import losses

    gen = torch.Generator(device="cuda").manual_seed(4)
    for name, kwargs, c in LOSS_CASES:
        logits = 2 * torch.randn((BATCH, c, LOSS_SIZE, LOSS_SIZE), generator=gen, device="cuda")
        targets = torch.randint(0, 2 if c == 1 else c, (BATCH, LOSS_SIZE, LOSS_SIZE),
                                generator=gen, device="cuda")
        if "ignore_index" in kwargs:
            targets[:, :16] = kwargs["ignore_index"]
        loss = getattr(losses, name)(**kwargs)
        for weights in (None, [1.0] * (BATCH - 2) + [0.0, 0.0]):
            outs = []
            for device, dtype in (("cuda", torch.float32), ("cpu", torch.float64)):
                x = logits.to(device, dtype, copy=True).requires_grad_()
                sw = None if weights is None else torch.tensor(weights, device=device)
                value = loss(x, targets.to(device), sw)
                value.backward()
                outs.append((value.detach().cpu().double(), x.grad.cpu().double()))
            (v, gv), (r, gr) = outs
            d_value = float((v - r).abs() / r.abs())
            d_grad = float((gv - gr).abs().max() / gr.abs().max())
            print(f"  {name}({kwargs}), {'weighted' if weights else 'unweighted'}: value "
                  f"{float(v):.7f} vs f64 {float(r):.7f}, relative {d_value:.2e}; gradient "
                  f"{d_grad:.2e} (limit {LOSS_REL_ERR:g})")
            check(d_value <= LOSS_REL_ERR and d_grad <= LOSS_REL_ERR,
                  f"{name}: the card disagrees with f64")


def write_dofa_artifact(path: Path, seed: int = 11) -> None:
    """A synthetic HF-layout DOFA-base artifact from a seeded encoder at
    196^2 (a 14^2 position grid, as 224^2 pretraining at patch 16 gives):
    ``model.``-prefixed blocks, norm, cls_token and pos_embed, plus
    pretraining keys (``model.head``, ``model.mask_token``) that the loader
    must drop; the wavelength-conditioned patch embedding unprefixed."""
    import torch

    from geo_deep_learning_tpu_torch.models.encoders.dofa import DOFAv2

    encoder = DOFAv2("dofa_base", img_size=196)
    encoder.init_weights(torch.Generator().manual_seed(seed))
    state = encoder.state_dict()
    with torch.no_grad():
        state["pos_embed"].add_(0.02 * torch.randn(state["pos_embed"].shape,
                                                   generator=torch.Generator().manual_seed(seed)))
    file = {}
    for key, value in state.items():
        hf = key.startswith(("blocks.", "norm.")) or key in ("cls_token", "pos_embed")
        file[f"model.{key}" if hf else key] = value
    file["model.head.weight"] = torch.zeros(1000, encoder.embed_dim)
    file["model.mask_token"] = torch.zeros(1, 1, encoder.embed_dim)
    torch.save({"model": file}, path)


def recipe_phase(torch, smi: str, tmp: Path) -> dict[str, int]:
    """The reference DOFA recipe's shape at full width: the encoder from a
    ``torch_weights`` artifact (HF layout, 14^2 grid resized to 36^2) and
    ``freeze_layers: ["encoder"]``, ``fit`` for 2 epochs (exact launches: the
    forward's per train step, no K5-K7) and ``test`` from its best checkpoint
    (in :func:`fit_phase`); the encoder after the fit equal to the converted
    artifact; then ``test`` with ``weights_from_checkpoint_path`` at the best
    checkpoint equal to ``test --ckpt-path`` on it. Returns the fit's counts."""
    from geo_deep_learning_tpu_torch.models import convert

    artifact = tmp / "dofa_base_hf.pth"
    t0 = time.perf_counter()
    write_dofa_artifact(artifact)
    print(f"  artifact {artifact.stat().st_size / 2**20:.1f} MiB written in "
          f"{time.perf_counter() - t0:.2f} s")
    config = data_config(DOFA)
    config["model"]["init_args"].update(
        freeze_layers=["encoder"], torch_weights={"path": str(artifact), "format": "dofa"})
    path = ModelPath(RECIPE, config, PER_BATCH, PER_BATCH, 128, None)
    counts, config, best = fit_phase(torch, smi, tmp, path, write_fit_csvs(tmp), DATA)
    saved = torch.load(best, map_location="cpu", weights_only=True)["model"]
    converted = convert.load_pretrained_tree(artifact, "dofa")
    table = convert.resize_pos_embed(converted.pop("pos_embed").numpy(), 36 * 36)
    same = [torch.equal(saved[f"encoder.{k}"], v) for k, v in converted.items()]
    same.append(torch.equal(saved["encoder.pos_embed"], torch.from_numpy(table)))
    print(f"  encoder after the frozen fit: {sum(same)} of {len(same)} tensors equal to the "
          f"converted artifact (pos_embed resized 14^2 -> 36^2)")
    check(all(same), "the frozen encoder moved or was not loaded from the artifact")
    restored = run_checked(copy.deepcopy(config), "test", ckpt_path=best)
    config["model"]["init_args"]["weights_from_checkpoint_path"] = best
    warm = run_checked(copy.deepcopy(config), "test")
    print(f"  test with weights_from_checkpoint_path {Path(best).name}: {warm}")
    check(warm == restored, "the warm-started test differs from test --ckpt-path")
    return counts


# -- this slice: the in-repo DOFA recipes on the multi-sensor shard stream,
# the round-robin CSV stream, 32-true on the card, and remat

# configs/dofa_config_RGB.yaml as a dict (the machine with the card has no
# YAML parser; tests/test_torch_streaming.py holds this dict, with
# recipe_config's overrides, equal to the port's load_config of the file)
RECIPE_RGB = {
    "seed_everything": 42,
    "trainer": {
        "max_epochs": 10,
        "precision": "bf16-mixed",
        "gradient_clip_val": 1.0,
        "default_root_dir": "runs/dofa_rgb",
        "logger": {"class_path": "geo_deep_learning_tpu.tools.tracking.FileTracker",
                   "init_args": {"save_dir": "runs/dofa_rgb", "run_name": "dofa_base_upernet",
                                 "experiment_name": "gdl_tpu_experiment"}},
        "callbacks": [
            {"class_path": "lightning.pytorch.callbacks.EarlyStopping",
             "init_args": {"monitor": "val_loss", "mode": "min", "patience": 20}},
            {"class_path": "lightning.pytorch.callbacks.ModelCheckpoint",
             "init_args": {"monitor": "val_loss", "mode": "min", "save_top_k": 1,
                           "filename": "model-{epoch:02d}-{val_loss:.3f}"}},
            {"class_path": "tools.callbacks.segmentation_visualization.VisualizationCallback",
             "init_args": {"max_samples": 3}},
        ],
    },
    "model": {
        "class_path": "geo_deep_learning_tpu.tasks.SegmentationDOFA",
        "init_args": {
            "encoder": "dofa_base",
            "pretrained": True,
            "image_size": [512, 512],
            "max_samples": 6,
            "num_classes": 5,
            "freeze_layers": ["encoder"],
            "loss": {"class_path": "segmentation_models_pytorch.losses.DiceLoss",
                     "init_args": {"mode": "multiclass"}},
            # YAML 1.1 reads 6e-5 (no point) as a string; the trainer takes float()
            "optimizer": {"class_path": "torch.optim.Adam", "init_args": {"lr": "6e-5"}},
            "scheduler": {"class_path": "torch.optim.lr_scheduler.ReduceLROnPlateau",
                          "init_args": {"mode": "min", "factor": 0.1, "patience": 10,
                                        "cooldown": 1, "min_lr": "6e-8"}},
            "scheduler_config": {"interval": "epoch", "frequency": 1, "monitor": "val_loss"},
            "class_labels": ["background", "fore", "hydro", "roads", "buildings"],
            "class_colors": ["#000000", "#008000", "#0000FF", "#FFFF00", "#FF0000"],
            "weights_from_checkpoint_path": None,
        },
    },
    "data": {
        "class_path": "geo_deep_learning_tpu.data.multisensor.MultiSensorDataModule",
        "init_args": {"sensor_configs_path": "data/sensors.yaml", "model_type": "dofa",
                      "batch_size": 8, "num_workers": 8, "epoch_size": 4096},
    },
    "ckpt_path": None,
}
# configs/dofa_config_RGB_onecycle.yaml: the same recipe with OneCycleLR
RECIPE_ONECYCLE = copy.deepcopy(RECIPE_RGB)
RECIPE_ONECYCLE["trainer"]["default_root_dir"] = "runs/dofa_rgb_onecycle"
RECIPE_ONECYCLE["trainer"]["logger"]["init_args"].update(
    save_dir="runs/dofa_rgb_onecycle", run_name="dofa_base_upernet_onecycle")
RECIPE_ONECYCLE["model"]["init_args"].update(
    scheduler={"class_path": "torch.optim.lr_scheduler.OneCycleLR",
               "init_args": {"max_lr": "6e-4"}},
    scheduler_config={"interval": "step", "frequency": 1})
MULTI = "DOFA recipe on the multi-sensor shard stream"
MULTI_CSV = "DOFA on the round-robin CSV stream"
F32 = "DOFA 32-true"
# the shards: two sensors from tst rows 0-79 (trn) and 80-99 (val, tst), 16
# patches a shard; rgbn's fourth band repeats band 0 as a synthetic NIR
MS_SENSORS = (("rgb", [0, 1, 2], [0.665, 0.549, 0.481]),
              ("rgbn", [0, 1, 2, 0], [0.665, 0.549, 0.481, 0.842]))
MS_EPOCH_SIZE = 64  # 8 train steps an epoch
MS_PER_SHARD = 16
# the shard stream normalizes on the host (as the JAX package does): no K1
MS_PER_BATCH = {k: v for k, v in PER_BATCH.items() if k != "preprocess"}
MS_PER_TRAIN_STEP = {k: v for k, v in PER_TRAIN_STEP.items() if k != "preprocess"}
# the round-robin CSV sensors over data/waterloo's tst patches: RGB and a
# 4-band view (band 0 again), each with its own statistics and wavelengths
CSV_SENSORS = {
    "rgb": {"band_indices": [0, 1, 2], "mean": [0.405, 0.432, 0.397],
            "std": [0.165, 0.161, 0.174], "wavelengths": [0.665, 0.549, 0.481]},
    "rgbn": {"band_indices": [0, 1, 2, 0], "mean": [0.405, 0.432, 0.397, 0.405],
             "std": [0.165, 0.161, 0.174, 0.165], "wavelengths": [0.665, 0.549, 0.481, 0.842]},
}
# 32-true: the f32 attention instances in place of K4/K7 (512^2) and K8/K9
F32_PER_BATCH = {"preprocess": 1, "layernorm_fwd": 4, "layernorm_residual_fwd": 20,
                 "attention_fwd_f32": 12}
F32_PER_TRAIN_STEP = {**F32_PER_BATCH, "layernorm_bwd": 4, "layernorm_residual_bwd": 20,
                      "attention_bwd_f32": 12}
F32_PER_TRAIN_STEP_640 = {"preprocess": 1, "layernorm_fwd": 4, "layernorm_residual_fwd": 20,
                          "attention_fwd_hm_f32": 12, "layernorm_bwd": 4,
                          "layernorm_residual_bwd": 20, "attention_bwd_hm_f32": 12}
F32_FIT_TRN = 80  # one epoch: 10 steps; val and tst rows 80-99, 3 batches each
# the card's f32 step against the CPU's (plain versions), per part of the
# model: loss relative, 1 - cosine, norm ratio off 1
F32_LIMITS = (1e-5, 1e-5, 1e-4)
F32_ATTN_REL = 1e-5  # f32 kernels against their plain versions, of each output's largest
REMAT_MODES = (None, "mlp", "block")
REMAT_STEPS = 5  # timed steps a turn


def recipe_config(onecycle: bool, registry: Path, root: Path) -> dict:
    """The recipe's dict with the run's overrides: the registry written
    here, ``epoch_size`` 64, 2 epochs, a temporary root (the checkpoints'
    and the logger node's), and the encoder training (``freeze_layers:
    []``: random weights, so K5-K7 run; the recipe's frozen shape is what
    the DOFA recipe phase runs)."""
    config = copy.deepcopy(RECIPE_ONECYCLE if onecycle else RECIPE_RGB)
    config["data"]["init_args"].update(sensor_configs_path=str(registry),
                                       epoch_size=MS_EPOCH_SIZE)
    config["trainer"].update(max_epochs=FIT_EPOCHS, default_root_dir=str(root))
    config["trainer"]["logger"]["init_args"]["save_dir"] = str(root)
    config["model"]["init_args"]["freeze_layers"] = []
    return config


class BatchLog:
    """The host batches a run hands to the card (``loop.to_device``
    wrapped): sensor, channels, batch size and ``valid_count`` of each."""

    def __init__(self) -> None:
        self.batches: list[tuple] = []

    def __enter__(self):
        from geo_deep_learning_tpu_torch.training import loop

        self.loop, self.real = loop, loop.to_device

        def logged(batch, device):
            self.batches.append((tuple(sorted(set(batch.get("platform", ["?"])))),
                                 batch["image"].shape[-1], len(batch["image"]),
                                 int(batch.get("valid_count", len(batch["image"])))))
            return self.real(batch, device)

        loop.to_device = logged
        return self

    def __exit__(self, *exc):
        self.loop.to_device = self.real


def counted_run(torch, config: dict, sub: str, **kwargs) -> tuple[dict, dict, list, float]:
    """``run_checked`` with the launches and host batches it made, and its
    wall seconds."""
    from geo_deep_learning_tpu_torch.ops.cuda import _lib

    torch.cuda.synchronize()
    _lib.reset_launches()
    t0 = time.perf_counter()
    with BatchLog() as log:
        result = run_checked(copy.deepcopy(config), sub, **kwargs)
    torch.cuda.synchronize()
    return result, dict(_lib.LAUNCHES), log.batches, time.perf_counter() - t0


def expect_launches(what: str, counts: dict, per_step: dict, per_batch: dict, n_train: int,
                    n_eval: int) -> None:
    want = {k: per_step.get(k, 0) * n_train + per_batch.get(k, 0) * n_eval
            for k in {*per_step, *per_batch}}
    want = {k: v for k, v in want.items() if v}
    print(f"  {what}: {n_train} train steps, {n_eval} evaluated batches; launches {counts}")
    check(counts == want, f"{what}: launches {counts}, expected {want}")


def to_card(torch, batch: dict) -> dict:
    from geo_deep_learning_tpu_torch.training.steps import to_device

    return to_device(batch, torch.device("cuda"))


def resident_step_ms(torch, spec, batches, precision: str, n: int = 6) -> tuple[float, float]:
    """ms a train step on batches already on the card, and peak GiB."""
    from geo_deep_learning_tpu_torch.core.precision import PrecisionPolicy
    from geo_deep_learning_tpu_torch.core.train_state import TrainState
    from geo_deep_learning_tpu_torch.training import optim
    from geo_deep_learning_tpu_torch.training.steps import make_train_step

    model = spec.task.materialize(torch.device("cuda"), 42)
    state = TrainState.create(model, optim.build_optimizer(model.parameters(), "adam", 6e-5), 0)
    policy = PrecisionPolicy.create(precision)
    step = make_train_step(spec.task, policy)
    with policy.scope():
        for b in batches[:2]:
            step(state, b)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for i in range(n):
            step(state, batches[i % len(batches)])
        torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / n, torch.cuda.max_memory_allocated() / 2**30


def tar_reader_check(smi: str, shards: list[Path]) -> None:
    """The native tar reader yields exactly ``tarfile``'s file members on
    every shard; host ms of each reader a bs-8 batch's members (warm page
    cache, one thread)."""
    import tarfile

    from geo_deep_learning_tpu_torch.data import _native

    times = {"native": 0.0, "tarfile": 0.0}
    members = 0
    for path in shards:
        t0 = time.perf_counter()
        native = list(_native.iter_tar_members_native(path))
        t1 = time.perf_counter()
        with tarfile.open(path, "r|*") as tar:
            plain = [(m.name, tar.extractfile(m).read()) for m in tar if m.isfile()]
        t2 = time.perf_counter()
        times["native"] += t1 - t0
        times["tarfile"] += t2 - t1
        members += len(plain)
        check(native == plain, f"the native tar reader differs from tarfile on {path.name}")
    batches = members / 3 / BATCH  # three members a sample
    print(f"  tar: {len(shards)} shards, {members} members, native = tarfile exactly; ms a "
          f"bs-{BATCH} batch's members: native {1e3 * times['native'] / batches:.2f}, tarfile "
          f"{1e3 * times['tarfile'] / batches:.2f} (one thread, warm page cache); on {smi}")


def multisensor_phase(torch, smi: str, tmp: Path) -> dict[str, int]:
    """``tools/make_shards.py`` writes two sensors (RGB, and RGB + band 0
    as a synthetic NIR) from tst rows 0-79 / 80-99 / 80-99, 16 patches a
    shard, with a JSON registry; then the recipe's dict (the registry,
    ``epoch_size`` 64, 2 epochs, the encoder training) through ``run()``:
    ``fit`` and ``test`` from its best checkpoint, both sensors in the
    batches, each batch single-sensor with 3 or 4 channels, exact K2-K7
    launches and no K1 (the stream normalizes on the host), ``valid_count``
    summing to the split; then one epoch of the OneCycle recipe, whose step
    count comes from ``epoch_size``. Returns the fit's launch counts."""
    from geo_deep_learning_tpu_torch.cli.config import instantiate
    from geo_deep_learning_tpu_torch.data import _native
    from geo_deep_learning_tpu_torch.data.shard_dataset import iter_tar_samples
    from geo_deep_learning_tpu_torch.tools.make_shards import make_shards

    csv_dir = write_split_csvs(tmp, range(N_TRN), range(N_TRN, N_TST), range(N_TRN, N_TST))
    t0 = time.perf_counter()
    registry = tmp / "shards" / "sensors.json"
    for sensor, bands, waves in MS_SENSORS:
        make_shards(csv_dir, tmp / "shards", sensor, MS_PER_SHARD, waves, bands, DATA, registry)
    size = sum(f.stat().st_size for f in (tmp / "shards").rglob("*.tar"))
    print(f"  shards: {len(MS_SENSORS)} sensors, {size / 2**20:.1f} MiB of tar in "
          f"{time.perf_counter() - t0:.2f} s; registry {registry.name} (JSON)")
    tar_reader_check(smi, sorted((tmp / "shards").rglob("*.tar")))

    config = recipe_config(False, registry, tmp / "fit")
    data = instantiate(config["data"])
    data.setup("fit")
    ds = next(iter(data.datasets.values()))["trn"]
    t0 = time.perf_counter()
    n = sum(1 for raw in iter_tar_samples(ds.shard_paths[0]) if ds.process_sample(raw))
    decode_ms = 1e3 * (time.perf_counter() - t0) / n * BATCH
    print(f"  host decode (tar + npy + normalize, one thread, tar: "
          f"{_native.DECODERS.get('tar')}): {decode_ms:.2f} ms a bs-{BATCH} batch; on {smi}")

    n_train = FIT_EPOCHS * MS_EPOCH_SIZE // BATCH
    n_split = len(MS_SENSORS) * -(-(N_TST - N_TRN) // BATCH)  # padded per sensor
    result, counts, batches, seconds = counted_run(torch, config, "fit")
    print(f"  fit: {seconds:.2f} s; last epoch {result['patches_per_sec']:.2f} train patches/s "
          f"(bs {BATCH}, 512^2, shard stream, tar: {_native.DECODERS.get('tar')}, "
          f"bf16-mixed) on {smi}")
    print(f"  fit: {result}")
    expect_launches("fit", counts, MS_PER_TRAIN_STEP, MS_PER_BATCH, n_train,
                    FIT_EPOCHS * n_split + n_split)
    sensors = {b[0] for b in batches}
    print(f"  batches: {len(batches)}; sensors {sorted(sensors)}, channels "
          f"{sorted({b[1] for b in batches})}")
    check(all(len(b[0]) == 1 and b[1] in (3, 4) and b[2] == BATCH for b in batches),
          "a batch mixes sensors or has another shape")
    check(sensors == {(s,) for s, _, _ in MS_SENSORS}, "a sensor's batches are missing")
    check(all(math.isfinite(v) for v in result.values()), "non-finite fit metric")
    best = json.loads((tmp / "fit" / "checkpoints" / "index.json").read_text())["best_path"]
    tested, tcounts, tbatches, _ = counted_run(torch, config, "test", ckpt_path=best)
    valid = sum(b[3] for b in tbatches)
    print(f"  test from {Path(best).name}: {tested}; {len(tbatches)} batches, valid_count sum "
          f"{valid}")
    expect_launches("test", tcounts, {}, MS_PER_BATCH, 0, n_split)
    check(valid == len(MS_SENSORS) * (N_TST - N_TRN) and len(tbatches) * BATCH > valid,
          "test did not honour valid_count")
    auto = {k: v for k, v in result.items() if k.startswith("test_")}
    diff = max(abs(tested[k] - auto[k]) for k in auto)
    check(set(tested) == set(auto) and diff <= 1e-4, "restored test disagrees with the auto-test")

    spec = instantiate(config["model"])
    loader = data.train_dataloader()
    resident = [to_card(torch, b) for b, _ in zip(loader, range(3))]
    ms, peak = resident_step_ms(torch, spec, resident, "bf16-mixed")
    print(f"  train steps on resident shard batches: {ms:.2f} ms a bs-{BATCH} step, peak "
          f"{peak:.2f} GiB; on {smi}")

    onecycle = recipe_config(True, registry, tmp / "onecycle")
    onecycle["trainer"]["max_epochs"] = 1
    result1, counts1, _, seconds1 = counted_run(torch, onecycle, "fit")
    steps = MS_EPOCH_SIZE // BATCH
    final = 6e-4 / 25.0 / 1e4  # OneCycle's last LR: max_lr / div_factor / final_div_factor
    print(f"  OneCycle recipe, 1 epoch: {seconds1:.2f} s, lr after {steps} steps "
          f"{result1['lr']:.3g} (the schedule's end, {final:.3g}, iff it spans epoch_size / "
          f"batch_size steps)")
    expect_launches("OneCycle fit", counts1, MS_PER_TRAIN_STEP, MS_PER_BATCH, steps, 2 * n_split)
    check(abs(result1["lr"] - final) <= 1e-6 * final, "OneCycle did not span the epoch_size steps")
    return counts


def multisensor_csv_phase(torch, smi: str, tmp: Path) -> dict[str, int]:
    """``MultiSensorCSVDataModule`` over the tst CSV (trn rows 0-79, val and
    tst 80-99) as an RGB and a 4-band sensor with their own band indices,
    statistics and wavelengths, ``device_preprocess: true``: one epoch of
    DOFA-base 512^2 ``fit`` with K1 once a batch on ``[B, C]`` statistics,
    and K1 against its plain version on one batch of each sensor. Returns
    the fit's launch counts."""
    from geo_deep_learning_tpu_torch.cli.config import instantiate
    from geo_deep_learning_tpu_torch.ops.cuda import preprocess as PP

    csv_dir = write_split_csvs(tmp, range(N_TRN), range(N_TRN, N_TST), range(N_TRN, N_TST))
    sensors = {name: {**cfg, "csv_root_folder": str(csv_dir), "patches_root_folder": str(DATA)}
               for name, cfg in CSV_SENSORS.items()}
    config = copy.deepcopy(CONFIG)
    config["trainer"].update(default_root_dir=str(tmp / "fit"), max_epochs=1)
    config["data"] = {
        "class_path": "geo_deep_learning_tpu.data.multisensor_csv.MultiSensorCSVDataModule",
        "init_args": {"sensors": sensors, "batch_size": BATCH, "num_workers": 8,
                      "device_preprocess": True},
    }
    data = instantiate(config["data"])
    data.setup("fit")
    seen = {}
    for batch in data.train_dataloader():
        sensor = batch["platform"][0]
        if sensor not in seen:
            seen[sensor] = batch
        if len(seen) == len(sensors):
            break
    for sensor, batch in seen.items():
        card = to_card(torch, batch)
        c = len(sensors[sensor]["band_indices"])
        check(card["image"].dtype == torch.uint8 and tuple(card["mean"].shape) == (BATCH, c),
              f"{sensor}: expected uint8 images and [B, C] statistics")
        got = PP.fused_normalize_standardize(card["image"], card["mean"], card["std"],
                                             torch.bfloat16)
        m, inv = PP._stats(card["mean"], card["std"], card["image"])
        want = PP.normalize_reference(card["image"], m, inv, torch.bfloat16)
        err = max_err(got, want)
        print(f"  {sensor}: K1 on [{BATCH},512,512,{c}] with [B, C] statistics against its plain "
              f"version: max_abs_err {err:.3g}")
        check(err <= 1.6e-2, f"{sensor}: K1 disagrees with its plain version")
    n_train = len(CSV_SENSORS) * N_TRN // BATCH
    n_split = len(CSV_SENSORS) * -(-(N_TST - N_TRN) // BATCH)
    result, counts, batches, seconds = counted_run(torch, config, "fit")
    print(f"  fit, 1 epoch: {seconds:.2f} s; {result['patches_per_sec']:.2f} train patches/s "
          f"(bs {BATCH}, 512^2, round-robin CSV, bf16-mixed) on {smi}")
    print(f"  fit: {result}")
    expect_launches("fit", counts, PER_TRAIN_STEP, PER_BATCH, n_train, 2 * n_split)
    check({b[0] for b in batches} == {(s,) for s in CSV_SENSORS}
          and all(len(b[0]) == 1 for b in batches), "round-robin batches mix or miss sensors")
    check(all(math.isfinite(v) for v in result.values()), "non-finite fit metric")
    return counts


def kernel_split(torch, fn, what: str, n: int = 10) -> None:
    """Device ms a call of each kernel ``fn`` launches (the profiler over
    ``n`` calls, each after the 64 MB L2 flush of ``time_ms``): the f32
    backward's delta pass, dK/dV and dQ kernels."""
    import re

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    us: dict[str, float] = {}
    for e in prof.events():
        m = re.search(r"(attention_\w+_kernel)", e.name)
        if e.device_type == DeviceType.CUDA and m:
            us[m.group(1)] = us.get(m.group(1), 0.0) + e.time_range.elapsed_us()
    check(len(us) == 3, f"{what}: expected three kernels a call, got {sorted(us)}")
    print(f"  {what} by kernel (profiler, L2 flushed): " + ", ".join(
        f"{k} {v / n / 1e3:.4f} ms" for k, v in us.items()))


def f32_attention_records(torch, randn, compare) -> dict[str, dict]:
    """The f32 instances against their plain f32 versions: the packed pair
    at DOFA-base 512^2 (``[8,1297,2304]``, 12 heads) and the head-major pair
    at 640^2 (``[8,12,2026,64]``), plus ragged cases at head dims 32 and 128:
    o, dq, dk, dv within ``F32_ATTN_REL`` of each one's largest |value|, lse
    1e-5, equal over two calls; the backward's time split over its three
    kernels (``kernel_split``). The full shapes' records: ``ms``, the plain
    version's, SDPA's on f32 inputs (forward; its backward) and the bound
    of the card's fastest route at f32 accuracy: the function's products
    as three TF32 passes at the tensor cores' TF32 rate, the softmax's
    5 operations a score on the f32 pipe."""
    import torch.nn.functional as F

    from geo_deep_learning_tpu_torch.core.precision import PrecisionPolicy
    from geo_deep_learning_tpu_torch.ops.cuda import mha as MHA

    def rel(name, got, want):
        top = float(want.abs().max())
        return compare(name, got, want, F32_ATTN_REL * top)

    records = {}
    with PrecisionPolicy.create("32-true").scope():
        for i, (b, l, h, hd) in enumerate(((BATCH, 1297, 12, 64), (2, 197, 4, 32),
                                           (1, 300, 2, 128))):
            qkv, g = randn((b, l, 3 * h * hd), torch.float32), randn((b, l, h * hd), torch.float32)
            scale = 1.0 / math.sqrt(hd)
            o, lse = MHA.attention_packed(qkv, h, scale)
            wo, wlse = MHA.attention_reference(qkv, h, scale)
            tag = f"[{b},{l},{3 * h * hd}] H={h} f32"
            err4 = max(rel(f"attention_fwd_f32 {tag} o", o, wo),
                       compare(f"attention_fwd_f32 {tag} lse", lse, wlse, 1e-5))
            got = MHA.attention_bwd_packed(qkv, o, g, lse, h, scale)
            want = MHA.attention_bwd_reference(qkv, o, g, lse, h, scale)
            err7 = max(rel(f"attention_bwd_f32 {tag} {n}", a, w) for n, a, w in
                       zip(("dq", "dk", "dv"), got.chunk(3, dim=-1), want.chunk(3, dim=-1)))
            check(all(torch.equal(x, y) for x, y in zip(
                (o, lse, got), (*MHA.attention_packed(qkv, h, scale),
                                MHA.attention_bwd_packed(qkv, o, g, lse, h, scale)))),
                  "the f32 packed pair is not deterministic")
            if i:  # the record is the main path's shape
                continue
            q, k, v = (t.unflatten(-1, (h, hd)).transpose(1, 2) for t in qkv.chunk(3, dim=-1))
            ql, kl, vl = (t.detach().clone().requires_grad_() for t in (q, k, v))
            lib_out = F.scaled_dot_product_attention(ql, kl, vl)
            lib_g = g.unflatten(-1, (h, hd)).transpose(1, 2)
            n, rows = b * l * h * hd, b * h * l
            records["attention_fwd_f32"] = {
                "max_abs_err": err4,
                "ms": time_ms(torch, lambda: MHA.attention_packed(qkv, h, scale), 10),
                "plain_ms": time_ms(torch, lambda: MHA.attention_reference(qkv, h, scale), 3),
                "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(q, k, v), 10),
                "bytes": 4 * n * 4 + rows * 4,
                "tensor_flops": 0.0,
                "tf32_flops": 3 * 4.0 * rows * l * hd,
                "f32_flops": 5.0 * rows * l,
            }
            records["attention_bwd_f32"] = {
                "max_abs_err": err7,
                "ms": time_ms(
                    torch, lambda: MHA.attention_bwd_packed(qkv, o, g, lse, h, scale), 10),
                "plain_ms": time_ms(
                    torch, lambda: MHA.attention_bwd_reference(qkv, o, g, lse, h, scale), 3),
                "library_ms": time_ms(torch, lambda: torch.autograd.grad(
                    lib_out, (ql, kl, vl), lib_g, retain_graph=True), 10),
                "bytes": 8 * n * 4 + rows * 4,
                "tensor_flops": 0.0,
                "tf32_flops": 3 * 10.0 * rows * l * hd,
                "f32_flops": 5.0 * rows * l,
            }
            kernel_split(torch, lambda: MHA.attention_bwd_packed(qkv, o, g, lse, h, scale),
                         f"attention_bwd_f32 {tag}")
        for i, (b, h, l, hd) in enumerate(((BATCH, 12, 2026, 64), (2, 4, 1601, 32),
                                           (1, 2, 2026, 128))):
            qkv, g = randn((b, l, 3 * h * hd), torch.float32), randn((b, l, h * hd), torch.float32)
            scale = 1.0 / math.sqrt(hd)
            tag = f"[{b},{h},{l},{hd}] f32"
            o, lse = MHA.attention_hm(qkv, h, scale)
            wo, wlse = MHA.attention_reference(qkv, h, scale)
            err8 = max(rel(f"attention_fwd_hm_f32 {tag} o", o, wo),
                       compare(f"attention_fwd_hm_f32 {tag} lse", lse, wlse, 1e-5))
            got = MHA.attention_hm_bwd(qkv, o, g, lse, h, scale)
            want = MHA.attention_bwd_reference(qkv, o, g, lse, h, scale)
            err9 = max(rel(f"attention_bwd_hm_f32 {tag} {n}", a, w) for n, a, w in
                       zip(("dq", "dk", "dv"), got.chunk(3, dim=-1), want.chunk(3, dim=-1)))
            check(all(torch.equal(x, y) for x, y in zip(
                (o, lse, got), (*MHA.attention_hm(qkv, h, scale),
                                MHA.attention_hm_bwd(qkv, o, g, lse, h, scale)))),
                  "the f32 head-major pair is not deterministic")
            if i:
                continue
            q, k, v = (t.unflatten(-1, (h, hd)).transpose(1, 2).contiguous()
                       for t in qkv.chunk(3, dim=-1))
            gh = g.unflatten(-1, (h, hd)).transpose(1, 2).contiguous()
            ql, kl, vl = (t.detach().clone().requires_grad_() for t in (q, k, v))
            lib_out = F.scaled_dot_product_attention(ql, kl, vl)
            n, rows = b * h * l * hd, b * h * l
            records["attention_fwd_hm_f32"] = {
                "max_abs_err": err8,
                "ms": time_ms(torch, lambda: MHA.attention_hm(qkv, h, scale), 10),
                "plain_ms": time_ms(torch, lambda: MHA.attention_reference(qkv, h, scale), 3),
                "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(q, k, v), 10),
                "bytes": 4 * n * 4 + rows * 4,
                "tensor_flops": 0.0,
                "tf32_flops": 3 * 4.0 * rows * l * hd,
                "f32_flops": 5.0 * rows * l,
            }
            records["attention_bwd_hm_f32"] = {
                "max_abs_err": err9,
                "ms": time_ms(torch, lambda: MHA.attention_hm_bwd(qkv, o, g, lse, h, scale), 10),
                "plain_ms": time_ms(
                    torch, lambda: MHA.attention_bwd_reference(qkv, o, g, lse, h, scale), 3),
                "library_ms": time_ms(torch, lambda: torch.autograd.grad(
                    lib_out, (ql, kl, vl), gh, retain_graph=True), 10),
                "bytes": 8 * n * 4 + rows * 4,
                "tensor_flops": 0.0,
                "tf32_flops": 3 * 10.0 * rows * l * hd,
                "f32_flops": 5.0 * rows * l,
            }
            kernel_split(torch, lambda: MHA.attention_hm_bwd(qkv, o, g, lse, h, scale),
                         f"attention_bwd_hm_f32 {tag}")
    return records


def _part(name: str) -> str:
    if name.startswith("encoder.blocks."):
        return "encoder.blocks"
    return "encoder.embed" if name.startswith("encoder.") else name.split(".", 1)[0]


def f32_card_vs_cpu(torch, config: dict, size: int = 128) -> None:
    """One full-width DOFA-base ``32-true`` train step on two ``size``^2
    crops on the card (the f32 kernels, TF32 off) against the same weights'
    f32 step on the CPU (plain versions): the loss, and per part of the
    model 1 - cosine and the norm ratio of the gradients."""
    from geo_deep_learning_tpu_torch.cli.config import instantiate
    from geo_deep_learning_tpu_torch.core.precision import PrecisionPolicy
    from geo_deep_learning_tpu_torch.models.layers import DropPath, Dropout

    node = copy.deepcopy(config["model"])
    node["init_args"]["image_size"] = [size, size]
    spec = instantiate(node)
    model = spec.task.materialize(torch.device("cuda"), config["seed_everything"])
    for m in model.modules():
        if isinstance(m, (DropPath, Dropout)):
            m.rate = 0.0
    cpu_model = copy.deepcopy(model).to("cpu")
    batch = _crops(torch, config, size)
    with PrecisionPolicy.create("32-true").scope():
        loss, grads, launches = _train_once(torch, spec, model, batch, "32-true")
    cpu_loss, cpu_grads, _ = _train_once(torch, spec, cpu_model, batch, "32-true")
    want = {k: v for k, v in F32_PER_TRAIN_STEP.items()}
    check(launches == want, f"f32 train step launches {launches}, expected {want}")
    loss_tol, cos_tol, norm_tol = F32_LIMITS
    print(f"  f32 train step, card vs CPU, 2 x {size}^2: loss {loss:.8f} vs {cpu_loss:.8f} "
          f"(relative {abs(loss - cpu_loss) / abs(cpu_loss):.3g}, limit {loss_tol:g})")
    check(abs(loss - cpu_loss) <= loss_tol * abs(cpu_loss), "f32 loss: card and CPU disagree")
    parts: dict[str, list] = {}
    for n in cpu_grads:
        parts.setdefault(_part(n), []).append(n)
    for part, names in parts.items():
        a = torch.cat([grads[n].flatten() for n in names])
        b = torch.cat([cpu_grads[n].flatten() for n in names])
        gap, ratio = 1.0 - cosine(a, b), float(a.double().norm() / b.double().norm())
        print(f"    {part}: {len(names)} tensors, 1 - cosine {gap:.3g}, norm ratio {ratio:.8f}")
        check(gap <= cos_tol and abs(ratio - 1.0) <= norm_tol,
              f"f32 gradients of {part}: card and CPU disagree")


def f32_phase(torch, smi: str, tmp: Path) -> dict[str, int]:
    """``32-true`` on the card: DOFA-base 512^2 ``fit`` of one epoch (10
    steps on tst rows 0-79) with exact launches of the f32 attention
    instances and no bf16 K4/K7; one train step card vs CPU in f32; two
    640^2 steps at bs 2 on the f32 head-major pair; one SegFormer and one
    UNet++ step (K10's f32 instance; cuDNN). Returns the launches of the
    fit and the 640^2 steps."""
    from geo_deep_learning_tpu_torch.cli.config import instantiate
    from geo_deep_learning_tpu_torch.core.precision import PrecisionPolicy
    from geo_deep_learning_tpu_torch.core.train_state import TrainState
    from geo_deep_learning_tpu_torch.ops.cuda import _lib
    from geo_deep_learning_tpu_torch.training.steps import make_train_step

    csv_dir = write_split_csvs(tmp, range(F32_FIT_TRN), range(F32_FIT_TRN, N_TST),
                               range(F32_FIT_TRN, N_TST))
    config = copy.deepcopy(CONFIG)
    config["trainer"].update(default_root_dir=str(tmp / "fit"), max_epochs=1, precision="32-true")
    config["data"]["init_args"].update(csv_root_folder=str(csv_dir), patches_root_folder=str(DATA))
    n_train, n_split = F32_FIT_TRN // BATCH, -(-(N_TST - F32_FIT_TRN) // BATCH)
    result, counts, _, seconds = counted_run(torch, config, "fit")
    print(f"  fit, 1 epoch: {seconds:.2f} s; {result['patches_per_sec']:.2f} train patches/s "
          f"(bs {BATCH}, 512^2, 32-true) on {smi}")
    print(f"  fit: {result}")
    expect_launches("fit", counts, F32_PER_TRAIN_STEP, F32_PER_BATCH, n_train, 2 * n_split)
    check(all(math.isfinite(v) for v in result.values()), "non-finite 32-true fit metric")
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    print(f"  TF32 flags after the run (cuBLAS, cuDNN): {flags}")

    spec = instantiate(config["model"])
    data = instantiate(config["data"])
    data.setup("fit")
    resident = [to_card(torch, b) for b, _ in zip(data.train_dataloader(), range(3))]
    ms, peak = resident_step_ms(torch, spec, resident, "32-true", n=4)
    print(f"  32-true train steps on resident batches: {ms:.2f} ms a bs-{BATCH} 512^2 step, peak "
          f"{peak:.2f} GiB; on {smi}")
    del resident
    f32_card_vs_cpu(torch, config)

    policy = PrecisionPolicy.create("32-true")
    gen = torch.Generator(device="cuda").manual_seed(6)
    node = copy.deepcopy(CONFIG_640["model"])
    spec640 = instantiate(node)
    model = spec640.task.materialize(torch.device("cuda"), 42)
    state = TrainState.create(model, torch.optim.SGD(model.parameters(), lr=1e-3), 0)
    step = make_train_step(spec640.task, policy, augment=None)
    batch = {"image": torch.randint(0, 256, (2, SIZE_640, SIZE_640, 3), generator=gen,
                                    device="cuda", dtype=torch.uint8),
             "mask": torch.randint(0, 2, (2, SIZE_640, SIZE_640), generator=gen, device="cuda"),
             "mean": torch.tensor(CONFIG["data"]["init_args"]["mean"], device="cuda"),
             "std": torch.tensor(CONFIG["data"]["init_args"]["std"], device="cuda")}
    torch.cuda.synchronize()
    _lib.reset_launches()
    t0 = time.perf_counter()
    with policy.scope():
        losses = [float(step(state, batch)["loss"]) for _ in range(2)]
    torch.cuda.synchronize()
    counts640 = dict(_lib.LAUNCHES)
    print(f"  640^2, 32-true, 2 steps at bs 2: losses {losses}, "
          f"{1e3 * (time.perf_counter() - t0) / 2:.1f} ms a step (first included)")
    expect_launches("640^2 steps", counts640, F32_PER_TRAIN_STEP_640, {}, 2, 0)
    check(all(math.isfinite(x) for x in losses), "non-finite 640^2 f32 loss")
    del model, state

    for label, fam_config, want in (
            ("SegFormer mit_b0", SEGFORMER_CONFIG, SEG_PER_TRAIN_STEP),
            ("UNet++ resnet34", UNETPLUS_CONFIG, UNETPP_PER_TRAIN_STEP)):
        fam = copy.deepcopy(fam_config)
        fam["data"]["init_args"].update(csv_root_folder=str(DATA), patches_root_folder=str(DATA))
        fspec = instantiate(fam["model"])
        fmodel = fspec.task.materialize(torch.device("cuda"), 42)
        with policy.scope():
            loss, _, launches = _train_once(torch, fspec, fmodel, _crops(torch, fam, 512),
                                            "32-true")
        print(f"  {label}, 32-true step on 2 x 512^2: loss {loss:.6f}, launches {launches}")
        check(math.isfinite(loss) and launches == want,
              f"{label} 32-true step: launches {launches}, expected {want}")
    return {k: counts.get(k, 0) + counts640.get(k, 0) for k in set(counts) | set(counts640)}


def remat_phase(torch, smi: str) -> None:
    """DOFA-base 512^2 bs 8 bf16 train steps with ``remat`` none, ``"mlp"``
    and ``"block"`` in turns (none, mlp, block, block, mlp, none), the same
    seeded weights and batch, SGD at LR 0 so every step sees them: step ms,
    peak memory, the attention forward's launches a step (12, 12, 24) and
    the same loss within 1e-6 relative."""
    import dataclasses

    from geo_deep_learning_tpu_torch.cli.config import instantiate
    from geo_deep_learning_tpu_torch.core.precision import PrecisionPolicy
    from geo_deep_learning_tpu_torch.core.train_state import TrainState
    from geo_deep_learning_tpu_torch.models.segmentation.dofa import DOFASegmentation
    from geo_deep_learning_tpu_torch.ops.cuda import _lib
    from geo_deep_learning_tpu_torch.training.steps import make_train_step

    config = data_config(DOFA)
    spec = instantiate(config["model"])
    batch = to_card(torch, next(iter(instantiate(config["data"]).test_dataloader())))
    steps, seen = {}, {}
    for mode in REMAT_MODES:
        with torch.device("meta"):
            model = DOFASegmentation("dofa_base", 1, 256, 512, remat=mode is not None,
                                     remat_mode=mode or "mlp")
        task = dataclasses.replace(spec.task, model=model)
        task.materialize(torch.device("cuda"), 42)
        state = TrainState.create(task.model, torch.optim.SGD(task.model.parameters(), lr=0.0), 0)
        steps[mode] = (state, make_train_step(task, PrecisionPolicy.create("bf16-mixed"),
                                              augment=None))
    for mode in (*REMAT_MODES, *reversed(REMAT_MODES)):
        state, step = steps[mode]
        step(state, batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _lib.reset_launches()
        t0 = time.perf_counter()
        losses = [float(step(state, batch)["loss"]) for _ in range(REMAT_STEPS)]
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / REMAT_STEPS
        fwd = _lib.LAUNCHES["attention_fwd_packed"] / REMAT_STEPS
        peak = torch.cuda.max_memory_allocated() / 2**30
        seen.setdefault(mode, []).append((ms, peak, fwd, losses[0]))
        print(f"  remat {mode or 'none'}: {ms:.2f} ms a bs-{BATCH} 512^2 step, peak "
              f"{peak:.2f} GiB, attention forward {fwd:g} a step, loss {losses[0]:.8f}; on {smi}")
    for mode, runs in seen.items():
        want = 24 if mode == "block" else 12
        check(all(r[2] == want for r in runs), f"remat {mode}: attention forward launches")
        # each turn's first timed step is every mode's same step (same draws)
        for r, ref in zip(runs, seen[None]):
            check(abs(r[3] - ref[3]) <= 1e-6 * abs(ref[3]), f"remat {mode}: loss moved")


DOFA = ModelPath("DOFA-base + UperNet", CONFIG, PER_BATCH, PER_TRAIN_STEP, 128,
                 train_reference_check)
SEGFORMER = ModelPath("SegFormer mit_b0", SEGFORMER_CONFIG, SEG_PER_BATCH, SEG_PER_TRAIN_STEP,
                      512, segformer_train_check, (dynamic_check,))
UNETPP = ModelPath("UNet++ resnet34", UNETPLUS_CONFIG, UNETPP_PER_BATCH, UNETPP_PER_TRAIN_STEP,
                   512, unetpp_train_check, reference=unetpp_reference_check)
PATHS = (DOFA, SEGFORMER, UNETPP)
DOFA640 = ModelPath("DOFA-base + UperNet at 640^2", CONFIG_640, PER_BATCH_640,
                    PER_TRAIN_STEP_640, TRAIN_CHECK_640, train_reference_check)


# the export phase: gdl:: nodes (and kernel launches) of one bs-8 512^2
# forward of each family's exported serving program; the probabilities of
# the loaded program against the eager serving module (the same kernels in
# the same order: a difference is an export fault, not rounding)
EXPORT_DOFA = {"layernorm_fwd": 4, "layernorm_residual_fwd": 20, "attention_fwd_packed": 12}
EXPORT_SEG = {"sr_attention_fwd": 6}
EXPORT_TOL = 4e-3  # half a bf16 ulp at 1.0
SERVE_TURNS, SERVE_CALLS = 3, 10

_FRESH = """
import sys
import torch
sys.path.insert(0, sys.argv[1])
from geo_deep_learning_tpu_torch.inference.export import load_exported
program = load_exported(sys.argv[2])
from geo_deep_learning_tpu_torch.ops.cuda import _lib
x = torch.load(sys.argv[3]).cuda()
_lib.reset_launches()
y = program(x)
torch.cuda.synchronize()
torch.save({"y": y.cpu(), "launches": dict(_lib.LAUNCHES)}, sys.argv[4])
"""


def serving_batch(torch, config: dict):
    """tst patches 0-7 as a raw ``[8, 512, 512, 3]`` f32 batch on the card."""
    import numpy as np

    from geo_deep_learning_tpu_torch.cli.config import instantiate

    data = instantiate(config["data"])
    data.setup("test")
    images = np.stack([data.datasets["tst"][i]["image"] for i in range(BATCH)])
    return torch.from_numpy(images).cuda().float()


def export_family(torch, smi: str, tmp: Path, label: str, config: dict, nodes_want: dict,
                  x, model=None, baked=None):
    """One family's serving module (bf16-mixed, seeded weights) exported with
    a symbolic batch, saved, loaded; its ``gdl::`` nodes, one loaded call's
    launches (exactly those nodes' kernels) and its probabilities against
    the eager module's. Returns ``(model, eager module, loaded program,
    .pt2 path, loaded output)``."""
    from geo_deep_learning_tpu_torch.cli.config import instantiate
    from geo_deep_learning_tpu_torch.inference.export import (
        export_model,
        gdl_nodes,
        load_exported,
        make_serving_fn,
    )
    from geo_deep_learning_tpu_torch.ops.cuda import _lib

    spec = instantiate(config["model"])
    if model is None:
        model = spec.task.materialize(torch.device("cuda"), config["seed_everything"])
    data = config["data"]["init_args"]
    serving = make_serving_fn(model, data["mean"], data["std"], spec.task.num_classes,
                              wavelengths=None if baked is not None
                              else spec.task.default_wavelengths,
                              baked_embed=baked, precision="bf16-mixed")
    path = tmp / f"{label.split()[0].lower()}{'_baked' if baked is not None else ''}.pt2"
    t0 = time.perf_counter()
    export_model(serving, tuple(x.shape), path)
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = load_exported(path)
    load_s = time.perf_counter() - t0
    nodes = gdl_nodes(loaded.program)
    print(f"  {label}: export {export_s:.1f} s, .pt2 {path.stat().st_size / 2**20:.1f} MiB, "
          f"load {load_s:.1f} s; gdl:: nodes {nodes}")
    check(nodes == nodes_want, f"{label}: gdl:: nodes {nodes}, expected {nodes_want}")
    with torch.inference_mode():
        want = serving(x)
    torch.cuda.synchronize()
    _lib.reset_launches()
    got = loaded(x)
    torch.cuda.synchronize()
    launches = dict(_lib.LAUNCHES)
    classes = spec.task.num_classes
    check(got.shape == (x.shape[0], 512, 512, classes) and bool(torch.isfinite(got).all()),
          f"{label}: output {tuple(got.shape)} or not finite")
    err = float((got - want).abs().max())
    print(f"  {label}: one loaded call launches {launches}; probabilities against the eager "
          f"serving module: max_abs_err {err:.3g} (tolerance {EXPORT_TOL:g})")
    check(launches == nodes_want, f"{label}: launches {launches}, expected {nodes_want}")
    check(err <= EXPORT_TOL, f"{label}: exported and eager serving disagree")
    return model, serving, loaded, path, got


def patches_per_s(torch, fns: dict) -> dict[str, float]:
    """bs-8 patches/s of each serving callable, ``SERVE_CALLS`` calls a turn
    after two warm-up calls, in turns (the order reversed every other
    turn); the median turn."""
    runs: dict[str, list[float]] = {name: [] for name in fns}
    names = list(fns)
    with torch.inference_mode():
        for name in names:
            for _ in range(2):
                fns[name]()
        for turn in range(SERVE_TURNS):
            for name in names if turn % 2 == 0 else names[::-1]:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(SERVE_CALLS):
                    fns[name]()
                torch.cuda.synchronize()
                runs[name].append(BATCH * SERVE_CALLS / (time.perf_counter() - t0))
    return {name: sorted(v)[len(v) // 2] for name, v in runs.items()}


def export_phase(torch, smi: str, tmp: Path) -> None:
    """DOFA-base + UperNet 512^2 (wavelengths, then the baked embedding),
    SegFormer mit_b0 and UNet++ resnet34 through ``make_serving_fn`` ->
    ``export_model`` -> ``load_exported`` on tst patches 0-7; DOFA's program
    loaded again in a fresh process on the same batch; patches/s of the
    eager module, the loaded program and the baked program."""
    from geo_deep_learning_tpu_torch.inference.export import bake_dofa_embedding

    x = serving_batch(torch, CONFIG)
    model, eager, loaded, path, got = export_family(
        torch, smi, tmp, DOFA.label, CONFIG, EXPORT_DOFA, x)
    torch.save(x.cpu(), tmp / "x.pt")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", _FRESH, str(ROOT), str(path), str(tmp / "x.pt"),
                           str(tmp / "y.pt")], capture_output=True, text=True, timeout=300,
                          check=False)
    check(proc.returncode == 0, f"fresh-process load failed: {proc.stderr[-2000:]}")
    fresh = torch.load(tmp / "y.pt")
    same = torch.equal(fresh["y"], got.cpu())
    diff = float((fresh["y"] - got.cpu()).abs().max())
    print(f"  {DOFA.label}: a fresh process loads the .pt2 and runs the batch in "
          f"{time.perf_counter() - t0:.1f} s, launches {fresh['launches']}; its output "
          + ("equals this process's bit for bit" if same else
             f"differs from this process's by {diff:.3g} (the same kernels on the same "
             "inputs: cuBLAS and cuDNN chose other algorithms in that process)"))
    check(fresh["launches"] == EXPORT_DOFA, "fresh process: wrong launches")
    check(same or diff <= EXPORT_TOL, "fresh process: output differs beyond the tolerance")
    baked = bake_dofa_embedding(model, CONFIG["model"]["init_args"]["wavelengths"], 3)
    _, baked_eager, baked_loaded, baked_path, baked_got = export_family(
        torch, smi, tmp, f"{DOFA.label} baked", CONFIG, EXPORT_DOFA, x, model=model, baked=baked)
    print(f"  {DOFA.label}: baked against wavelength serving, max_abs_err "
          f"{float((baked_got - got).abs().max()):.3g} (the generator in f32 against bf16)")
    rates = patches_per_s(torch, {"eager": lambda: eager(x), "exported": lambda: loaded(x),
                                  "eager baked": lambda: baked_eager(x),
                                  "exported baked": lambda: baked_loaded(x)})
    for name, rate in rates.items():
        print(f"  {DOFA.label} serving, {name}: {rate:.2f} patches/s (bs {BATCH}, 512^2, "
              f"bf16-mixed) on {smi}")
    for p in (path, baked_path):
        p.unlink()
    del model, eager, loaded, baked_eager, baked_loaded
    for label, config, nodes in ((SEGFORMER.label, SEGFORMER_CONFIG, EXPORT_SEG),
                                 (UNETPP.label, UNETPLUS_CONFIG, {})):
        _, _, _, path, _ = export_family(torch, smi, tmp, label, config, nodes, x)
        path.unlink()


# --- data parallelism -------------------------------------------------------------

DP = "data parallel (one process a rank)"
DP_STEPS = 3  # resident-batch train steps of (b)
DP_ROWS = range(BATCH)  # tst patches 0-7: the global batch of (b) and (c)
DP_UNETPP_SIZE = 256
# (b) against one rank on the card: the loss; how far each block's and all
# gradients' cosine to the f32 step may fall short of one rank's bf16
# cosine; the norm ratio to f32 (PERF.md section 2's DOFA limits)
DP_LIMITS = (1e-3, 0.02, 0.005, 0.02)
DP_BN_TOL = (1e-5, 1e-4)  # (c) BN running statistics, absolute + relative
DP_SCENE = (4, 3)  # (d) tst patches 0-11 mosaicked 4 x 3: a 2048 x 1536 scene
DP_SCENE_TOL = 1e-5  # (d) strip pixels, relative to the map's largest |logit|
DP_FIT_TOL = 5e-3  # (a) fit metrics, NCCL against no mesh (two card runs)
DP_GROUP_S = 120.0  # the longest a collective waits
DP_DEADLINE_S = 420.0  # the longest one launch of ranks may take


def _dp_fit_rank(config: dict) -> dict:
    """(a) One rank of the NCCL fit: ``run`` joins the launcher's group."""
    from geo_deep_learning_tpu_torch.cli.main import run
    from geo_deep_learning_tpu_torch.ops.cuda import _lib

    _lib.reset_launches()
    result = run(config, "fit", "cuda")
    return {"result": result, "launches": dict(_lib.LAUNCHES)}


def _dp_batch(torch, config: dict, rows, size: int | None = None) -> dict:
    """tst patches ``rows`` (their top-left ``size``^2) as a uint8 host batch."""
    import numpy as np

    from geo_deep_learning_tpu_torch.cli.config import instantiate

    data = instantiate(config["data"])
    data.setup("test")
    samples = [data.datasets["tst"][i] for i in rows]
    size = size or samples[0]["image"].shape[0]
    return {
        "image": torch.from_numpy(np.stack([s["image"][:size, :size] for s in samples])),
        "mask": torch.from_numpy(np.stack([s["mask"][:size, :size] for s in samples])),
        "mean": torch.from_numpy(samples[0]["mean"]),
        "std": torch.from_numpy(samples[0]["std"]),
    }


def _dp_steps(torch, config: dict, batch: dict, precision: str, mesh, steps: int, size: int):
    """``steps`` train steps of the config's model at full width (``size``^2,
    DropPath and dropout off, Adam 1e-4, no clip, no augmentation) on the
    resident global ``batch`` over ``mesh``, the model cut to this rank's
    shards under a model axis (``place_state``): (losses, the first step's
    whole gradients as the optimizer sees them, gathered over the model
    group, launches, ms a step and bytes all-reduced a step after the
    first, model)."""
    import dataclasses

    import torch.distributed as dist

    from geo_deep_learning_tpu_torch.cli.config import instantiate
    from geo_deep_learning_tpu_torch.core.mesh import shard_batch
    from geo_deep_learning_tpu_torch.core.precision import PrecisionPolicy
    from geo_deep_learning_tpu_torch.core.train_state import TrainState
    from geo_deep_learning_tpu_torch.models.layers import DropPath, Dropout
    from geo_deep_learning_tpu_torch.ops.cuda import _lib
    from geo_deep_learning_tpu_torch.parallel import placement
    from geo_deep_learning_tpu_torch.training import optim
    from geo_deep_learning_tpu_torch.training.steps import make_train_step

    node = copy.deepcopy(config["model"])
    node["init_args"]["image_size"] = [size, size]
    spec = instantiate(node)
    model = spec.task.materialize(mesh.device, config["seed_everything"])
    for m in model.modules():
        if isinstance(m, (DropPath, Dropout)):
            m.rate = 0.0
    placement.replicate_state(model, mesh)
    tp = mesh.model_size > 1
    placement.place_state(model, mesh, placement.TENSOR_PARALLEL_RULES if tp else None)
    opt = optim.build_optimizer(list(model.parameters()), "adam", 1e-4)
    grads: dict = {}

    def capture(*_) -> None:
        if grads:
            return
        for n, p in model.named_parameters():
            if p.grad is None:
                continue
            split = getattr(p, "model_split", None)
            g = p.grad.detach()
            grads[n] = g.clone() if split is None else placement.gather_tensor(g, split, mesh)

    opt.register_step_pre_hook(capture)
    policy = PrecisionPolicy.create(precision)
    step = make_train_step(dataclasses.replace(spec.task, model=model), policy, augment=None,
                           grad_clip=None, mesh=mesh)
    state = TrainState.create(model, opt, 0)
    local = {k: v.to(mesh.device) if isinstance(v, torch.Tensor) else v
             for k, v in shard_batch(batch, mesh).items()}
    moved = [0]
    all_reduce = dist.all_reduce

    def counting(t, *args, **kwargs):
        moved[0] += t.numel() * t.element_size()
        return all_reduce(t, *args, **kwargs)

    with policy.scope():
        torch.cuda.synchronize()
        _lib.reset_launches()
        losses = [float(step(state, local)["loss"])]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dist.all_reduce = counting
        try:
            losses += [float(step(state, local)["loss"]) for _ in range(steps - 1)]
        finally:
            dist.all_reduce = all_reduce
        torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / max(steps - 1, 1)
    return losses, grads, dict(_lib.LAUNCHES), ms, moved[0] / max(steps - 1, 1), model


def _axis(mesh) -> tuple:
    """(group, rank, size) of the axis the ranks of a phase span: the model
    axis under tensor parallelism, else the data axis."""
    if mesh.model_size > 1:
        return mesh.model_group, mesh.model_rank, mesh.model_size
    return mesh.group, mesh.rank, mesh.size


def _dp_ranks_equal(torch, model, mesh) -> bool:
    """Every parameter that is not sharded over the model axis, and every
    buffer, bit-equal to the first rank's of the axis the ranks span, on
    every rank; the names of the first that differ are printed."""
    import torch.distributed as dist

    group, rank, _ = _axis(mesh)
    src = mesh.global_rank - mesh.model_rank if mesh.model_size > 1 else 0
    bad: list[str] = []
    for name, t in (*model.named_parameters(), *model.named_buffers()):
        if getattr(t, "model_split", None) is not None:
            continue
        ref = t.detach().clone()
        dist.broadcast(ref, src=src, group=group)
        if not torch.equal(ref, t.detach()):
            bad.append(name)
    if bad:
        print(f"  rank {rank}: {len(bad)} replicated tensors differ from the first rank's, "
              f"first {bad[:5]}", flush=True)
    flag = torch.tensor([len(bad)], device=mesh.device)
    dist.all_reduce(flag, group=group)
    return int(flag.item()) == 0


def _dp_dofa(torch, mesh) -> dict:
    """DOFA-base 512^2 bf16-mixed, global bs 8 (tst 0-7): 3 steps on the
    ranks (data parallel (b), or tensor parallel (a): two model ranks), the
    ranks' states compared, then (the first rank) the same on one rank and
    one f32 step, the yardstick of both bf16 steps' gradients."""
    import torch.distributed as dist

    from geo_deep_learning_tpu_torch.core.mesh import Mesh
    from geo_deep_learning_tpu_torch.parallel.placement import count_model_sharded

    config = data_config(DOFA)
    batch = _dp_batch(torch, config, DP_ROWS)
    losses, grads, launches, ms, moved, model = _dp_steps(torch, config, batch, "bf16-mixed",
                                                          mesh, DP_STEPS, 512)
    group, rank, size = _axis(mesh)
    every: list = [None] * size
    dist.all_gather_object(every, launches, group=group)
    out = {"losses": losses, "launches": every, "ms": ms, "bytes": moved,
           "equal": _dp_ranks_equal(torch, model, mesh), "n_sharded": count_model_sharded(model)}
    del model
    if rank != 0:
        return out
    one = Mesh(device=mesh.device)
    one_losses, one_grads, _, one_ms, _, _ = _dp_steps(torch, config, batch, "bf16-mixed", one,
                                                       DP_STEPS, 512)
    f32_losses, f32_grads, _, _, _, _ = _dp_steps(torch, config, batch, "32-true", one, 1, 512)
    check(set(grads) == set(one_grads), "the ranks' gradients are not the model's")
    blocks = sorted({n.split(".")[2] for n in one_grads if n.startswith("encoder.blocks.")},
                    key=int)
    names = {b: [n for n in sorted(one_grads) if n.startswith(f"encoder.blocks.{b}.")]
             for b in blocks}
    names["all"] = sorted(one_grads)

    def flat(g, b):
        return torch.cat([g[n].flatten().float() for n in names[b]])

    # each bf16 step's gradients against the f32 step's: cosines by block
    # and over all, and the norm ratio, for 2 ranks and for 1 (the yardstick)
    out.update(one_losses=one_losses, one_ms=one_ms, f32_loss=f32_losses[0])
    for key, g in (("two", grads), ("one", one_grads)):
        out[f"{key}_cos"] = {b: cosine(flat(g, b), flat(f32_grads, b)) for b in names}
        out[f"{key}_norm"] = float(flat(g, "all").norm() / flat(f32_grads, "all").norm())
    out["pair_cos"] = cosine(flat(grads, "all"), flat(one_grads, "all"))
    return out


def _dp_unetpp(torch, mesh) -> dict:
    """(c) UNet++ resnet34 at 256^2, 32-true, global bs 8: one step at 2 ranks
    and (rank 0) on one rank; the BN running statistics and the loss."""
    from geo_deep_learning_tpu_torch.core.mesh import Mesh

    config = data_config(UNETPP)
    batch = _dp_batch(torch, config, DP_ROWS, DP_UNETPP_SIZE)
    losses, _, _, _, _, model = _dp_steps(torch, config, batch, "32-true", mesh, 1,
                                          DP_UNETPP_SIZE)
    out = {"equal": _dp_ranks_equal(torch, model, mesh), "loss": losses[0]}
    if mesh.rank != 0:
        return out
    one_losses, _, _, _, _, one = _dp_steps(torch, config, batch, "32-true",
                                            Mesh(device=mesh.device), 1, DP_UNETPP_SIZE)
    atol, rtol = DP_BN_TOL
    stats = [(n, b, dict(one.named_buffers())[n]) for n, b in model.named_buffers()
             if n.endswith(("running_mean", "running_var"))]
    worst = max(float(((a - b).abs() - rtol * b.abs()).max()) for _, a, b in stats)
    out.update(one_loss=one_losses[0], n_stats=len(stats), worst_excess=worst,
               within=all(torch.allclose(a, b, atol=atol, rtol=rtol) for _, a, b in stats))
    return out


def _dp_scene(torch, mesh) -> dict:
    """(d) UNet++ resnet34 (bf16-mixed, eval) over a 2048 x 1536 mosaic of
    tst patches 0-11, 512 tiles, overlap 128, one tile a batch (a tile's
    logits then do not depend on its batch): the sharded path (hann) and
    the halo path (crop) at 2 ranks against (rank 0) one rank's."""
    import numpy as np

    from geo_deep_learning_tpu_torch.cli.config import instantiate
    from geo_deep_learning_tpu_torch.cli.main import tile_forward
    from geo_deep_learning_tpu_torch.core.precision import PrecisionPolicy
    from geo_deep_learning_tpu_torch.inference import sliding_window as sw

    config = data_config(UNETPP)
    rows, cols = DP_SCENE
    patches = _dp_batch(torch, config, range(rows * cols))
    image = patches["image"].numpy()
    scene = np.concatenate([np.concatenate(list(image[r * cols:(r + 1) * cols]), axis=1)
                            for r in range(rows)], axis=0)
    spec = instantiate(copy.deepcopy(config["model"]))
    spec.task.materialize(mesh.device, config["seed_everything"])
    forward = tile_forward(spec.task, PrecisionPolicy.create("bf16-mixed"))
    x = sw.normalize(torch.from_numpy(scene).to(mesh.device), patches["mean"].tolist(),
                     patches["std"].tolist())
    cfgs = {blend: sw.SlidingWindowConfig(512, 128, 1, blend) for blend in ("hann", "crop")}
    t0 = time.perf_counter()
    sharded = sw.sliding_window_logits_sharded(forward, x, 1, mesh, cfgs["hann"])
    halo = sw.sliding_window_logits_halo(forward, x, 1, mesh, cfgs["crop"])
    torch.cuda.synchronize()
    out = {"s": time.perf_counter() - t0, "shape": list(scene.shape)}
    if mesh.rank != 0:
        return out
    one = {b: sw.sliding_window_logits(forward, x, 1, c) for b, c in cfgs.items()}
    plan = sw.plan_bands(scene.shape[0], scene.shape[1], cfgs["crop"], mesh.size)
    strip = torch.zeros(scene.shape[0], dtype=torch.bool, device=mesh.device)
    for d in range(1, mesh.size):
        b = plan["bounds"][d]
        strip[b - plan["strip"]:b + plan["strip"]] = True
    scale = float(one["crop"].abs().max())
    out.update(
        sharded_err=float((sharded - one["hann"]).abs().max()) / scale,
        sharded_map_diff=int((sharded > 0).ne(one["hann"] > 0).sum()),
        halo_outside_equal=bool(torch.equal(halo[~strip], one["crop"][~strip])),
        halo_strip_err=float((halo[strip] - one["crop"][strip]).abs().max()) / scale,
        halo_map_diff=int((halo > 0).ne(one["crop"] > 0).sum()),
        strip_rows=int(strip.sum()), bounds=plan["bounds"])
    return out


def _dp_gloo_rank() -> dict:
    """(b), (c) and (d) on one of two ranks that share the card over gloo."""
    import torch

    from geo_deep_learning_tpu_torch.core.mesh import create_mesh

    mesh = create_mesh(device="cuda")
    return {"dofa": _dp_dofa(torch, mesh), "unetpp": _dp_unetpp(torch, mesh),
            "scene": _dp_scene(torch, mesh)}


def dp_phase(torch, smi: str, tmp: Path) -> dict[str, int]:
    """Data parallelism on the card. (a) NCCL at ``device_count()`` ranks: a
    ``fit`` of DOFA-base 512^2 (1 epoch, trn tst 0-15, val 16-23, tst 24-31)
    with ``trainer.mesh: {data: -1}`` in a group the launcher started,
    against the same ``fit`` with no mesh. (b)-(d) on two ranks sharing
    the card over gloo (``_dp_gloo_rank``). Returns the launches of the
    NCCL fit's rank 0 and of both ranks' (b) steps."""
    from geo_deep_learning_tpu_torch.core.mesh import launch

    csv_dir = write_split_csvs(tmp, range(16), range(16, 24), range(24, 32))
    base = copy.deepcopy(data_config(DOFA))
    base["trainer"].update(max_epochs=1)
    base["data"]["init_args"].update(csv_root_folder=str(csv_dir))
    fits = {}
    for label, mesh in (("no mesh", None), ("NCCL", {"data": -1})):
        config = copy.deepcopy(base)
        config["trainer"]["default_root_dir"] = str(tmp / label.replace(" ", "_"))
        t0 = time.perf_counter()
        if mesh is None:
            fits[label] = run_checked(config, "fit")
        else:
            config["trainer"]["mesh"] = mesh
            ranks = torch.cuda.device_count()
            got = launch(_dp_fit_rank, (config,), size=ranks, backend="nccl",
                         timeout_s=DP_GROUP_S, deadline_s=DP_DEADLINE_S)
            fits[label], nccl_launches = got["result"], got["launches"]
        print(f"  (a) fit, {label}: {time.perf_counter() - t0:.1f} s, {fits[label]}")
    keys = [k for k in fits["no mesh"] if k.startswith(("train_loss", "val_", "test_"))]
    diff = max(abs(fits["NCCL"][k] - fits["no mesh"][k]) for k in keys)
    print(f"  (a) NCCL at {torch.cuda.device_count()} rank(s) against no mesh: largest metric "
          f"difference {diff:.3g} (tolerance {DP_FIT_TOL:g}); rank 0 launches {nccl_launches}")
    check(set(fits["NCCL"]) == set(fits["no mesh"]) and diff <= DP_FIT_TOL,
          "the NCCL fit disagrees with the fit without a mesh")
    check(all(nccl_launches.get(k, 0) > 0 for k in PER_TRAIN_STEP), "NCCL fit: a kernel missing")
    check(not worker_processes(), "a rank process is left")

    t0 = time.perf_counter()
    res = launch(_dp_gloo_rank, (), size=2, backend="gloo", timeout_s=DP_GROUP_S,
                 deadline_s=DP_DEADLINE_S)
    print(f"  (b)-(d): 2 ranks sharing the card over gloo, {time.perf_counter() - t0:.1f} s")
    check(not worker_processes(), "a rank process is left")
    b = res["dofa"]
    loss_tol, block_gap, all_gap, norm_tol = DP_LIMITS
    want = {k: DP_STEPS * v for k, v in PER_TRAIN_STEP.items()}
    print(f"  (b) DOFA-base 512^2 bf16, global bs {BATCH}: losses 2 ranks {b['losses']}, 1 rank "
          f"{b['one_losses']}; step ms (2 ranks sharing one card: correctness only, not "
          f"scaling) {b['ms']:.2f}, 1 rank {b['one_ms']:.2f}; ranks bit-equal {b['equal']}; "
          f"launches a rank {b['launches']}")
    two, one = b["two_cos"], b["one_cos"]
    short = {k: one[k] - two[k] for k in two}
    print(f"  (b) gradients against the f32 step (1 rank, loss {b['f32_loss']:.6f}): cosines "
          f"2 ranks {two}, 1 rank {one}; norm ratio 2 ranks {b['two_norm']:.6f}, 1 rank "
          f"{b['one_norm']:.6f}; 2 ranks' bf16 gradients against 1 rank's: cosine "
          f"{b['pair_cos']:.6f}; on {smi}")
    check(b["equal"], "(b) the ranks' parameters differ")
    check(abs(b["losses"][0] - b["one_losses"][0]) <= loss_tol, "(b) loss disagrees with 1 rank")
    check(all(v <= block_gap for k, v in short.items() if k != "all")
          and short["all"] <= all_gap and abs(b["two_norm"] - 1) <= norm_tol,
          "(b) gradients disagree with 1 rank")
    check(all(r == want for r in b["launches"]), f"(b) launches a rank, expected {want}")
    c = res["unetpp"]
    print(f"  (c) UNet++ resnet34 {DP_UNETPP_SIZE}^2 32-true: loss 2 ranks {c['loss']:.7f}, 1 "
          f"rank {c['one_loss']:.7f}; {c['n_stats']} BN statistics, largest excess over "
          f"rtol {DP_BN_TOL[1]:g}: {c['worst_excess']:.3g} (atol {DP_BN_TOL[0]:g}); ranks "
          f"bit-equal {c['equal']}")
    check(c["equal"] and c["within"] and c["n_stats"] > 0, "(c) BN statistics disagree")
    check(abs(c["loss"] - c["one_loss"]) <= 1e-4, "(c) loss disagrees with 1 rank")
    d = res["scene"]
    print(f"  (d) scene {d['shape']}: 2 ranks {d['s']:.2f} s; sharded vs 1 rank "
          f"{d['sharded_err']:.3g} of the largest logit, {d['sharded_map_diff']} map pixels "
          f"differ; halo bit-identical outside {d['strip_rows']} strip rows "
          f"{d['halo_outside_equal']}, strips {d['halo_strip_err']:.3g}, "
          f"{d['halo_map_diff']} map pixels differ (bounds {d['bounds']})")
    check(d["sharded_err"] <= DP_SCENE_TOL and d["halo_outside_equal"]
          and d["halo_strip_err"] <= DP_SCENE_TOL, "(d) scene paths disagree with 1 rank")
    counts = dict(nccl_launches)
    for r in b["launches"]:
        for k, v in r.items():
            counts[k] = counts.get(k, 0) + v
    return counts


# --- tensor parallelism ------------------------------------------------------------

TP = "tensor parallel (data 1 x model 2)"
TP_MESH = {"data": 1, "model": 2}
TP_PER_TRAIN_STEP = PER_TRAIN_STEP_640  # DOFA 512^2 under the mesh clause: K8/K9, no K4/K7
TP_HM_CASE = (BATCH, 6, 1297, 64, 1.0, False)  # a rank's K8/K9 shape: 6 of the 12 heads
# (a) against one rank on the card, as DP_LIMITS: the loss; how far each
# block's and all gradients' cosine to the f32 step may fall short of one
# rank's bf16 cosine; the norm ratio to f32. Two card runs read 2.01e-5,
# 0.0014 (block 11), 0.00063 and 2.65e-4 (H100 80GB HBM3, 700.00 W)
TP_LIMITS = (1e-4, 0.005, 0.002, 0.005)
TP_SEG_LOSS = 1e-4  # (c) SegFormer mit_b0 bf16 loss against one rank's (read 3e-6)


def _tp_segformer(torch, mesh) -> dict:
    """(c) SegFormer mit_b0 512^2 bf16-mixed, global bs 8 (tst 0-7): one
    step on the 2 model ranks (the 2- and 8-head stages sharded, K10 on
    their local heads) and (rank 0) on one rank."""
    from geo_deep_learning_tpu_torch.core.mesh import Mesh

    config = data_config(SEGFORMER)
    batch = _dp_batch(torch, config, DP_ROWS)
    losses, _, launches, _, _, model = _dp_steps(torch, config, batch, "bf16-mixed", mesh, 1, 512)
    out = {"loss": losses[0], "launches": launches,
           "equal": _dp_ranks_equal(torch, model, mesh)}
    if mesh.model_rank == 0:
        one, _, one_launches, _, _, _ = _dp_steps(torch, config, batch, "bf16-mixed",
                                                  Mesh(device=mesh.device), 1, 512)
        out.update(one_loss=one[0], one_launches=one_launches)
    return out


def _tp_fit(config: dict) -> dict:
    """(d) ``run(config, "fit")`` with ``trainer.mesh: {data: 1, model: 2}``
    on this rank (``run`` joins the launcher's group): its metrics and its
    best checkpoint."""
    from geo_deep_learning_tpu_torch.cli.main import run

    result = run(config, "fit", "cuda")
    index = Path(config["trainer"]["default_root_dir"]) / "checkpoints" / "index.json"
    return {"result": result, "best": json.loads(index.read_text())["best_path"]}


def _tp_rank(fit_config: dict) -> dict:
    """(a), (c) and (d) on one of two model ranks that share the card over gloo."""
    import torch

    from geo_deep_learning_tpu_torch.core.mesh import MeshConfig, create_mesh

    mesh = create_mesh(MeshConfig(**TP_MESH), device="cuda")
    return {"dofa": _dp_dofa(torch, mesh), "segformer": _tp_segformer(torch, mesh),
            "fit": _tp_fit(fit_config)}


def tp_phase(torch, smi: str, tmp: Path) -> dict[str, int]:
    """Tensor parallelism on the card: (b) K8/K9 alone at a model rank's
    shape ``[8, 6, 1297, 64]``, then one launch of two gloo ranks sharing
    the card as ``{data: 1, model: 2}`` (``_tp_rank``), then a one-process
    ``test`` of the tensor-parallel fit's best checkpoint. Returns both
    ranks' launches of (a)'s steps."""
    from geo_deep_learning_tpu_torch.core.mesh import launch

    gen = torch.Generator(device="cuda").manual_seed(3)

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    def compare(name, got, want, tol):
        err = max_err(got, want)
        print(f"  (b) {name}: max_abs_err {err:.3g} (tolerance {tol:g})")
        check(math.isfinite(err) and err <= tol, f"{name}: error {err} above {tol}")
        return err

    rec8, rec9 = head_major_records(torch, randn, compare, cases=[TP_HM_CASE])
    for name, rec in (("attention_fwd_hm", rec8), ("attention_bwd_hm", rec9)):
        bound_ms, bound_by = bound(rec)
        print(f"  (b) {name} {list(TP_HM_CASE[:4])}: {rec['ms']:.4f} ms, plain "
              f"{rec['plain_ms']:.4f} ms, SDPA {rec['library_ms']:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}); on {smi}")

    csv_dir = write_split_csvs(tmp, range(16), range(16, 24), range(24, 32))
    config = copy.deepcopy(data_config(DOFA))
    config["trainer"].update(max_epochs=1, mesh=dict(TP_MESH),
                             default_root_dir=str(tmp / "tp_fit"))
    config["data"]["init_args"].update(csv_root_folder=str(csv_dir))
    t0 = time.perf_counter()
    res = launch(_tp_rank, (config,), size=2, backend="gloo", timeout_s=DP_GROUP_S,
                 deadline_s=DP_DEADLINE_S)
    print(f"  (a), (c), (d): 2 model ranks sharing the card over gloo, "
          f"{time.perf_counter() - t0:.1f} s")
    check(not worker_processes(), "a rank process is left")
    a = res["dofa"]
    loss_tol, block_gap, all_gap, norm_tol = TP_LIMITS
    want = {k: DP_STEPS * v for k, v in TP_PER_TRAIN_STEP.items()}
    print(f"  (a) DOFA-base 512^2 bf16, global bs {BATCH}, {a['n_sharded']} tensors sharded: "
          f"losses 2 ranks {a['losses']}, 1 rank {a['one_losses']}; step ms (2 ranks sharing "
          f"one card over gloo: correctness only, not scaling) {a['ms']:.2f}, 1 rank "
          f"{a['one_ms']:.2f}; all-reduced a step {a['bytes'] / 2**20:.1f} MiB a rank; "
          f"replicated tensors bit-equal {a['equal']}; launches a rank "
          f"{a['launches']}; on {smi}")
    two, one = a["two_cos"], a["one_cos"]
    short = {k: one[k] - two[k] for k in two}
    print(f"  (a) gradients against the f32 step (1 rank, loss {a['f32_loss']:.6f}): cosines "
          f"2 ranks {two}, 1 rank {one}; norm ratio 2 ranks {a['two_norm']:.6f}, 1 rank "
          f"{a['one_norm']:.6f}; 2 ranks' bf16 gradients against 1 rank's: cosine "
          f"{a['pair_cos']:.6f}; loss difference {abs(a['losses'][0] - a['one_losses'][0]):.3g}")
    check(a["equal"] and a["n_sharded"] == 72, "(a) replicated parameters differ, or not 72 "
          "sharded tensors")
    check(abs(a["losses"][0] - a["one_losses"][0]) <= loss_tol, "(a) loss disagrees with 1 rank")
    check(all(v <= block_gap for k, v in short.items() if k != "all")
          and short["all"] <= all_gap and abs(a["two_norm"] - 1) <= norm_tol,
          "(a) gradients disagree with 1 rank")
    check(all(r == want for r in a["launches"]), f"(a) launches a rank, expected {want}")
    c = res["segformer"]
    print(f"  (c) SegFormer mit_b0 512^2 bf16: loss 2 ranks {c['loss']:.6f}, 1 rank "
          f"{c['one_loss']:.6f}; launches rank 0 {c['launches']}, 1 rank {c['one_launches']}; "
          f"replicated bit-equal {c['equal']}")
    check(c["equal"] and abs(c["loss"] - c["one_loss"]) <= TP_SEG_LOSS,
          "(c) SegFormer disagrees with 1 rank")
    check(c["launches"].get("sr_attention_fwd", 0) > 0, "(c) K10 not launched on local heads")
    d = res["fit"]
    test_config = copy.deepcopy(config)
    test_config["trainer"].pop("mesh")
    test_config["trainer"]["default_root_dir"] = str(tmp / "tp_test")
    tested = run_checked(test_config, "test", ckpt_path=d["best"])
    keys = [k for k in tested if k.startswith("test_")]
    diff = max(abs(tested[k] - d["result"][k]) for k in keys)
    print(f"  (d) fit {TP_MESH}: {d['result']}; one-process test of its best checkpoint "
          f"{tested}: largest difference {diff:.3g} (tolerance {DP_FIT_TOL:g})")
    check(keys and set(keys) <= set(d["result"]) and diff <= DP_FIT_TOL,
          "(d) a one-process test disagrees with the tensor-parallel auto-test")
    counts: dict[str, int] = {}
    for r in a["launches"]:
        for k, v in r.items():
            counts[k] = counts.get(k, 0) + v
    return counts


def data_config(path: ModelPath) -> dict:
    """The path's config reading data/waterloo of this checkout."""
    config = copy.deepcopy(path.config)
    config["data"]["init_args"].update(csv_root_folder=str(DATA), patches_root_folder=str(DATA))
    return config


def main() -> int:
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    if not (ROOT / "geo_deep_learning_tpu_torch").is_dir() or not DATA.is_dir():
        print("chip_smoke: run from the root of a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from geo_deep_learning_tpu_torch.ops.cuda import _lib

    t_start = time.perf_counter()
    with Phase("device"):
        smi = device_phase(torch)
    with Phase("build"):
        _, seconds = _lib.build()
        _lib.library()
        print(f"  nvcc: {seconds:.1f} s (0.0 = up-to-date build reused)")
        report = ptxas_report(_lib.BUILD_LOG.read_text())
        for name, rec in sorted(report.items()):
            print(f"  ptxas {name}: {rec}")
        for name in NO_SPILL:
            check(report.get(name, {}).get("spill_stores") == 0, f"{name} spills or is missing")
            check(not report[name]["notes"], f"{name}: ptxas notes {report[name]['notes']}")
        check(all(name in report for name in LN_MAIN), "a LayerNorm kernel of DOFA's width is missing")
        check(all(name in report for name in PP_INSTANCES), "a preprocess instance is missing")
        for name in F32_INSTANCES:
            check(report.get(name, {}).get("spill_stores") == 0, f"{name} spills or is missing")
        lib = _lib.library()
        for hd in (32, 64, 128):
            fwd = lib.gdl_attention_fwd_f32_smem(hd)
            kv, q = (lib.gdl_attention_bwd_f32_smem(hd, k) for k in (0, 1))
            check(all(0 < n <= 232448 for n in (fwd, kv, q)),
                  f"tf32 attention smem at hd {hd}: {fwd}, {kv}, {q}")
            print(f"  attention_f32 hd {hd}: dynamic shared memory a block, forward {fwd} B, "
                  f"backward dK/dV {kv} B, dQ {q} B")
        for name, rec in report.items():
            check(not name.startswith(("layernorm", "preprocess")) or rec.get("spill_stores") == 0,
                  f"{name} spills")
    with Phase("host readers"):
        host_readers_phase(smi)
    with Phase("kernels"):
        records = kernels_phase(torch)
        for name, rec in records.items():
            bound_ms, bound_by = bound(rec)
            lib = "n/a" if rec["library_ms"] is None else f"{rec['library_ms']:.4f}"
            print(f"  {name}: {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, "
                  f"library {lib} ms, bound {bound_ms:.4f} ms ({bound_by})")
            if "clean_ms" in rec:
                lib_clean = rec.get("library_clean_ms")
                print(f"  {name} clean_ms: {rec['clean_ms']:.4f} ms" + (
                      "" if lib_clean is None else f", library {lib_clean:.4f} ms")
                      + " (L2 cold and clean)")
        for name, (wrapper, lib) in op_host_us(torch).items():
            lib = "n/a" if lib is None else f"{lib:.2f} us"
            print(f"  {name} host_us: {wrapper:.2f} us a call, library {lib} "
                  "(host time, card behind)")
        for path in (*PATHS, DOFA640):
            fwd = sum(path.per_batch[k] * records[k]["ms"] for k in path.per_batch)
            step = sum(path.per_step[k] * records[k]["ms"] for k in path.per_step)
            note = " (K10 at its stage-1 time)" if "sr_attention_fwd" in path.per_batch else ""
            print(f"  {path.label}: kernels per bs-{BATCH} forward {fwd:.3f} ms of device "
                  f"time{note}; per train step {step:.3f} ms")
        functions_phase(torch)
    # launch counts of each owning run: the column phase, each path's fit,
    # and for K8/K9 the DOFA-640 fit with (K8) its scene runs
    launches: dict[str, dict[str, int]] = {}
    with Phase("column"):
        launches[COLUMN] = column_phase(torch, smi)
    with Phase("factored resize + 3x3 conv (neck, UperNet)"):
        factored_phase(torch, smi)
    with Phase("losses"):
        losses_phase(torch)
    for path in PATHS:
        with Phase(f"{path.label} serving path"):
            main_path_phase(torch, smi, path)
        with Phase(f"{path.label} training path"), \
                tempfile.TemporaryDirectory(prefix="gdl_chip_fit_") as tmp:
            config = data_config(path)
            path.train_check(torch, config)
            csv_dir = write_fit_csvs(Path(tmp))
            counts, fit_config, best = fit_phase(torch, smi, Path(tmp), path, csv_dir, DATA)
            launches[path.label] = counts
            if path is DOFA:
                grain_fit_phase(torch, smi, Path(tmp), fit_config, counts, best)
            train_timing(torch, config, smi, Path(tmp), path.label)
            if path is DOFA:
                loader_probe(torch, config, smi, csv_dir)
    with Phase("export (torch.export programs, bs 8, 512^2)"), \
            tempfile.TemporaryDirectory(prefix="gdl_chip_export_") as tmp:
        export_phase(torch, smi, Path(tmp))
    with Phase(RECIPE), tempfile.TemporaryDirectory(prefix="gdl_chip_recipe_") as tmp:
        launches[RECIPE] = recipe_phase(torch, smi, Path(tmp))
    with Phase(MULTI), tempfile.TemporaryDirectory(prefix="gdl_chip_multi_") as tmp:
        launches[MULTI] = multisensor_phase(torch, smi, Path(tmp))
    with Phase(MULTI_CSV), tempfile.TemporaryDirectory(prefix="gdl_chip_rr_") as tmp:
        launches[MULTI_CSV] = multisensor_csv_phase(torch, smi, Path(tmp))
    with Phase(F32), tempfile.TemporaryDirectory(prefix="gdl_chip_f32_") as tmp:
        launches[F32] = f32_phase(torch, smi, Path(tmp))
    with Phase("remat A/B (DOFA-base 512^2, bf16)"):
        remat_phase(torch, smi)
    with Phase(DP), tempfile.TemporaryDirectory(prefix="gdl_chip_dp_") as tmp:
        launches[DP] = dp_phase(torch, smi, Path(tmp))
    with Phase(TP), tempfile.TemporaryDirectory(prefix="gdl_chip_tp_") as tmp:
        launches[TP] = tp_phase(torch, smi, Path(tmp))
    with tempfile.TemporaryDirectory(prefix="gdl_chip_scene_") as tmp:
        with Phase("scene and 640^2 data from the tst split"):
            scene, patches = scene_data(Path(tmp))
        with Phase(f"{DOFA640.label} training and serving path"):
            fit_counts, best640 = dofa640_phase(torch, smi, Path(tmp), patches)
        with Phase("predict-scene"):
            scene_counts = scene_phase(torch, smi, Path(tmp), scene, best640)
    launches[DOFA640.label] = {k: fit_counts.get(k, 0) + scene_counts.get(k, 0)
                               for k in set(fit_counts) | set(scene_counts)}

    owners = {COLUMN: {"packed_conv_bn_stats"}} | {path.label: set(path.per_step) for path in PATHS}
    owners[DOFA640.label] = {"attention_fwd_hm", "attention_bwd_hm"}
    owners[RECIPE] = set(PER_BATCH)
    owners[MULTI] = set(MS_PER_TRAIN_STEP)
    owners[MULTI_CSV] = set(PER_TRAIN_STEP)
    owners[DP] = set(PER_TRAIN_STEP)
    owners[TP] = set(TP_PER_TRAIN_STEP)
    owners[F32] = set(F32_PER_TRAIN_STEP) - set(PER_TRAIN_STEP) | {
        "attention_fwd_hm_f32", "attention_bwd_hm_f32"}
    check(set(records) == set().union(*owners.values()), "missing kernel record")
    for owner, names in owners.items():
        for name in sorted(names):
            check(launches[owner].get(name, 0) > 0,
                  f"{name} was not launched by {owner}, the path that owns it")
    kernels = []
    for name, rec in records.items():
        bound_ms, bound_by = bound(rec)
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": SOURCES[name][0],
            "replaces": SOURCES[name][1],
            "launches": sum(launches[o].get(name, 0) for o, names in owners.items() if name in names),
            "max_abs_err": rec["max_abs_err"],
            "ms": rec["ms"],
            "plain_ms": rec["plain_ms"],
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": rec["library_ms"],
        })
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
