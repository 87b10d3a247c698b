#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``cross_attention_vit_tpu_torch``) on
one NVIDIA H100.

    python3 chip_smoke.py

Phases, each printed as one JSON line with a ``phase`` key:

1. device  — CUDA present, compute capability (9, 0), the card's name and
             power limit; TF32 switched off for matmuls and cuDNN.
2. build   — compiles every kernel of the serving and training paths from
             ``cross_attention_vit_tpu_torch/kernels/csrc/`` with nvcc, one
             process per source (five), all started together; keeps each
             kernel's ptxas registers and spills.
3. kernels — holds each kernel (K1 attention forward, K2 its backward, K3
             the windowed resample, K4 the same over all taps) against its
             plain PyTorch version on the card (normalised max error within
             the stated tolerance) and times kernel, plain version and the
             library call (yardstick only) — device time per call from
             torch.profiler — beside the card's bound.  K1's row statistics
             (m, r) are held against the plain ones; K2 runs on K1's own
             statistics against its plain version given the same ones, and
             two identical K2 calls must agree bit for bit; both at the
             ragged lengths N = 1 ... 1040 (B=2 K=4) in bf16 and f32, and at
             the split paths' bf16 shapes: a TP rank's 8 heads (B=8 and 4,
             N=513) and a PP microbatch of 2 rows (K=16, N=1025).  K1 and
             K2 are timed at B=8 K=16 N=513 and 1025 bf16, the median of five
             profiled windows with their spread, beside
             scaled_dot_product_attention and its autograd backward.  At the
             training shape, K1/K2 and the plain attention are also held
             against an f32 attention, forward and backward.  K3 and K4 must
             equal their plain version bit for bit, at the live geometry (V
             = 8 and 24) and at two shapes with no dim a multiple of 8 or
             32, in bf16 and f32, with no ptxas spill; each live pass is
             timed at V = 8 (bf16 and f32) beside its bound, with its GB/s.
4. kernels_k7 — the same for K7, the streaming attention (forward with
             logsumexp, the dq and dk/dv kernels of its blocked backward: K2's
             kernels reading the lse) at N = 1041, 1537, 2049, 4096, 8192 in
             bf16 and f32; the forward also against its plain version over
             the kernel's own 64-key tiles (``K7_TILE_TOL``, beside the
             512-key error); two backward calls bit for bit; at the 3-stream
             ModelVIT training shape (B=8, K=16, N=1537, bf16) dq, dk, dv
             within ``K7_TRAIN_TOL``; no ptxas spill in a K7 kernel (forward
             and backward, both dtypes); timed at the training shape beside
             scaled_dot_product_attention and its autograd backward.
5. kernels_k5 — the same for K5, the single-block attention of the public
             ``flash_attention`` (forward with its row statistics; dq and
             dk/dv kernels of its recompute-form backward on them: K1's and
             K2's kernels under K5's rounding rule) at N = 100, 513, 1025,
             1040 in bf16 and f32, contiguous and as views of a stacked qkv:
             the statistics against the plain ones, the backward against its
             plain version given the kernel's statistics, two backward calls
             bit for bit, no ptxas spill in a K5 kernel; timed at the
             int8+attn serving shapes (B=8, K=16, N=513 and 1025, bf16), the
             median of five profiled windows, beside
             scaled_dot_product_attention and its autograd backward, and
             held, with the plain path, against an f32 attention.
6. serve   — the full-width live ModelCross (3 streams, hidden 1024, 16
             heads, N = 513, bf16, tanh GELU; 241.9M random parameters from
             a seed) written as a JAX-layout npz checkpoint, served by the
             port's InferenceServer (buckets 1/2/4/8) and asked 6 requests of
             1, 3 and 8 volumes, one over HTTP.  Checks finite logits, the
             server's answers against a direct forward, 12 kernel launches
             per bucket forward, and the kernel path against the plain path;
             times bucket 8 with the weights cast once and with f32 masters
             cast on every call.
7. serve_vit — two full-width ModelVITs (hidden 1024, 16 heads, 4 layers,
             bf16, tanh GELU, random weights from a seed): the live 2-stream
             grid point params_list2[1] (SWI, DWI; N = 1025, 57.7M parameters)
             and the same with DWI, SWI, ASL (N = 1537, 58.3M), each written
             as a JAX-layout npz and served by InferenceServer(model="vit"),
             6 requests.  Checks the answers against a direct forward, 4 K1
             launches per bucket forward (2 streams) or 4 K7-forward and no K1
             launches (3 streams), and the kernel path against the plain path.
8. serve_int8 — the live ModelCross from phase serve's checkpoint served
             under quantize="int8" and "int8+attn" (buckets 1/2/4/8, 6
             requests, one over HTTP): 39 and 63 quantized layers, exactly
             12 K1 (int8) or 12 K5 (int8+attn) launches per bucket forward,
             served logits equal to a direct forward, kernel path vs plain
             path with the same int8 weights; the drift from bf16, weight
             bytes, bucket-8 device ms and idle share of bf16, int8 and
             int8+attn timed in turns, and one FFN GEMM int8 vs bf16.  Then
             both ModelVITs under int8+attn at buckets 1 and 8: 17 quantized
             layers, 4 K5 launches per forward at N = 1025, 4 K7-forward and
             no K5 at N = 1537.
9. train   — the live ModelCross, full width, with f32 master weights, trained
             ``TRAIN_STEPS`` Adam steps at batch 8 with augmentation (bf16
             pipeline) and dropout 0.25 through ``make_train_step``.  Checks
             finite losses, changed parameters, 12 K1 and 12 K2 launches per
             step and 4 K3 launches per step that drew the affine (> 0 over
             the run); then one step at dropout 0 without augmentation on the
             kernel path and the plain path from the seeded f32 masters and
             the same batch (every parameter's gradient within ``SERVE_TOL``,
             normalised by its own maximum), both beside an f32 step; the
             step time by CUDA events, split into augmentation and trunk; one
             profiled step; peak memory.
10. train_vit — both ModelVITs, f32 masters, ``TRAIN_STEPS`` Adam steps at
             batch 8 with params_list2[1]'s dropout 0.1 and augmentation (bf16
             pipeline).  Checks 4 K1 + 4 K2 launches per step (2 streams) or
             4 K7-forward + 4 of each K7 backward kernel and no K1/K2 (3
             streams), K3 over the run, and every parameter's gradient, kernel
             path against plain path, from the seeded masters; step ms, one
             profiled step, peak memory.

11. kernels_k6 — K6, the public ``flash_attention_tn`` on (B, K, D, N)
             operands (forward with its row statistics; dq and dk/dv kernels
             of its backward on them, o recomputed) against its plain
             versions at N = 100, 513, 1025, 1040 in bf16 and f32, as D-minor
             views and as contiguous (B, K, D, N) tensors (which the bf16
             wrapper copies to (B, K, N, D): the times include the copies);
             the public op at N = 1041 routes to K7; timed at B=8 K=16 N=513
             bf16 beside scaled_dot_product_attention and its autograd
             backward.
12. kernels_k8 — K8, the fused QKV-projection backward (K2's attention
             kernels, then dx = dqkv·Wᵀ and dW = xᵀ·dqkv by the hand-written
             wgmma products), against its plain version at B=8 K=16 D=64
             H=1024 and N = 513, 1025 and 100, on K1's row statistics, with W
             as the model's view of the Linear weight and contiguous; two
             identical calls must agree bit for bit; the two products alone
             on K2's dqkv against their plain version (``K8_PRODUCT_TOL``),
             beside cuBLAS's; no ptxas spill in a product kernel; timed, dq,
             dk/dv, dx and dW apart, beside the unfused route (K2 and two
             cuBLAS GEMMs), the same two GEMMs on the same dqkv (the
             products' yardstick), and SDPA's autograd backward and the
             GEMMs.
             Phase train also runs its comparison step with
             ``FUSED_QKV_GRADS`` on: 12 K8 calls, no K2, every gradient
             within ``SERVE_TOL`` of the plain path's.
13. train_cli — a synthetic cohort of 16 subjects (DWI, SWI, ASL at
             240×240×155 int16, written as NIfTI) and a labels CSV with one
             blacklisted and one indeterminate row; the port's
             ``experiments.main`` trains the full-width live ModelCross
             (grid point 0, seed 2004, batch 8, bf16, flash attention,
             ``FUSED_QKV_GRADS`` on) one epoch, then again to two epochs,
             resuming from the rolling checkpoint; ``evaluate.main`` on the
             best checkpoint against a direct forward.  Checks the history,
             the resume, 12 K8 calls per step and no K2, the files; reports
             the decoder, the transfer dtype and the checkpoint-write time.

14. train_dp — run right after train: the live ModelCross through the port's
             ``Trainer(mesh=make_mesh(1))`` (``cross_attention_vit_tpu_torch.
             parallel``).  (a) World size 1 over NCCL in this process: with
             no mesh, under DDP and under FSDP (FSDP2, whole-tensor shards at
             one rank), ``TRAIN_STEPS`` steps with augmentation and dropout
             0.25 each — finite losses, changed parameters, 12 K1 + 12 K2
             launches a step, K3 over the run, step ms and peak memory — then
             one step at dropout 0 without augmentation from the seeded
             masters: every gradient of DDP and of FSDP within ``SERVE_TOL``
             of the no-mesh step's, normalised by its own maximum.  (b) Two
             gloo ranks sharing the card (this script with ``--dp-worker``),
             DDP at batch 4 each, ``DP_STEPS`` steps: parameters bit for bit
             the same on both ranks, the first step's gradients within
             ``SERVE_TOL`` of the one-process batch-8 step's, the step ms and
             the share of it in the gradient all-reduce (steps with and
             without it, in turns).  NCCL between two ranks needs two cards.
15. train_moe — the live ModelCross with ``moe_experts = 4`` (the other MoE
             keys at JAX's defaults: top-2, capacity factor 1.25, balance
             weight 0.01; 12 MoE sites, 544,168,966 parameters), f32
             masters, no mesh: ``TRAIN_STEPS`` steps at batch 8 with
             augmentation and dropout 0.25 — finite losses, 12 K1 + 12 K2
             launches a step and K3 over the run; one train-mode forward
             whose loss less its cross-entropy is 0.01 × the sites' mean
             balance loss; the sites' dispatch fractions; every gradient,
             kernel path against plain path at f32, within
             ``KERNEL_TOL[float32]`` (the bf16 kernel path reported beside
             the f32 plain path: top-2 routing flips near-tie tokens on
             last-bit differences); step ms, the MoE's f32 GEMMs' share of
             the profiled step's device time, peak memory; a bucket-8
             forward through InferenceServer equal to a direct forward (12
             K1 launches); then two gloo ranks sharing the card over (data
             1, expert 2), 2 experts of every site each (``chip_smoke.py
             --moe-worker``): one step's gradients equal to the one-process
             step's bit for bit, 12 K1 + 12 K2, equal losses.
16. ring    — the ring attention (``parallel.ring``) forced at one rank
             against the dense plain attention (``_sdpa``) at B=8 K=16 D=64
             N = 513 and 1537, bf16 and f32, forward and gradients
             (``KERNEL_TOL``, normalised); then the live ModelCross with
             ``seq_parallel = 2`` and no seq mesh trained ``TRAIN_STEPS``
             steps beside the same model with ``use_flash_attention=False``
             from the same masters and generator: losses and parameters bit
             for bit equal (JAX's fallback to the dense attention), no K1 or
             K2 launch, K3 over the run.
17. train_tp, serve_tp, train_pp — tensor and pipeline parallelism over two
             gloo ranks sharing the card (``chip_smoke.py --split-worker``;
             NCCL refuses two ranks on one card), against one-process
             references taken first.  train_tp: the live ModelCross over
             (model 2), 8 of the 16 heads a rank: one f32 step with dropout
             and augmentation — loss within ``LOSS_REL_TOL`` (1e-5, JAX's
             rel) relative, gradients gathered to the whole layout within
             ``KERNEL_TOL[float32]`` — then ``TP_STEPS`` bf16 steps: 12 K1 +
             12 K2 a step per rank, all at B=8 K=8, the first loss within
             ``TP_BF16_LOSS_REL_TOL`` (5e-3) relative of one process's; step ms and peak memory a rank
             (gloo's host round trips, not a speed figure).  serve_tp: the
             same weights through ``InferenceServer(mesh=)``, rank 0 asked 3
             and 8 volumes, the other rank in ``run_worker``: served logits
             within ``SERVE_TOL`` of a direct one-process forward, 12 K1 a
             forward per rank at K=8.  train_pp: the 2-stream ModelVIT with
             ``pipeline_stages`` 2 and ``PIPE_MB`` microbatches of 2 rows: the
             serial schedule against the plain trunk (f32, dropout 0: loss
             within 1e-5 relative, gradients within ``KERNEL_TOL[float32]``,
             16 K1 + 16 K2 at B=2), then over (pipe 2) against the serial
             schedule (f32 with dropout and augmentation, the same gates)
             and ``PP_STEPS`` bf16 steps: 8 K1 + 8 K2 a step per rank at B=2
             (2 layers × 4 microbatches); the bubble fraction.
18. train_tp_ep — the axes composed: the MoE ModelCross (``moe_experts`` 4,
             544,168,966 parameters, f32 at dropout 0) over four gloo ranks
             sharing the card, (expert 2 × model 2), each rank 8 of the 16
             heads and 2 of the 4 experts of every site (``chip_smoke.py
             --tp-ep-worker``): one step's loss within ``LOSS_REL_TOL`` and
             gradients within ``KERNEL_TOL[float32]`` of one process's, loss
             − CE = 0.01 × the mean balance within ``BALANCE_TOL``, 12 K1 +
             12 K2 at B=8 K=8; then ``InferenceServer(mesh=)`` on the same
             weights, rank 0 asked 3 and 8 volumes: within ``SERVE_TOL`` of
             a direct one-process forward, 12 K1 a forward per rank.
19. train_sync_bn — ViT3D at train_vit3d's width (CNN3DEncoder 128/256/512/
             1024, hidden 1024, 16 heads, 4 layers, 257 tokens, T1c; f32,
             dropout 0) over two gloo ranks sharing the card, (data 2), 4
             volumes a rank (``chip_smoke.py --bn-worker``), against one
             process at batch 8: the running means and variances after each
             of ``BN_STEPS`` steps within ``BN_STAT_REL_TOL`` (1e-5) relative
             (the global batch's statistics, one all-reduce a BatchNorm),
             the first step's gradients within ``BN_NOISE_FACTOR`` × each
             leaf's spread over the same one-process step on the batch's rows
             in other orders (``BN_REORDERS``), never looser than
             ``KERNEL_TOL[float32]`` (the stem's conv biases, zero in exact
             arithmetic, reported), both ranks' buffers bit-equal.
20. legacy_vit3d — ``drivers.legacy.train_vit3d`` at its own configuration
             (ViT3D: CNN3DEncoder 128/256/512/1024 channels, hidden 1024, 16
             heads, 4 layers, 128×128×64, T1c, dropout 0.1, plateau; 257
             tokens) over 16 synthetic T1c subjects at batch 8: one epoch,
             then a fresh stateful Trainer resumes from the driver's
             checkpoint and trains the second.  Checks the history, that it
             restores the saved ``model_state`` and plateau exactly, that the eval step equals a
             direct eval forward and moves no BatchNorm buffer while train
             steps move all 8, the step ms, peak memory and one profiled
             step; and that conv3d keeps TF32 off whatever the process-wide
             cuDNN flag says (forward bit for bit, both gradients within
             ``TF32_GRAD_TOL``); and at each stem shape of ``CONV_SHAPES``
             that its three products stay within ``CONV_F64_TOL`` of f64,
             each timed beside cuDNN's own.
21. legacy_densenet — ViT3D with the DenseNet-121 stem truncated at
             denseblock3.denselayer24.layers.conv1 (hidden 64, 4 heads, one
             modality, batch 8): the stem emits (8, 64, 8, 8, 4); train steps
             and an eval forward, finite.
22. legacy_cnn_vit — CNNViT at its defaults on 2 modalities, batch 8:
             forward, BCE and Adam steps; every parameter moves.
23. legacy_rsna — ``train_rsna`` at rsna_config's full width (ModelVIT
             hidden 512, 4 layers, 8 heads, (32, 32, 32) patches over
             256×256×64; bf16 and flash attention) on 8 synthetic DICOM
             series of 64-78 slices written by the port's ``write_dicom``: 1
             epoch at batch 4 and ``predict``.  K1 and K2 run at B=4 K=8
             N=129, and at B=2 for the short last batch and the validation
             batch (phase kernels holds both shapes in bf16 and f32 and
             times B=4; the phase fails if the run gives another): 4 of
             each a step, 4 K1 a validation batch for eval and
             for predict; finite history, predictions in [0, 1]; one step
             under ``utils.profiling.profile_trace``, whose Chrome trace must
             hold K1 and K2.
24. convert_cli — a Lightning container (``{"state_dict": {"model." +
             name: tensor}}``) of the full-width live ModelCross through
             ``drivers.convert`` to an npz; ``evaluate.main`` on it over 4
             synthetic subjects equals a direct forward (and the npz's logits
             the source model's exactly); ``--export`` returns the state dict
             bit for bit.

Then a line ``{"phase": "profiler", ...}``: the profiles taken, how many of
them recorded no kernel, and the calls timed by CUDA events after
``PROFILE_TRIES`` such profiles (``device_ms_split``).  Then one line
``{"kernels": [...]}`` with each kernel's launches on the
serving and training runs and its timings, the card's name and power limit as
nvidia-smi prints them, and last ``{"ok": true, "device": {...}}``.  Any
failure exits non-zero before the result lines are printed; without CUDA it
exits 1.
"""

from __future__ import annotations

import contextlib
import gc
import hashlib
import io
import itertools
import json
import re
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from cross_attention_vit_tpu_torch.configs import (Params, get_mgmt_config,
                                                   get_mgmt_cross_config, modify_config)
from cross_attention_vit_tpu_torch.data import augment, native
from cross_attention_vit_tpu_torch.data.nifti import write_volume
from cross_attention_vit_tpu_torch.drivers import evaluate, experiments
from cross_attention_vit_tpu_torch.drivers.serve import InferenceServer, serve
from cross_attention_vit_tpu_torch.kernels import _build
from cross_attention_vit_tpu_torch.kernels import flash_attention as fa
from cross_attention_vit_tpu_torch.kernels import resample as rs
from cross_attention_vit_tpu_torch.models.convert import jax_params_from_model
from cross_attention_vit_tpu_torch.models.model_cross import ModelCross
from cross_attention_vit_tpu_torch.models.model_vit import ModelVIT
from cross_attention_vit_tpu_torch.models.quantize import count_quantized
from cross_attention_vit_tpu_torch.ops.attention import _sdpa
from cross_attention_vit_tpu_torch.ops.layers import linear
from cross_attention_vit_tpu_torch.ops.quant import (QuantLinear, dynamic_quantize, qlinear,
                                                     quantize_weight)
from cross_attention_vit_tpu_torch.models.convert import jax_params_from_state_dict, params_from_flat
from cross_attention_vit_tpu_torch.ops.losses import cross_entropy
from cross_attention_vit_tpu_torch.parallel.moe import expert_capacity, local_experts, moe_sites
from cross_attention_vit_tpu_torch.parallel.ring import ring_attention
from cross_attention_vit_tpu_torch.train import checkpoint as ckpt
from cross_attention_vit_tpu_torch.train.checkpoint import save_config, save_pytree
from cross_attention_vit_tpu_torch.train.metrics import binary_auroc, compute_metrics
from cross_attention_vit_tpu_torch.train.optim import Adam
from cross_attention_vit_tpu_torch.train.schedule import cosine_annealing_lr
from cross_attention_vit_tpu_torch.parallel import (bubble_fraction, full_tensor, make_mesh,
                                                    multihost_init, shard_batch, unwrap,
                                                    whole_tensors)
from cross_attention_vit_tpu_torch.train.trainer import Trainer, make_train_step
from torch.distributed.tensor import DTensor

ROOT = Path(__file__).resolve().parent
MODALITIES = ("DWI", "SWI", "ASL")
LIVE_PARAMS = 241.9e6
# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and FLOP/s by type.
# f32 is the CUDA-core rate: the f32 kernels must not use TF32.
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
F32_CUDA_CORE_FLOPS = 67e12
# kernel vs plain, normalised by max |plain| (tests_tpu/test_kernels_onchip.py:61,189)
KERNEL_TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-4}
# K1's row statistics against the plain ones, both f32 in either dtype: m by
# max |m|, r relative.  They differ by the summation order of q·kᵀ and exp2
# against exp; the f32 kernel tolerance bounds both
STATS_TOL = KERNEL_TOL[torch.float32]
# K1/K2 at B=2 K=4: the ragged tails around the 16-key steps and 64-row tiles
RAGGED_NS = (1, 16, 17, 64, 65, 100, 513, 1025, 1040)
# the legacy RSNA driver's attention (rsna_config, bf16 + flash): B=4 K=8,
# N = 8·8·2 + 1 = 129 (two 64-row query tiles and one row, eight 16-key
# steps and one key), checked in both dtypes and timed in bf16
RSNA_ATTN = (4, 8, 129)
# every (B, K, N) the legacy_rsna phase gives K1 and K2: 6 training cases at
# batch 4 leave a last batch of 2, and the 2 validation cases are one batch
# of 2 (eval and predict); each checked in both dtypes
RSNA_ATTN_SHAPES = (RSNA_ATTN, (2, 8, 129))
# profiled windows whose median times K1 and K2 (the spread is printed)
TIMING_WINDOWS = 5
# flash-path vs plain-path logits at bucket 8, normalised by max |plain|.  Both
# paths are bf16 end to end and share every GEMM; they differ only in where
# the 12 attention layers round (the kernel casts e = exp(s - m) to bf16 and
# normalises after AV, the plain path normalises, then casts).  One bf16
# rounding is 2^-8 = 3.9e-3 relative; 5e-2 allows about a dozen such steps
# compounded through the residual stream.
SERVE_TOL = 5e-2
REQUEST_SIZES = (1, 3, 8, 1, 3, 8)
LIBRARIES = ("flash_attention_fwd", "flash_attention_bwd", "resample",
             "flash_attention_stream", "fused_qkv_bwd")
K1 = {"name": "flash_attention_qkv", "route": "cuda",
      "source": "cross_attention_vit_tpu_torch/kernels/csrc/flash_attention_fwd.cu",
      "replaces": "cross_attention_vit_tpu/kernels/flash_attention.py:759"}
K2 = {"name": "flash_attention_qkv_bwd", "route": "cuda",
      "source": "cross_attention_vit_tpu_torch/kernels/csrc/flash_attention_bwd.cu",
      "replaces": "cross_attention_vit_tpu/kernels/flash_attention.py:768"}
K3 = {"name": "resample_axis_windowed (span)", "route": "cuda",
      "source": "cross_attention_vit_tpu_torch/kernels/csrc/resample.cu",
      "replaces": "cross_attention_vit_tpu/kernels/resample.py:90"}
K4 = {"name": "resample_axis_windowed (all taps)", "route": "cuda",
      "source": "cross_attention_vit_tpu_torch/kernels/csrc/resample.cu",
      "replaces": "cross_attention_vit_tpu/kernels/resample.py:36"}
K5F = {"name": "flash_attention_single_fwd", "route": "cuda",
       "source": "cross_attention_vit_tpu_torch/kernels/csrc/flash_attention_fwd.cu",
       "replaces": "cross_attention_vit_tpu/kernels/flash_attention.py:109"}
K5B = {"name": "flash_attention_single_bwd (dq and dk/dv kernels)", "route": "cuda",
       "source": "cross_attention_vit_tpu_torch/kernels/csrc/flash_attention_bwd.cu",
       "replaces": "cross_attention_vit_tpu/kernels/flash_attention.py:280"}
K7F = {"name": "flash_attention_stream_fwd", "route": "cuda",
       "source": "cross_attention_vit_tpu_torch/kernels/csrc/flash_attention_stream.cu",
       "replaces": "cross_attention_vit_tpu/kernels/flash_attention.py:133"}
K7DKV = {"name": "flash_attention_stream_bwd (dk/dv)", "route": "cuda",
         "source": "cross_attention_vit_tpu_torch/kernels/csrc/flash_attention_bwd.cu",
         "replaces": "cross_attention_vit_tpu/kernels/flash_attention.py:379"}
K7DQ = {"name": "flash_attention_stream_bwd (dq)", "route": "cuda",
        "source": "cross_attention_vit_tpu_torch/kernels/csrc/flash_attention_bwd.cu",
        "replaces": "cross_attention_vit_tpu/kernels/flash_attention.py:429"}
K6F = {"name": "flash_attention_tn_fwd", "route": "cuda",
       "source": "cross_attention_vit_tpu_torch/kernels/csrc/flash_attention_fwd.cu",
       "replaces": "cross_attention_vit_tpu/kernels/flash_attention.py:587"}
K6B = {"name": "flash_attention_tn_bwd (dq and dk/dv kernels)", "route": "cuda",
       "source": "cross_attention_vit_tpu_torch/kernels/csrc/flash_attention_bwd.cu",
       "replaces": "cross_attention_vit_tpu/kernels/flash_attention.py:618"}
K8 = {"name": "fused_qkv_bwd (dq, dk/dv, dx and dW kernels)", "route": "cuda",
      "source": "cross_attention_vit_tpu_torch/kernels/csrc/fused_qkv_bwd.cu",
      "replaces": "cross_attention_vit_tpu/kernels/flash_attention.py:879"}
# K6's lengths (those of K5) at B=2 K=4, and its timed shape (B, K, N)
K6_NS = (100, 513, 1025, 1040)
K6_TIMED = (8, 16, 513)
# K8's shapes (B, N) at K=16 D=64 H=1024: the live ModelCross, the 2-stream
# ModelVIT and a ragged one
K8_SHAPES = ((8, 513), (8, 1025), (8, 100))
# K8's two products alone on K2's dqkv against their plain version (f32
# products of the same bf16 operands): dW (f32) normalised by max |dW|, and dx
# (bf16) in bf16 ulps, element-wise (``_bf16_ulps``)
K8_PRODUCT_TOL = {"dW_norm_err": 1e-5, "dx_max_ulps": 1.0}
# train_cli: the synthetic cohort (subjects, raw volume size) and the room
# its checkpoints need: four full-state npz files of ~2.9 GB
CLI_SUBJECTS = 16
RAW_VOLUME = (240, 240, 155)
CLI_DISK_BYTES = 14e9
# K7's streaming-regime lengths (tests_tpu/test_kernels_onchip.py:42, with
# 1537 and 8192, the length the JAX streaming kernel was sized for), checked
# at B=2 K=4, and the 3-stream ModelVIT training shape (B, K, N)
K7_NS = (1041, 1537, 2049, 4096, 8192)
# the key-tile width of K7's forward kernel
BK7 = 64
K7_TRAIN = (8, 16, 1537)
# K7's gates beside KERNEL_TOL, set from readings on an NVIDIA H100 80GB
# HBM3 (700 W) with a margin of about 2x.  The forward's out and lse against
# the plain version over the kernel's own 64-key tiles, which rounds p with
# the kernel's running max, normalised: largest reading over K7_NS and the
# training shape 2.96e-3 in bf16 (out, N = 2049; 1.81e-3 at the training
# shape), 4.06e-6 in f32 (out, N = 8192).  dq, dk, dv at the training shape
# against their plain version, normalised: 1.46e-3, 1.14e-3, 1.81e-3
K7_TILE_TOL = {torch.bfloat16: 6e-3, torch.float32: 1e-5}
K7_TRAIN_TOL = {"dq": 3e-3, "dk": 2.5e-3, "dv": 4e-3}
# K5's lengths: ragged, the single-block shapes of tests_tpu/test_kernels_onchip.py:42
# and the switch's edge, checked at B=2 K=4; its serving shapes (B, K, N):
# ModelCross int8+attn and the 2-stream ModelVIT
K5_NS = (100, 513, 1025, 1040)
K5_SERVE = ((8, 16, 513), (8, 16, 1025))
# K5's kernels, each in bf16 and f32 (their profiler names hold these)
K5_KERNELS = ("attn_single_fwd", "attn_single_bwd_dq", "attn_single_bwd_dkdv")
# ptxas -v of the last build: {kernel's mangled name: {"registers", "spill_stores",
# "spill_loads"}}
PTXAS: dict[str, dict] = {}
# quantized layers of the live ModelCross (JAX count_quantized: 2 multi × 3
# streams × 2 self blocks, 3 cross pairs, 3 heads) and of a 4-layer ModelVIT
QUANTIZED = {"int8": 39, "int8+attn": 63}
VIT_QUANTIZED = 17
# one FFN GEMM of the ModelCross bucket-8 forward: (8·513, 1024) × (1024, 4096)
FFN_GEMM = (8 * 513, 1024, 4096)
# ModelVIT: (name, streams, parameters, tokens) — params_list2[1]'s streams
# (drivers/experiments.py:50-57) and the three of the live ModelCross
VIT_CONFIGS = (("vit2", ("SWI", "DWI"), 57_730_050, 1025),
               ("vit3", ("DWI", "SWI", "ASL"), 58_254_338, 1537))
# the live augmentation geometry and its four LU passes (data/augment.py)
VOLUME = (128, 128, 64)
AUG = augment.AugmentConfig()
# (V, volume shape) of the resample checks whose dims are not multiples of 8
# or 32, with their own LU windows and spans
RESAMPLE_UNALIGNED = ((3, (40, 24, 20)), (1, (48, 36, 60)))
TRAIN_STEPS = 6
# phase train_dp: the gloo ranks' checked steps, and the seconds a
# collective (and the rendezvous) may wait for a peer
DP_STEPS = 2
DP_TIMEOUT_S = 300
# device_ms_split: profiles tried before CUDA events time the call, and the
# count of profiles taken, of those that recorded no kernel, and of the calls
# timed by events
PROFILE_TRIES = 6
PROFILER_LOG = {"sessions": 0, "empty": 0, "event_timed": 0}
# profiler kernel names → the layers of PERF.md §3 (first match wins)
PROFILE_LAYERS = (("K5 attention forward", ("attn_single_fwd",)),
                  ("K5 attention backward", ("attn_single_bwd",)),
                  ("K7 attention forward", ("attn_stream_fwd",)),
                  ("K7 attention backward", ("attn_stream_bwd",)),
                  ("K1 attention forward", ("attn_fwd_qkv",)),
                  ("K2/K6/K8 attention backward", ("attn_bwd_",)),
                  ("K8 dx/dW products", ("qkv_grad_d",)),
                  ("K3/K4 resample", ("resample_kernel",)),
                  ("convolution (cuDNN)", ("fprop", "dgrad", "wgrad", "convolve", "cudnn",
                                           "conv2d", "conv3d")),
                  ("GEMM (cuBLAS)", ("nvjet", "gemm", "cutlass", "sm90_xmma", "imma")),
                  ("BatchNorm", ("batch_norm", "bn_fw", "bn_bw")),
                  ("pooling", ("pool",)),
                  ("Adam (fused)", ("multi_tensor_apply",)),
                  ("LayerNorm", ("layer_norm",)),
                  ("softmax", ("softmax",)),
                  ("dropout masks (random)", ("distribution", "philox")),
                  ("copies, casts, elementwise", ("copy", "elementwise", "Cat", "where",
                                                  "index", "reduce")))
TRAIN_SEED = 3          # host generator seed: at least one step draws the affine
# parameter-name parts followed by a block or stream index
_INDEXED = {"transformer", "blocks", "fusion", "norm", "mlp_head", "layers"}
# the cross-attention key bias adds q·b to a whole row of scores, which the
# softmax cancels: its gradient is zero in exact arithmetic, so its own
# maximum is rounding noise and cannot normalise it (the gate skips it)
ZERO_GRAD_LEAF = ".attn.fn.wk.bias"
# ModelVIT's classifier bias: for two classes its gradient is ±Σ_b (p_b − y_b)/B,
# with balanced labels at near-chance logits a difference of near-equal class
# sums, so its own maximum is not the scale of its summands; the gate
# normalises it by the largest summand, max_b |p_b − y_b| / B of the plain step
HEAD_BIAS = "mlp_head.4.bias"


class SmokeFailure(RuntimeError):
    pass


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def cuda_ms(fn, runs: int = 20, calls: int = 10, warmup: int = 3) -> float:
    """ms per call: median over `runs` CUDA-event timings of `calls`
    back-to-back calls each (L2 warm).  Back to back, the host enqueues the
    next call while the card runs this one, so host overhead shows only
    where it exceeds the device time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def _kernel_rows(prof) -> list[tuple[str, float, int]]:
    """(name, device ms, calls) of every kernel a profile saw, user
    annotations (ranges such as ``Optimizer.step``) left out."""
    events = prof.key_averages()
    # an annotated range appears twice: as a CPU event and, with the device
    # time it spans, under the same name as a CUDA event
    cpu_names = {ev.key for ev in events if ev.device_type == torch.autograd.DeviceType.CPU}
    rows = []
    for ev in events:
        if getattr(ev, "is_user_annotation", False) or ev.key in cpu_names:
            continue
        t = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)
        if t and ev.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((ev.key, t / 1e3, ev.count))
    return rows


def device_ms(fn, calls: int = 10, warmup: int = 3) -> float:
    """ms of device time per call: the kernels' own durations under
    torch.profiler, summed over ``calls`` back-to-back calls.  Unlike
    ``cuda_ms`` it leaves out the host's dispatch gaps, which exceed the
    device time of a short kernel on a slow host."""
    return device_ms_split(fn, {"all": ""}, calls, warmup)["all"]


def device_ms_split(fn, marks: dict[str, str], calls: int = 10, warmup: int = 3) -> dict:
    """``device_ms`` split by kernel: for each label, the kernels whose names
    hold its mark (for a call that launches more than one kernel).

    A profile now and then records no kernel at all, and a process can stay
    so for many profiles in a row.  After ``PROFILE_TRIES`` empty profiles
    (alternately of the device alone and of host and device) CUDA events
    time the call whole (``cuda_ms``): a single label gets that time; with
    more, every label gets None and ``whole_ms`` the time (see ``part_ms``).
    ``PROFILER_LOG`` counts both, for phase ``profiler``."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for attempt in range(PROFILE_TRIES):
        activities = [ProfilerActivity.CUDA] + [ProfilerActivity.CPU] * (attempt % 2)
        with profile(activities=activities) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        PROFILER_LOG["sessions"] += 1
        rows = _kernel_rows(prof)
        split = {label: sum(ms for key, ms, _ in rows if mark in key) / calls
                 for label, mark in marks.items()}
        if all(ms > 0 for ms in split.values()):
            return split
        PROFILER_LOG["empty"] += 1
        time.sleep(0.2)
    PROFILER_LOG["event_timed"] += 1
    whole = cuda_ms(fn, runs=5, calls=calls, warmup=0)
    if len(marks) == 1:
        return {label: whole for label in marks}
    return {**{label: None for label in marks}, "whole_ms": whole}


def part_ms(split: dict, label: str) -> dict:
    """``ms`` of one label of ``device_ms_split``, or, where the profiler
    recorded no kernel, the whole call's time with a note saying so."""
    if split[label] is not None:
        return {"ms": split[label]}
    return {"ms": split["whole_ms"],
            "ms_note": "the whole call by CUDA events: the profiler recorded no kernel"}


def timings(entry: dict, kernel, plain, library=None, windows: int = 1) -> None:
    """Device time per call (``*_ms``, ``device_ms``) of the kernel, its
    plain version and the library call.  With ``windows`` > 1 the kernel and
    the library call are each the median of that many profiled windows, and
    ``*_ms_spread`` gives the windows' (min, max)."""
    for name, fn, heavy in (("kernel", kernel, False), ("plain", plain, True),
                            ("library", library, False)):
        if fn is None:
            continue
        reps = 1 if heavy else windows
        got = [device_ms(fn, calls=2 if heavy else 10) for _ in range(reps)]
        entry[f"{name}_ms"] = statistics.median(got)
        if reps > 1:
            entry[f"{name}_ms_spread"] = [min(got), max(got)]


def attention_bound(B: int, N: int, K: int, D: int, dtype: torch.dtype) -> tuple[float, str]:
    """Least time in ms for one launch: read qkv once, write out once; the
    4·B·K·N²·D FLOPs of the two products at the dtype's peak."""
    nbytes = 4 * B * N * K * D * torch.empty((), dtype=dtype).element_size()
    t_bytes = nbytes / HBM_BYTES_S
    t_ops = 4 * B * K * N * N * D / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def phase_device() -> dict:
    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is False: chip_smoke needs an H100")
    cap = torch.cuda.get_device_capability(0)
    check(cap == (9, 0), f"compute capability {cap}, expected (9, 0) (Hopper)")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    info = {"phase": "device", "name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "capability": list(cap),
            "nvidia_smi": smi_line, "tf32_matmul": torch.backends.cuda.matmul.allow_tf32,
            "tf32_cudnn": torch.backends.cudnn.allow_tf32,
            "torch": torch.__version__, "cuda": torch.version.cuda}
    emit(info)
    return info


def ptxas_by_kernel(report: str) -> dict[str, dict]:
    """Each entry function's registers and spill bytes from a ``ptxas -v``
    report (its "Compiling entry function", "Function properties" and "Used
    ... registers" lines)."""
    kernels, name = {}, None
    for ln in report.splitlines():
        if m := re.search(r"(?:Compiling entry function|Function properties for) '?([\w.$]+)", ln):
            name = m.group(1)
            kernels.setdefault(name, {})
        elif name and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)):
            kernels[name].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        elif name and (m := re.search(r"Used (\d+) registers", ln)):
            kernels[name]["registers"] = int(m.group(1))
    return kernels


def phase_build() -> None:
    """Every kernel library from source, one nvcc process per source, all
    started together."""
    with ThreadPoolExecutor(len(LIBRARIES)) as pool:
        built = list(pool.map(lambda name: _build.build(name, force=True), LIBRARIES))
    for name, (lib, seconds, report) in zip(LIBRARIES, built):
        print(report, file=sys.stderr, flush=True)     # ptxas -v: registers, smem, spills
        PTXAS.update(ptxas_by_kernel(report))
        emit({"phase": "build", "kernel": name,
              "library": str(lib.relative_to(ROOT)), "nvcc_s": seconds,
              "ptxas": [ln.strip() for ln in report.splitlines()
                        if "registers" in ln or "spill" in ln]})


def attention_bwd_bound(B: int, N: int, K: int, D: int, dtype: torch.dtype) -> tuple[float, str]:
    """Least time in ms for one K2 call: read qkv, o and do once, write dqkv
    once (8 tensors of B·N·K·D); the 10·B·K·N²·D FLOPs of its five products
    (s recomputed, dv, dp, dq, dk) at the dtype's peak."""
    nbytes = 8 * B * N * K * D * torch.empty((), dtype=dtype).element_size()
    t_bytes = nbytes / HBM_BYTES_S
    t_ops = 10 * B * K * N * N * D / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


# f32 operations per output voxel of the resample kernel: rel (5), and for
# each of the two taps with a nonzero hat weight 1 − |rel − d| (3), the max,
# the product and the sum (3); every other tap of the window has weight 0
RESAMPLE_OPS = 5 + 2 * 6


def resample_bound(V: int, dtype: torch.dtype) -> tuple[float, str]:
    """Least time in ms for one resample pass over V live volumes: read each
    voxel once and write it once; RESAMPLE_OPS f32 operations per voxel at
    the CUDA-core f32 rate."""
    voxels = V * VOLUME[0] * VOLUME[1] * VOLUME[2]
    t_bytes = 2 * voxels * torch.empty((), dtype=dtype).element_size() / HBM_BYTES_S
    t_ops = RESAMPLE_OPS * voxels / F32_CUDA_CORE_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _stats_err(got: torch.Tensor, want: torch.Tensor) -> dict:
    """K1's row statistics (2, B, K, N) against the plain ones: m's max error
    normalised by max |m|, r's max relative error."""
    m = _norm_err(got[0], want[0])[1]
    r = ((got[1] - want[1]).abs() / want[1].abs()).max().item()
    return {"m": m, "r": r}


def phase_kernels() -> dict:
    """K1 against its plain version, output and row statistics; returns the
    timed entries by N (B=8 K=16 bf16: 513, the serving bucket 8, and 1025,
    the 2-stream ModelVIT; B=4 K=8 bf16: 129, the legacy RSNA driver)."""
    D = 64
    # (B, K, N, dtype, strided): the serving buckets 1/2/4/8 at N = 513 in
    # bf16; strided reads qkv through a (B, 3, K, N, D) buffer permuted to
    # (B, N, 3, K, D) — the f32 path takes any strides; N = 1041 routes to
    # K7; the split paths' shapes: a TP rank's 8 heads (train_tp and
    # serve_tp's buckets 8 and 4; in f32 the comparison steps of train_tp and
    # train_tp_ep and serve_tp_ep's buckets 8 and 4) and a PP microbatch of 2
    # rows at N = 1025 (train_pp); then the ragged lengths at B=2 K=4 in both
    # dtypes
    cases = [(1, 16, 513, torch.bfloat16, False), (2, 16, 513, torch.bfloat16, False),
             (4, 16, 513, torch.bfloat16, False), (8, 16, 513, torch.bfloat16, False),
             (1, 16, 513, torch.float32, False), (8, 16, 513, torch.float32, False),
             (1, 16, 513, torch.float32, True), (8, 16, 1025, torch.bfloat16, False),
             (8, 16, 1041, torch.bfloat16, False), (8, 8, 513, torch.bfloat16, False),
             (4, 8, 513, torch.bfloat16, False), (2, 16, 1025, torch.bfloat16, False),
             (8, 8, 513, torch.float32, False), (4, 8, 513, torch.float32, False)]
    cases += [(2, 4, N, dt, False) for dt in (torch.bfloat16, torch.float32) for N in RAGGED_NS]
    cases += [(*shape, dt, False) for shape in RSNA_ATTN_SHAPES
              for dt in (torch.bfloat16, torch.float32)]
    checks, failures, timed = [], [], {}
    for i, (B, K, N, dtype, strided) in enumerate(cases):
        g = torch.Generator(device="cuda").manual_seed(100 + i)
        if strided:
            qkv = torch.randn((B, 3, K, N, D), generator=g, device="cuda").to(dtype)
            qkv = qkv.permute(0, 3, 1, 2, 4)
        else:
            qkv = torch.randn((B, N, 3, K, D), generator=g, device="cuda").to(dtype)
        scale = D ** -0.5
        plain = fa.flash_attention_qkv_reference(qkv, scale).float()
        out = fa.flash_attention_qkv(qkv, scale).float()
        torch.cuda.synchronize()
        max_abs = (out - plain).abs().max().item()
        norm_err = max_abs / plain.abs().max().item()
        tol = KERNEL_TOL[dtype]
        entry = {"B": B, "K": K, "D": D, "N": N, "dtype": str(dtype).replace("torch.", ""),
                 "strides": list(qkv.stride()),
                 "max_abs_err": max_abs, "norm_err": norm_err, "tol": tol,
                 "finite": bool(torch.isfinite(out).all())}
        ok = entry["finite"] and norm_err <= tol
        if N <= fa._SINGLE_BLOCK_MAX:
            # the statistics K1 writes for K2, and the output written beside them
            out_s, stats = fa.flash_attention_qkv_fwd(qkv, scale, True)
            _, want = fa.flash_attention_qkv_reference(qkv, scale, True)
            entry["stats_err"] = _stats_err(stats, want)
            entry["out_equal_with_stats"] = bool(torch.equal(out_s.float(), out))
            ok = ok and entry["out_equal_with_stats"] \
                and max(entry["stats_err"].values()) <= STATS_TOL
        if ((B, K) == (8, 16) or (B, K, N) == RSNA_ATTN) and dtype == torch.bfloat16 \
                and N <= fa._SINGLE_BLOCK_MAX:
            q, k, v = (qkv[:, :, j].transpose(1, 2) for j in range(3))
            timings(entry, lambda: fa.flash_attention_qkv(qkv, scale),
                    lambda: fa.flash_attention_qkv_reference(qkv, scale),
                    lambda: F.scaled_dot_product_attention(q, k, v), windows=TIMING_WINDOWS)
            entry["kernel_with_stats_ms"] = device_ms(
                lambda: fa.flash_attention_qkv_fwd(qkv, scale, True))
            bound_ms, bound_by = attention_bound(B, N, K, D, dtype)
            entry["bound_us"] = bound_ms * 1e3
            entry["bound_by"] = bound_by
            timed[N] = entry
        checks.append(entry)
        if not ok:
            failures.append(entry)
    emit({"phase": "kernels", "checks": [{**K1, "cases": checks}]})
    check(not failures, f"kernel disagrees with its plain version: {failures}")
    return timed


def _norm_err(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    max_abs = (got.float() - want.float()).abs().max().item()
    return max_abs, max_abs / max(want.float().abs().max().item(), 1e-30)


def _attention_vs_f32(q, k, v, dout, scale: float, kernel_path) -> dict:
    """How far a kernel path and the model's plain path (autograd through
    ``_sdpa``) each come from an f32 attention on the same bf16 operands
    (autograd through ``_sdpa`` in f32): out and dq, dk, dv, each normalised
    by the f32 maximum.  q, k, v, dout are (B, K, N, D); ``kernel_path()``
    returns (out, (dq, dk, dv)) in the same layout."""
    def plain(dtype):
        xs = [t.to(dtype).contiguous().requires_grad_() for t in (q, k, v)]
        out = _sdpa(*xs, scale)
        return out.detach(), torch.autograd.grad(out, xs, dout.to(dtype))

    ref_out, ref_grads = plain(torch.float32)
    out_k, grads_k = kernel_path()
    out_p, grads_p = plain(q.dtype)
    names = ("dq", "dk", "dv")
    result = {"fwd": {"kernel": _norm_err(out_k, ref_out)[1], "plain": _norm_err(out_p, ref_out)[1]},
              "bwd_kernel": {n: _norm_err(grads_k[j], ref_grads[j])[1] for j, n in enumerate(names)},
              "bwd_plain": {n: _norm_err(grads_p[j], ref_grads[j])[1] for j, n in enumerate(names)}}
    del ref_out, ref_grads, out_p, grads_p
    torch.cuda.empty_cache()
    return result


def _k1k2_path(qkv: torch.Tensor, dout: torch.Tensor, scale: float):
    """K1, then K2 on its output and row statistics, as (B, K, N, D) views
    (dout is (B, N, K, D))."""
    out, stats = fa.flash_attention_qkv_fwd(qkv, scale, True)
    dqkv = fa.flash_attention_qkv_bwd(qkv, out, dout, scale, stats)
    return out.transpose(1, 2), fa._stream_views(dqkv)


def phase_kernels_k2() -> dict:
    """K2, run on K1's own row statistics, against its plain version given the
    same statistics, on dq, dk and dv separately; two identical calls
    compared bit for bit.  Returns the timed entries by N (B=8 K=16 bf16:
    513, the training shape, and 1025; B=4 K=8 bf16: 129, the legacy RSNA
    driver)."""
    D = 64
    # (B, K, N, dtype, strided): the training batch and two smaller ones at
    # N = 513 in bf16; f32 at B = 1 (strided: every operand read through a
    # head-major buffer) and B = 8; bf16 at the longer N of the ViT geometry;
    # the split paths' shapes: a TP rank's 8 heads (train_tp; in f32 the
    # comparison steps of train_tp and train_tp_ep) and a PP microbatch of 2
    # rows at N = 1025 (train_pp); then the ragged lengths at B=2 K=4 in both
    # dtypes
    cases = [(1, 16, 513, torch.bfloat16, False), (2, 16, 513, torch.bfloat16, False),
             (8, 16, 513, torch.bfloat16, False), (1, 16, 513, torch.float32, True),
             (8, 16, 513, torch.float32, False), (8, 16, 1025, torch.bfloat16, False),
             (8, 8, 513, torch.bfloat16, False), (2, 16, 1025, torch.bfloat16, False),
             (8, 8, 513, torch.float32, False)]
    cases += [(2, 4, N, dt, False) for dt in (torch.bfloat16, torch.float32) for N in RAGGED_NS]
    cases += [(*shape, dt, False) for shape in RSNA_ATTN_SHAPES
              for dt in (torch.bfloat16, torch.float32)]
    checks, failures, timed = [], [], {}
    for i, (B, K, N, dtype, strided) in enumerate(cases):
        g = torch.Generator(device="cuda").manual_seed(200 + i)
        if strided:
            qkv = torch.randn((B, 3, K, N, D), generator=g, device="cuda").to(dtype)
            qkv = qkv.permute(0, 3, 1, 2, 4)
            dout = torch.randn((B, K, N, D), generator=g, device="cuda").to(dtype)
            dout = dout.permute(0, 2, 1, 3)
        else:
            qkv = torch.randn((B, N, 3, K, D), generator=g, device="cuda").to(dtype)
            dout = torch.randn((B, N, K, D), generator=g, device="cuda").to(dtype)
        scale = D ** -0.5
        out, stats = fa.flash_attention_qkv_fwd(qkv, scale, True)
        if strided:
            out = out.permute(0, 2, 1, 3).contiguous().permute(0, 2, 1, 3)
        plain = fa.flash_attention_qkv_bwd_reference(qkv, out, dout, scale, stats)
        got = fa.flash_attention_qkv_bwd(qkv, out, dout, scale, stats)
        again = fa.flash_attention_qkv_bwd(qkv, out, dout, scale, stats)
        torch.cuda.synchronize()
        entry = {"B": B, "K": K, "D": D, "N": N, "dtype": str(dtype).replace("torch.", ""),
                 "strided": strided, "tol": KERNEL_TOL[dtype],
                 "finite": bool(torch.isfinite(got).all()),
                 # every output summed by one block in a fixed order
                 "run_to_run_max_abs": (got.float() - again.float()).abs().max().item()}
        errs = {name: _norm_err(got[:, :, j], plain[:, :, j])
                for j, name in enumerate(("dq", "dk", "dv"))}
        if N == 1:
            # one key: its softmax weight is 1, so dq and dk vanish in exact
            # arithmetic and their own maximum is rounding noise; all three
            # are normalised by the largest gradient (dv = dO)
            big = plain.float().abs().max().item()
            errs = {name: (e[0], e[0] / big) for name, e in errs.items()}
        entry["max_abs_err"] = max(e[0] for e in errs.values())
        entry["norm_err"] = {name: e[1] for name, e in errs.items()}
        del plain, again
        if (B, K, N, dtype) == (8, 16, 513, torch.bfloat16):
            entry["vs_f32"] = _attention_vs_f32(*fa._stream_views(qkv), dout.transpose(1, 2),
                                                scale, lambda: _k1k2_path(qkv, dout, scale))
        if ((B, K) == (8, 16) or (B, K, N) == RSNA_ATTN) and dtype == torch.bfloat16:
            # the yardstick: backward of scaled_dot_product_attention through autograd
            q, k, v = (qkv[:, :, j].transpose(1, 2).contiguous().requires_grad_()
                       for j in range(3))
            lib_out = F.scaled_dot_product_attention(q, k, v)
            lib_g = dout.transpose(1, 2).contiguous()
            timings(entry, lambda: fa.flash_attention_qkv_bwd(qkv, out, dout, scale, stats),
                    lambda: fa.flash_attention_qkv_bwd_reference(qkv, out, dout, scale, stats),
                    lambda: torch.autograd.grad(lib_out, (q, k, v), lib_g, retain_graph=True),
                    windows=TIMING_WINDOWS)
            entry["kernel_ms_by_kernel"] = device_ms_split(
                lambda: fa.flash_attention_qkv_bwd(qkv, out, dout, scale, stats),
                {"dq": "attn_bwd_dq", "dkdv": "attn_bwd_dkdv"})
            bound_ms, bound_by = attention_bwd_bound(B, N, K, D, dtype)
            entry["bound_us"] = bound_ms * 1e3
            entry["bound_by"] = bound_by
            del q, k, v, lib_out, lib_g
            timed[N] = entry
        checks.append(entry)
        if not (entry["finite"] and max(entry["norm_err"].values()) <= entry["tol"]
                and entry["run_to_run_max_abs"] == 0.0):
            failures.append(entry)
        del qkv, dout, out, stats, got
        torch.cuda.empty_cache()
    emit({"phase": "kernels", "checks": [{**K2, "cases": checks}]})
    check(not failures, f"K2 disagrees with its plain version or between two calls: {failures}")
    return timed


def corner_matrices(V: int, seed: int) -> torch.Tensor:
    """V affine sampling matrices at corners of the augmentation's parameter
    box (each angle ±affine_rotate, each scale 1 ± affine_scale), where the
    LU passes' displacements come nearest their windows."""
    corners = np.array(list(itertools.product((-1.0, 1.0), repeat=6)))   # 64 corners
    pick = corners[np.random.default_rng(seed).permutation(len(corners))[:V]]
    ang = torch.tensor(pick[:, :3] * AUG.affine_rotate, dtype=torch.float32)
    scale = torch.tensor(1.0 + pick[:, 3:] * AUG.affine_scale, dtype=torch.float32)
    return augment.affine_matrix(ang, scale)


def pass_grid(axis: int, cdelta: torch.Tensor, center: tuple) -> torch.Tensor:
    """The (V, D, H, W, 3) grid with which ``F.grid_sample`` (bilinear,
    reflection padding, align_corners=False) computes one LU pass: voxel x
    reads its volume at x + rel(x)·e_axis.  Reflection about the pixel edges
    −0.5 and n − 0.5, then clipping, gives linear interpolation over the
    symmetric pad; the coordinates off the axis sit on voxel centres, exact
    at power-of-two sizes, so their weights are exactly 1 and 0."""
    pos = [torch.arange(s, dtype=torch.float32, device=cdelta.device) for s in VOLUME]
    g = [p - float(c) for p, c in zip(pos, center)]
    rel = (cdelta[:, 0, None, None, None] * g[0][None, :, None, None]
           + cdelta[:, 1, None, None, None] * g[1][None, None, :, None]) \
        + cdelta[:, 2, None, None, None] * g[2][None, None, None, :]
    full = [pos[0][None, :, None, None], pos[1][None, None, :, None], pos[2][None, None, None, :]]
    full = [p.expand_as(rel) for p in full]
    full[axis] = full[axis] + rel
    # the grid's last dim runs (W, H, D) = (axis 2, axis 1, axis 0)
    return torch.stack([(2 * full[a] + 1) / VOLUME[a] - 1 for a in (2, 1, 0)], dim=-1)


def _resample_cases():
    """(V, volume shape, dtype) of the resample checks: the live geometry at
    V = 8 and 24, and two shapes whose dims are not multiples of 8 or 32
    (rows that take no 16-byte copy, tiles of 8 and 4 lines)."""
    for V, shape in ((8, VOLUME), (24, VOLUME), *RESAMPLE_UNALIGNED):
        for dtype in (torch.float32, torch.bfloat16):
            yield V, shape, dtype


def phase_kernels_resample() -> tuple[dict, dict]:
    """K3 at the four live LU passes and K4 (all taps) at one, each against
    the plain version bit for bit, at the live geometry and at two unaligned
    shapes; no ptxas spill in either dtype's kernel.  Returns (K3, K4)
    entries with per-pass timings at V = 8 bf16 (the median of
    ``TIMING_WINDOWS`` windows), achieved GB/s and share of the bound; f32 at
    V = 8 is timed too.  The library yardstick is ``F.grid_sample`` on an f32
    copy of the volumes (a bf16 grid cannot place a coordinate near 127
    closer than a quarter voxel), held once against the plain version."""
    ptxas = {k: r for k, r in PTXAS.items() if "resample_kernel" in k}
    spills = {k: r for k, r in ptxas.items()
              if r.get("spill_stores", 0) or r.get("spill_loads", 0)}
    checks, failures, timed = [], [], {}
    for V, shape, dtype in _resample_cases():
        center = tuple((s - 1) / 2.0 for s in shape)
        windows, spans = augment.lu_windows(AUG, shape), augment.lu_spans(AUG, shape)
        half = np.array([(s - 1) / 2.0 for s in shape])
        g = torch.Generator(device="cuda").manual_seed(300 + V)
        vols = (torch.randn((V, *shape), generator=g, device="cuda") * 100).to(dtype)
        cds = augment.lu_cdeltas(corner_matrices(V, seed=V))
        # K4 runs the last pass with span None (all 2W+2 taps)
        passes = list(zip(range(4), augment.LU_AXES, windows, spans, cds))
        passes.append((4, augment.LU_AXES[3], windows[3], None, cds[3]))
        for p, axis, window, span, cd in passes:
            cd = cd.cuda()
            plain = rs.resample_axis_windowed_reference(vols, axis, cd, center, window, span)
            got = rs.resample_axis_windowed_batched(vols, axis, cd, center, window, span)
            torch.cuda.synchronize()
            max_abs, norm = _norm_err(got, plain)
            entry = {"kernel": "K4" if span is None else "K3", "pass": p, "axis": axis,
                     "window": window, "span": span, "V": V, "shape": list(shape),
                     "dtype": str(dtype).replace("torch.", ""),
                     "box": list(rs.box_geometry(shape, axis, vols.element_size())),
                     # how near the hat's taps come to the window edge ±W
                     "max_abs_rel": float((cd.abs().cpu().numpy() @ half).max()),
                     "max_abs_err": max_abs, "norm_err": norm, "tol": 0.0,
                     "finite": bool(torch.isfinite(got).all())}
            kernel = (lambda vols=vols, axis=axis, cd=cd, center=center, window=window,
                      span=span: rs.resample_axis_windowed_batched(vols, axis, cd, center,
                                                                   window, span))
            if V == 8 and shape == VOLUME and dtype == torch.bfloat16:
                vols32 = vols[:, None].float()
                grid = pass_grid(axis, cd, center)

                def library():
                    return F.grid_sample(vols32, grid, mode="bilinear",
                                         padding_mode="reflection", align_corners=False)
                entry["library_norm_err"] = _norm_err(library()[:, 0], plain)[1]
                if not entry["library_norm_err"] <= KERNEL_TOL[dtype]:
                    failures.append(entry)
                timings(entry, kernel, lambda: rs.resample_axis_windowed_reference(
                            vols, axis, cd, center, window, span), library,
                        windows=TIMING_WINDOWS)
                del grid, vols32
            elif V == 8 and shape == VOLUME:
                timings(entry, kernel, None, windows=TIMING_WINDOWS)
            if "kernel_ms" in entry:
                bound_ms, bound_by = resample_bound(V, dtype)
                entry["bound_us"] = bound_ms * 1e3
                entry["bound_by"] = bound_by
                entry["bound_share"] = bound_ms / entry["kernel_ms"]
                entry["gb_s"] = 2 * got.numel() * got.element_size() / entry["kernel_ms"] / 1e6
                if dtype == torch.bfloat16:
                    timed.setdefault(entry["kernel"], []).append(entry)
            checks.append(entry)
            # bit for bit: the kernel sums the plain version's taps in its order
            if not (entry["finite"] and max_abs == 0.0):
                failures.append(entry)
    emit({"phase": "kernels", "resample_ptxas": ptxas,
          "checks": [{**K, "cases": [c for c in checks if c["kernel"] == name]}
                     for name, K in (("K3", K3), ("K4", K4))]})
    check(len(ptxas) == 6 and not spills,
          f"resample kernels' ptxas report: want six kernels (three axes, two dtypes), "
          f"no spill, got {ptxas}")
    check(not failures, f"resample kernel differs from its plain version: {failures}")

    def summary(entries):
        # per launch, averaged over the timed passes (V = 8, bf16)
        n = len(entries)
        kind = entries[0]["kernel"]
        f32 = [c for c in checks if c["kernel"] == kind and "kernel_ms" in c
               and c["dtype"] == "float32"]
        return {"max_abs_err": max(c["max_abs_err"] for c in checks if c["kernel"] == kind),
                "ms": sum(e["kernel_ms"] for e in entries) / n,
                "plain_ms": sum(e["plain_ms"] for e in entries) / n,
                "library_ms": sum(e["library_ms"] for e in entries) / n,
                "bound_ms": sum(e["bound_us"] for e in entries) / n / 1e3,
                "bound_by": entries[0]["bound_by"],
                "per_pass_ms": [e["kernel_ms"] for e in entries],
                "per_pass_ms_spread": [e["kernel_ms_spread"] for e in entries],
                "per_pass_gb_s": [e["gb_s"] for e in entries],
                "per_pass_bound_share": [e["bound_share"] for e in entries],
                "per_pass_library_ms": [e["library_ms"] for e in entries],
                "f32_per_pass_ms": [c["kernel_ms"] for c in f32],
                "f32_bound_ms": f32[0]["bound_us"] / 1e3}
    return summary(timed["K3"]), summary(timed["K4"])


def k7_bounds(B: int, N: int, K: int, D: int) -> dict[str, tuple[float, str]]:
    """Least time in ms of each K7 kernel and of the whole backward at bf16:
    each input read once and each output written once (operands of
    B·N·K·D bf16 values, lse and delta of B·K·N f32), against the tensor-core
    operations of its products (2·B·K·N²·D each): the forward 2 products,
    the dq kernel 3 (s, dp, dq), the dk/dv kernel 4 (s, dp, dv, dk), the
    backward as one function 5."""
    op, row = B * N * K * D * 2, B * K * N * 4
    work = {"fwd": (4 * op + row, 2),              # q, k, v → out, lse
            "dq": (6 * op + 2 * row, 3),           # q, k, v, o, dO, lse → dq, delta
            "dkdv": (6 * op + 2 * row, 4),         # q, k, v, dO, lse, delta → dk, dv
            "bwd": (8 * op + row, 5)}              # q, k, v, o, dO, lse → dq, dk, dv
    bounds = {}
    for name, (nbytes, products) in work.items():
        t_bytes = nbytes / HBM_BYTES_S
        t_ops = products * 2 * B * K * N * N * D / PEAK_FLOPS[torch.bfloat16]
        bounds[name] = (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")
    return bounds


def _k7_operands(B: int, K: int, N: int, dtype: torch.dtype, layout: str, seed: int):
    """(q, k, v, dout, new_grads) at D=64, ``new_grads()`` giving the
    gradients' destination of one backward call.  'stacked': q, k, v are
    (B, K, N, D) views of one (B, N, 3, K, D) qkv, dout a view of a
    (B, N, K, D) tensor and the gradients go into views of a new stacked
    dqkv — the model's layout; 'dminor': each operand a view of its own
    (B, K, D, N) buffer (head-dim stride N; the f32 kernels take any
    strides) and the wrapper makes the gradients (None)."""
    D = 64
    g = torch.Generator(device="cuda").manual_seed(seed)
    if layout == "stacked":
        qkv = torch.randn((B, N, 3, K, D), generator=g, device="cuda").to(dtype)
        dout = torch.randn((B, N, K, D), generator=g, device="cuda").to(dtype).transpose(1, 2)
        return (*fa._stream_views(qkv), dout,
                lambda: fa._stream_views(torch.empty_like(qkv)))
    q, k, v, dout = (torch.randn((B, K, D, N), generator=g, device="cuda").to(dtype)
                     .transpose(2, 3) for _ in range(4))
    return q, k, v, dout, lambda: None


def _k7_path(q, k, v, dout, scale: float):
    """K7's forward, then its backward on the forward's out and lse."""
    out, lse = fa.flash_attention_stream_fwd(q, k, v, scale)
    return out, fa.flash_attention_stream_bwd(q, k, v, out, lse, dout, scale)


def _named_ptxas(prefix: str) -> dict[str, dict]:
    """The ptxas registers and spills, in the last build, of the kernels
    whose names start with ``prefix`` (K5's ``attn_single_``, K7's
    ``attn_stream_``), by kernel name."""
    return {m.group(1): report for key, report in PTXAS.items()
            if (m := re.search(rf"({prefix}\w*?_kernel)", key))}


def phase_kernels_k7() -> dict:
    """K7's three kernels against their plain versions: the forward's out
    and lse (also against the plain version over the kernel's own 64-key
    tiles, whose running max rounds p as the kernel's does, within
    ``K7_TILE_TOL``), and dq, dk, dv of the backward run on the kernel's out
    and lse (at the training shape also within ``K7_TRAIN_TOL``); two
    identical backward calls compared bit for bit; no ptxas spill in a K7
    kernel.  Returns the training-shape readings with timings and bounds."""
    ptxas = _named_ptxas("attn_stream_")
    cases = [(2, 4, N, dt, "stacked") for N in K7_NS for dt in (torch.bfloat16, torch.float32)]
    cases.append((2, 4, 1041, torch.float32, "dminor"))
    cases.append((*K7_TRAIN, torch.bfloat16, "stacked"))
    checks, failures, train = [], [], {}
    for i, (B, K, N, dtype, layout) in enumerate(cases):
        q, k, v, dout, new_grads = _k7_operands(B, K, N, dtype, layout, seed=400 + i)
        grads = new_grads()
        scale = 64 ** -0.5
        out, lse = fa.flash_attention_stream_fwd(q, k, v, scale)
        plain_out, plain_lse = fa.flash_attention_stream_reference(q, k, v, scale)
        tile_out, tile_lse = fa.flash_attention_stream_reference(q, k, v, scale, block=BK7)
        got = fa.flash_attention_stream_bwd(q, k, v, out, lse, dout, scale, grads=grads)
        again = fa.flash_attention_stream_bwd(q, k, v, out, lse, dout, scale, grads=new_grads())
        want = fa.flash_attention_blocked_bwd_reference(q, k, v, out, lse, dout, scale)
        torch.cuda.synchronize()
        errs = {"out": _norm_err(out, plain_out), "lse": _norm_err(lse, plain_lse),
                **{n: _norm_err(got[j], want[j]) for j, n in enumerate(("dq", "dk", "dv"))}}
        entry = {"B": B, "K": K, "D": 64, "N": N,
                 "dtype": str(dtype).replace("torch.", ""), "layout": layout,
                 "tol": KERNEL_TOL[dtype],
                 "finite": all(bool(torch.isfinite(t).all()) for t in (out, lse, *got)),
                 "max_abs_err": {n: e[0] for n, e in errs.items()},
                 "norm_err": {n: e[1] for n, e in errs.items()},
                 # every output summed by one block in a fixed order
                 "run_to_run_max_abs": max((a.float() - b.float()).abs().max().item()
                                           for a, b in zip(got, again))}
        tile = {"out": _norm_err(out, tile_out), "lse": _norm_err(lse, tile_lse)}
        entry["at_kernel_tile"] = {"block": BK7, "tol": K7_TILE_TOL[dtype],
                                   "max_abs_err": {n: e[0] for n, e in tile.items()},
                                   "norm_err": {n: e[1] for n, e in tile.items()}}
        ok = (max(entry["at_kernel_tile"]["norm_err"].values()) <= K7_TILE_TOL[dtype]
              and entry["run_to_run_max_abs"] == 0.0)
        del plain_out, plain_lse, want, tile_out, tile_lse, again
        if (B, K, N) == K7_TRAIN:
            entry["train_tol"] = K7_TRAIN_TOL
            ok = ok and all(entry["norm_err"][n] <= lim for n, lim in K7_TRAIN_TOL.items())
            qc, kc, vc = (t.contiguous() for t in (q, k, v))
            timings(entry, lambda: fa.flash_attention_stream_fwd(q, k, v, scale),
                    lambda: fa.flash_attention_stream_reference(q, k, v, scale),
                    lambda: F.scaled_dot_product_attention(qc, kc, vc))
            entry["bwd_kernel_ms"] = device_ms_split(
                lambda: fa.flash_attention_stream_bwd(q, k, v, out, lse, dout, scale,
                                                      grads=grads),
                {"dq": "attn_stream_bwd_dq", "dkdv": "attn_stream_bwd_dkdv"})
            entry["bwd_plain_ms"] = {
                "dq": device_ms(lambda: fa.flash_attention_stream_bwd_dq_reference(
                    q, k, v, out, lse, dout, scale), calls=2),
                "dkdv": device_ms(lambda: fa.flash_attention_stream_bwd_dkdv_reference(
                    q, k, v, out, lse, dout, scale), calls=2)}
            # the yardstick: backward of scaled_dot_product_attention through autograd
            xs = [t.detach().requires_grad_() for t in (qc, kc, vc)]
            lib_out = F.scaled_dot_product_attention(*xs)
            lib_g = dout.contiguous()
            entry["bwd_library_ms"] = device_ms(
                lambda: torch.autograd.grad(lib_out, xs, lib_g, retain_graph=True))
            del xs, lib_out, lib_g, qc, kc, vc
            entry["bound"] = {name: {"ms": ms, "by": by}
                              for name, (ms, by) in k7_bounds(B, N, K, 64).items()}
            entry["vs_f32"] = _attention_vs_f32(q, k, v, dout, scale,
                                                lambda: _k7_path(q, k, v, dout, scale))
            train = entry
        checks.append(entry)
        if not (ok and entry["finite"] and max(entry["norm_err"].values()) <= entry["tol"]):
            failures.append(entry)
        del q, k, v, dout, grads, out, lse, got
        torch.cuda.empty_cache()
    emit({"phase": "kernels_k7", "kernels": [K7F, K7DKV, K7DQ], "ptxas": ptxas,
          "cases": checks})
    check(len(ptxas) == 6, f"ptxas reported {sorted(ptxas)}, not K7's six kernels (forward, "
                           "dq, dk/dv; bf16 and f32)")
    check(not any(r.get("spill_stores") or r.get("spill_loads") for r in ptxas.values()),
          f"a K7 kernel spills: {ptxas}")
    check(not failures, f"K7 disagrees with its plain versions or between two calls: "
                        f"{failures}")
    return train


def k5_bounds(B: int, N: int, K: int, D: int) -> dict[str, tuple[float, str]]:
    """Least time in ms of K5's forward and backward at bf16: each input read
    once and each output written once (operands of B·N·K·D bf16 values),
    against the tensor-core operations of the least products (2·B·K·N²·D
    each): the forward 2 (s, p·v); the backward 5 (s, dp, dv, dq, dk —
    delta as rowsum(pb ⊙ dp) needs no sixth)."""
    op = B * N * K * D * 2
    bounds = {}
    for name, (nbytes, products) in {"fwd": (4 * op, 2),        # q, k, v → out
                                     "bwd": (7 * op, 5)}.items():  # q, k, v, dO → dq, dk, dv
        t_bytes = nbytes / HBM_BYTES_S
        t_ops = products * 2 * B * K * N * N * D / PEAK_FLOPS[torch.bfloat16]
        bounds[name] = (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")
    return bounds


def _k5_operands(B: int, K: int, N: int, dtype: torch.dtype, layout: str, seed: int):
    """(q, k, v, dout) at D=64.  'stacked': q, k, v are (B, K, N, D) views of
    one (B, N, 3, K, D) tensor — the int8 qkv projection's output, the
    serving layout; 'contiguous': each its own (B, K, N, D) tensor."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    if layout == "stacked":
        qkv = torch.randn((B, N, 3, K, 64), generator=g, device="cuda").to(dtype)
        q, k, v = fa._stream_views(qkv)
    else:
        q, k, v = (torch.randn((B, K, N, 64), generator=g, device="cuda").to(dtype)
                   for _ in range(3))
    return q, k, v, torch.randn((B, K, N, 64), generator=g, device="cuda").to(dtype)


def _k5_path(q, k, v, dout, scale: float):
    """K5's forward with its row statistics, then its backward on them."""
    out, stats = fa.flash_attention_single_fwd(q, k, v, scale, True)
    return out, fa.flash_attention_single_bwd(q, k, v, dout, scale, stats)


def phase_kernels_k5() -> dict:
    """K5's forward and its row statistics, and its backward (dq, dk, dv) on
    the kernel's own statistics, against their plain versions (the
    backward's given the same statistics), contiguous and as views of a
    stacked qkv; two identical backward calls compared bit for bit; the
    ptxas report of K5's kernels (no spill).  At the two serving shapes the
    timings (median of five profiled windows), bounds, library yardsticks
    and the distance of kernel and plain path from an f32 attention.
    Returns the serving-shape readings by N."""
    ptxas = _named_ptxas("attn_single_")
    cases = [(2, 4, N, dt, layout) for N in K5_NS for dt in (torch.bfloat16, torch.float32)
             for layout in ("contiguous", "stacked")]
    cases += [(*shape, torch.bfloat16, "stacked") for shape in K5_SERVE]
    checks, failures, timed = [], [], {}
    for i, (B, K, N, dtype, layout) in enumerate(cases):
        q, k, v, dout = _k5_operands(B, K, N, dtype, layout, seed=500 + i)
        scale = 64 ** -0.5
        out = fa.flash_attention_single_fwd(q, k, v, scale)
        out_s, stats = fa.flash_attention_single_fwd(q, k, v, scale, True)
        plain_out, plain_stats = fa.flash_attention_single_reference(q, k, v, scale, True)
        got = fa.flash_attention_single_bwd(q, k, v, dout, scale, stats)
        again = fa.flash_attention_single_bwd(q, k, v, dout, scale, stats)
        want = fa.flash_attention_single_bwd_reference(q, k, v, dout, scale, stats)
        torch.cuda.synchronize()
        errs = {"out": _norm_err(out, plain_out),
                **{n: _norm_err(got[j], want[j]) for j, n in enumerate(("dq", "dk", "dv"))}}
        entry = {"B": B, "K": K, "D": 64, "N": N, "dtype": str(dtype).replace("torch.", ""),
                 "layout": layout, "tol": KERNEL_TOL[dtype],
                 "finite": all(bool(torch.isfinite(t).all()) for t in (out, *got)),
                 "max_abs_err": {n: e[0] for n, e in errs.items()},
                 "norm_err": {n: e[1] for n, e in errs.items()},
                 "stats_err": _stats_err(stats, plain_stats),
                 "out_equal_with_stats": bool(torch.equal(out_s, out)),
                 # every output summed by one block in a fixed order
                 "run_to_run_max_abs": max((a.float() - b.float()).abs().max().item()
                                           for a, b in zip(got, again))}
        del plain_out, plain_stats, want, again, out_s
        if (B, K, N) in K5_SERVE:
            qc, kc, vc = (t.contiguous() for t in (q, k, v))
            timings(entry, lambda: fa.flash_attention_single_fwd(q, k, v, scale),
                    lambda: fa.flash_attention_single_reference(q, k, v, scale),
                    lambda: F.scaled_dot_product_attention(qc, kc, vc), windows=TIMING_WINDOWS)
            entry["kernel_with_stats_ms"] = device_ms(
                lambda: fa.flash_attention_single_fwd(q, k, v, scale, True))
            xs = [t.detach().requires_grad_() for t in (qc, kc, vc)]
            lib_out = F.scaled_dot_product_attention(*xs)
            lib_g = dout.contiguous()
            def bwd():
                return fa.flash_attention_single_bwd(q, k, v, dout, scale, stats)
            entry["bwd"] = {}
            timings(entry["bwd"], bwd,
                    lambda: fa.flash_attention_single_bwd_reference(q, k, v, dout, scale, stats),
                    lambda: torch.autograd.grad(lib_out, xs, lib_g, retain_graph=True),
                    windows=TIMING_WINDOWS)
            entry["bwd"]["kernel_ms_by_kernel"] = device_ms_split(
                bwd, {"dq": "attn_single_bwd_dq", "dkdv": "attn_single_bwd_dkdv"})
            del xs, lib_out, lib_g, qc, kc, vc
            entry["bound"] = {name: {"ms": ms, "by": by}
                              for name, (ms, by) in k5_bounds(B, N, K, 64).items()}
            entry["vs_f32"] = _attention_vs_f32(q, k, v, dout, scale,
                                                lambda: _k5_path(q, k, v, dout, scale))
            timed[N] = entry
        checks.append(entry)
        if not (entry["finite"] and max(entry["norm_err"].values()) <= entry["tol"]
                and max(entry["stats_err"].values()) <= STATS_TOL
                and entry["out_equal_with_stats"] and entry["run_to_run_max_abs"] == 0.0):
            failures.append(entry)
        del q, k, v, dout, out, got, stats
        torch.cuda.empty_cache()
    emit({"phase": "kernels_k5", "kernels": [K5F, K5B], "ptxas": ptxas, "cases": checks})
    check(len(ptxas) == len(K5_KERNELS) * 2,
          f"ptxas reported {sorted(ptxas)}, not K5's bf16 and f32 kernels")
    check(not any(r.get("spill_stores") or r.get("spill_loads") for r in ptxas.values()),
          f"a K5 kernel spills: {ptxas}")
    check(not failures, f"K5 disagrees with its plain versions or between two calls: {failures}")
    return timed


def _k6_operands(B: int, K: int, N: int, dtype: torch.dtype, layout: str, seed: int):
    """(q, k, v, dout), each (B, K, D, N) at D=64: 'contiguous' tensors of
    that shape (N is the unit stride: the bf16 wrapper hands the kernels
    (B, K, N, D) copies) or 'dminor' views of (B, K, N, D) tensors (16-byte
    rows, no copy)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    if layout == "contiguous":
        return tuple(torch.randn((B, K, 64, N), generator=g, device="cuda").to(dtype)
                     for _ in range(4))
    return tuple(torch.randn((B, K, N, 64), generator=g, device="cuda").to(dtype)
                 .transpose(-1, -2) for _ in range(4))


def _k6_errs(q, k, v, dout, scale: float) -> tuple[dict, bool]:
    """Normalised errors of K6's out, its row statistics, dq, dk, dv against
    the plain versions (the backward's given the kernel's statistics), and
    whether all are finite."""
    out, stats = fa.flash_attention_tn_fwd(q, k, v, scale, True)
    got = fa.flash_attention_tn_bwd(q, k, v, dout, scale, stats)
    want_out, want_stats = fa.flash_attention_tn_reference(q, k, v, scale, True)
    errs = {"out": _norm_err(out, want_out)}
    errs.update({f"stats_{n}": (e, e) for n, e in _stats_err(stats, want_stats).items()})
    want = fa.flash_attention_tn_bwd_reference(q, k, v, dout, scale, stats)
    errs.update({n: _norm_err(got[j], want[j]) for j, n in enumerate(("dq", "dk", "dv"))})
    torch.cuda.synchronize()
    return errs, all(bool(torch.isfinite(t).all()) for t in (out, *got))


def phase_kernels_k6() -> dict:
    """K6's forward and backward against their plain versions in both
    layouts; the public op's switch to K7 at N = 1041; at K6_TIMED the
    timings, bounds and library yardsticks in both layouts.  Returns the
    timed readings by layout."""
    scale = 64 ** -0.5
    cases = [(2, 4, N, dt, layout) for N in K6_NS for dt in (torch.bfloat16, torch.float32)
             for layout in ("dminor", "contiguous")]
    cases += [(*K6_TIMED, torch.bfloat16, layout) for layout in ("dminor", "contiguous")]
    checks, failures, timed = [], [], {}
    for i, (B, K, N, dtype, layout) in enumerate(cases):
        q, k, v, dout = _k6_operands(B, K, N, dtype, layout, seed=600 + i)
        errs, finite = _k6_errs(q, k, v, dout, scale)
        entry = {"B": B, "K": K, "D": 64, "N": N, "dtype": str(dtype).replace("torch.", ""),
                 "layout": layout, "tol": KERNEL_TOL[dtype], "finite": finite,
                 "max_abs_err": {n: e[0] for n, e in errs.items()},
                 "norm_err": {n: e[1] for n, e in errs.items()}}
        if (B, K, N) == K6_TIMED:
            # the library yardstick reads (B, K, N, D) tensors: the D-minor
            # layout.  The kernel times of the contiguous layout hold the
            # wrapper's (B, K, N, D) copies
            qc, kc, vc, gc = (t.transpose(-1, -2).contiguous() for t in (q, k, v, dout))
            _, stats = fa.flash_attention_tn_fwd(q, k, v, scale, True)
            timings(entry, lambda: fa.flash_attention_tn_fwd(q, k, v, scale),
                    lambda: fa.flash_attention_tn_reference(q, k, v, scale),
                    lambda: F.scaled_dot_product_attention(qc, kc, vc))
            entry["bwd_kernel_ms"] = device_ms(
                lambda: fa.flash_attention_tn_bwd(q, k, v, dout, scale, stats))
            entry["bwd_kernel_ms_by_kernel"] = device_ms_split(
                lambda: fa.flash_attention_tn_bwd(q, k, v, dout, scale, stats),
                {"dq": "attn_bwd_dq", "dkdv": "attn_bwd_dkdv"})
            entry["bwd_plain_ms"] = device_ms(
                lambda: fa.flash_attention_tn_bwd_reference(q, k, v, dout, scale, stats), calls=2)
            xs = [t.detach().requires_grad_() for t in (qc, kc, vc)]
            lib_out = F.scaled_dot_product_attention(*xs)
            entry["bwd_library_ms"] = device_ms(
                lambda: torch.autograd.grad(lib_out, xs, gc, retain_graph=True))
            del xs, lib_out, qc, kc, vc, gc
            entry["bound"] = {name: {"ms": ms, "by": by}
                              for name, (ms, by) in k5_bounds(B, N, K, 64).items()}
            timed[layout] = entry
        checks.append(entry)
        if not (finite and max(entry["norm_err"].values()) <= entry["tol"]):
            failures.append(entry)
        del q, k, v, dout
        torch.cuda.empty_cache()

    # above N = 1040 the public op is K7 on (B, K, N, D) copies, both ways
    q, k, v, dout = _k6_operands(2, 4, 1041, torch.bfloat16, "contiguous", seed=690)
    xs = [t.detach().requires_grad_() for t in (q, k, v)]
    _zero_counts()
    out = fa.flash_attention_tn(*xs, scale)
    grads = torch.autograd.grad(out, xs, dout)
    torch.cuda.synchronize()
    routed = {n: c for n, c in _counts().items() if c}
    want = {"K7F": 1, "K7DQ": 1, "K7DKV": 1}
    switch = {"N": 1041, "launches": routed, "expected": want,
              "out_vs_k6_plain": _norm_err(out, fa.flash_attention_tn_reference(q, k, v, scale))[1],
              "finite": all(bool(torch.isfinite(t).all()) for t in (out, *grads))}
    emit({"phase": "kernels_k6", "kernels": [K6F, K6B], "cases": checks, "switch": switch})
    check(not failures, f"K6 disagrees with its plain versions: {failures}")
    check(routed == want and switch["finite"]
          and switch["out_vs_k6_plain"] <= KERNEL_TOL[torch.bfloat16],
          f"flash_attention_tn at N = 1041 did not route to K7: {switch}")
    return timed


def k8_bound(B: int, N: int, K: int, D: int, H: int) -> tuple[float, str, float, float]:
    """Least time in ms of one K8 call: the JAX cost estimate's operations
    (:960), 2·B·K·N·(5·N·D + 6·D·H), at the bf16 peak, against the bytes of
    qkv, o, dO, x and W read once and dx (bf16) and dW (f32) written once.
    Returns (ms, bound_by, GFLOP, MB)."""
    flops = 2 * B * K * N * (5 * N * D + 6 * D * H)
    nbytes = (5 * B * N * K * D + 2 * B * N * H + 3 * K * D * H) * 2 + 3 * K * D * H * 4
    t_ops, t_bytes = flops / PEAK_FLOPS[torch.bfloat16], nbytes / HBM_BYTES_S
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes",
            flops / 1e9, nbytes / 1e6)


def k8_products_bound(B: int, N: int, K: int, D: int, H: int) -> tuple[float, str]:
    """Least time in ms of K8's two products: 2·2·M·H·J FLOPs (M = B·N,
    J = 3·K·D) at the bf16 peak, against dqkv, x and W read once and dx
    (bf16) and dW (f32) written once."""
    M, J = B * N, 3 * K * D
    t_ops = 4 * M * H * J / PEAK_FLOPS[torch.bfloat16]
    t_bytes = ((M * J + M * H + H * J + M * H) * 2 + H * J * 4) / HBM_BYTES_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def _k8_operands(B: int, N: int, seed: int, K: int = 16, D: int = 64, H: int = 1024):
    """x (B, N, H), w (H, 3, K, D) as the model passes it (a view of a
    (3H, H) Linear weight), qkv = x·W, K1's output on it and a cotangent."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((B, N, H), generator=g, device="cuda").bfloat16()
    weight = (torch.randn((3 * K * D, H), generator=g, device="cuda") * H ** -0.5).bfloat16()
    w = weight.t().reshape(H, 3, K, D)
    qkv = torch.matmul(x, weight.t()).view(B, N, 3, K, D)
    out, stats = fa.flash_attention_qkv_fwd(qkv, None, True)
    dout = torch.randn((B, N, K, D), generator=g, device="cuda").bfloat16()
    return x, w, qkv, out, dout, stats


def _bf16_ulps(got: torch.Tensor, want: torch.Tensor) -> dict:
    """got's distance from want element-wise, in bf16 ulps (the spacing of
    bf16 at the larger of the two magnitudes).  ``max_ulps`` takes the
    magnitude at no less than 2^-8 of max |want|: two f32 sums of the same
    products in other orders differ by about 1e-6 of the largest magnitude
    (the sum's own rounding), more than the ulp of an element that cancels to
    near zero.  ``over_one_own_ulp`` counts the elements more than one of
    their own ulps away, at any magnitude."""
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    mag = torch.maximum(g.abs(), w.abs())
    floor = w.abs().max() * 2.0 ** -8

    def ulp(a: torch.Tensor) -> torch.Tensor:
        return torch.pow(2.0, torch.floor(torch.log2(a.clamp_min(1e-30))) - 7)

    own = diff / ulp(mag)
    return {"max_ulps": (diff / ulp(torch.maximum(mag, floor))).max().item(),
            "max_own_ulps": own.max().item(), "over_one_own_ulp": int((own > 1).sum()),
            "max_abs_err": diff.max().item()}


def _products_errs(dx: torch.Tensor, dw: torch.Tensor, want_dx: torch.Tensor,
                   want_dw: torch.Tensor) -> dict:
    return {"dx_ulps": _bf16_ulps(dx, want_dx), "dW_norm_err": _norm_err(dw, want_dw)[1],
            "dW_max_abs_err": _norm_err(dw, want_dw)[0]}


def phase_kernels_k8() -> dict:
    """K8 against its plain version (dx and dW), with W as the model's view
    of the Linear weight and contiguous, and the spread of two identical
    calls; its two products alone on K2's dqkv against their plain version
    (dW f32 within ``K8_DW_TOL``, dx within one bf16 ulp, ``_bf16_ulps``),
    beside the same products by cuBLAS; no ptxas spill in a product kernel.
    At the live shape the timings beside the unfused route and the library
    yardsticks.  Returns the live-shape reading."""
    K, D, H = 16, 64, 1024
    scale = D ** -0.5
    ptxas = {key: r for key, r in PTXAS.items() if "qkv_grad_d" in key}
    checks, failures, live = [], [], {}
    for i, (B, N) in enumerate(K8_SHAPES):
        x, w, qkv, out, dout, stats = _k8_operands(B, N, seed=800 + i)
        want_dx, want_dw = fa.fused_qkv_bwd_reference(x, w, qkv, out, dout, scale, stats)
        # K2's dq, dk, dv: the products alone are held against their plain
        # version on these bits
        dqkv = fa.flash_attention_qkv_bwd(qkv, out, dout, scale, stats)
        prod_dx, prod_dw = fa.fused_qkv_products_reference(x, w, dqkv)
        x2 = x.reshape(B * N, H)
        lib_dx, _ = fa._qkv_grads_plain(x, w, dqkv)
        lib_dw = torch.mm(x2.t(), dqkv.reshape(B * N, -1), out_dtype=torch.float32)
        library = {**_products_errs(lib_dx, lib_dw.view(w.shape), prod_dx, prod_dw)}
        for layout in ("view", "contiguous"):
            wl = w if layout == "view" else w.contiguous()
            counts0 = {n: getattr(fa.fused_qkv_bwd, n) for n in
                       ("launches", "dq_launches", "dkdv_launches", "dx_launches", "dw_launches")}
            dx, dw = fa.fused_qkv_bwd(x, wl, qkv, out, dout, scale, stats)
            dx2, dw2 = fa.fused_qkv_bwd(x, wl, qkv, out, dout, scale, stats)
            per_call = {n: (getattr(fa.fused_qkv_bwd, n) - c0) / 2 for n, c0 in counts0.items()}
            pdx, pdw = fa.fused_qkv_products(x, wl, dqkv)
            torch.cuda.synchronize()
            errs = {"dx": _norm_err(dx, want_dx), "dW": _norm_err(dw, want_dw)}
            products = _products_errs(pdx, pdw, prod_dx, prod_dw)
            entry = {"B": B, "N": N, "K": K, "D": D, "H": H, "dtype": "bfloat16",
                     "w_layout": layout, "w_strides": list(wl.stride()),
                     "tol": KERNEL_TOL[torch.bfloat16], "launches_per_call": per_call,
                     "finite": all(bool(torch.isfinite(t).all()) for t in (dx, dw)),
                     "max_abs_err": {n: e[0] for n, e in errs.items()},
                     "norm_err": {n: e[1] for n, e in errs.items()},
                     # f32 sums in a fixed order per output tile: no run-to-run spread
                     "run_to_run_max_abs": {"dx": (dx.float() - dx2.float()).abs().max().item(),
                                            "dW": (dw.float() - dw2.float()).abs().max().item()},
                     "products": {**products, "tol": K8_PRODUCT_TOL,
                                  "library": library,
                                  "dx_equal_to_library": bool(torch.equal(pdx, lib_dx))}}
            del dx2, dw2
            if (B, N) == K8_SHAPES[0] and layout == "view":
                # the unfused route reads the same dqkv bits: the two differ only
                # in the products' summation order before their single rounding
                ux, uw = fa._qkv_grads_plain(x, w, dqkv)
                entry["vs_unfused"] = {"dx": _norm_err(dx, ux)[1], "dW": _norm_err(dw, uw)[1],
                                       "dx_elements_differing": int((dx != ux).sum()),
                                       "dW_elements_differing": int((dw != uw).sum())}
                del ux, uw
                entry["kernel_ms_by_kernel"] = device_ms_split(
                    lambda: fa.fused_qkv_bwd(x, w, qkv, out, dout, scale, stats),
                    {"dq": "attn_bwd_dq", "dkdv": "attn_bwd_dkdv", "dx": "qkv_grad_dx_kernel",
                     "dW": "qkv_grad_dw_kernel"})
                by_kernel = entry["kernel_ms_by_kernel"]
                entry["kernel_ms"] = by_kernel.get("whole_ms") or sum(by_kernel.values())
                entry["products_ms"] = (None if by_kernel["dx"] is None
                                        else by_kernel["dx"] + by_kernel["dW"])
                entry["plain_ms"] = device_ms(
                    lambda: fa.fused_qkv_bwd_reference(x, w, qkv, out, dout, scale, stats),
                    calls=2)
                entry["unfused_ms"] = device_ms(
                    lambda: fa._qkv_grads_plain(x, w, fa.flash_attention_qkv_bwd(
                        qkv, out, dout, scale, stats)))
                # the products' yardstick: the same two products by cuBLAS on
                # the same dqkv
                entry["products_library_ms"] = device_ms(lambda: fa._qkv_grads_plain(x, w, dqkv))
                entry["products_plain_ms"] = device_ms(
                    lambda: fa.fused_qkv_products_reference(x, w, dqkv), calls=2)
                qc, kc, vc = (t.detach().contiguous().requires_grad_()
                              for t in fa._stream_views(qkv))
                lib_out = F.scaled_dot_product_attention(qc, kc, vc)
                lib_g = dout.transpose(1, 2).contiguous()
                entry["library_ms"] = device_ms(
                    lambda: (torch.autograd.grad(lib_out, (qc, kc, vc), lib_g, retain_graph=True),
                             fa._qkv_grads_plain(x, w, dqkv)))
                del qc, kc, vc, lib_out, lib_g
                ms, by, gflop, mb = k8_bound(B, N, K, D, H)
                entry["bound"] = {"ms": ms, "by": by, "gflop": gflop, "mb": mb}
                entry["products_bound"] = dict(zip(("ms", "by"),
                                                   k8_products_bound(B, N, K, D, H)))
                live = entry
            checks.append(entry)
            if not (entry["finite"] and max(entry["norm_err"].values()) <= entry["tol"]
                    and per_call["launches"] == 1
                    and max(entry["run_to_run_max_abs"].values()) == 0.0
                    and products["dW_norm_err"] <= K8_PRODUCT_TOL["dW_norm_err"]
                    and products["dx_ulps"]["max_ulps"] <= K8_PRODUCT_TOL["dx_max_ulps"]):
                failures.append(entry)
            del dx, dw, pdx, pdw, wl
        del x, w, qkv, out, dout, stats, dqkv, want_dx, want_dw, prod_dx, prod_dw, lib_dx, lib_dw
        torch.cuda.empty_cache()
    emit({"phase": "kernels_k8", "kernels": [K8], "ptxas": ptxas, "cases": checks})
    check(len(ptxas) == 3, f"ptxas reported {sorted(ptxas)}, not K8's dx (W K-major and "
                           "transposed) and dW kernels")
    check(not any(r.get("spill_stores") or r.get("spill_loads") for r in ptxas.values()),
          f"a K8 product kernel spills: {ptxas}")
    check(not failures, f"K8 disagrees with its plain version: {failures}")
    return live


def vit_config(streams: tuple, use_flash: bool):
    """params_list2[1] of the experiment grid with ``streams`` as its
    img_types: dropout 0.1, augmentation on, Adam lr 1e-4 wd 5e-4, cosine
    T_max 150; bf16 compute and activations (and augmentation), tanh GELU."""
    p = Params(lr=1e-4, dropout=0.1, attn_order={},
               optim_params={"T_max": 150, "eta_min": 1e-6}, weight_decay=5e-4,
               img_types=streams, label_smoothing=0.0, img_aug=True)
    cfg = get_mgmt_config()
    modify_config(cfg, p)
    modify_config(cfg, {"num_modalities": len(streams), "compute_dtype": "bfloat16",
                        "activation_dtype": "bfloat16", "augment_dtype": "bfloat16",
                        "use_flash_attention": use_flash, "gelu_approx": True})
    return cfg


def live_config(use_flash: bool):
    """bench.py's live configuration: params_list1[0] of the experiment
    grid, bf16 compute and activations, flash attention, tanh GELU."""
    p = Params(lr=1e-4, dropout=0.25, attn_order={"0": "1", "1": "2", "2": "0"},
               optim_params={"T_max": 250, "eta_min": 1e-6}, weight_decay=5e-4,
               img_types=MODALITIES, label_smoothing=0.0, img_aug=True)
    cfg = get_mgmt_cross_config()
    modify_config(cfg, p)
    modify_config(cfg, {"num_modalities": len(MODALITIES), "compute_dtype": "bfloat16",
                        "activation_dtype": "bfloat16", "augment_dtype": "bfloat16",
                        "use_flash_attention": use_flash, "gelu_approx": True})
    return cfg


def _post_predict(port: int, vols: np.ndarray) -> np.ndarray:
    buf = io.BytesIO()
    np.save(buf, vols)
    req = urllib.request.Request(f"http://127.0.0.1:{port}/predict", data=buf.getvalue(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=300) as resp:
        return np.asarray(json.load(resp)["logits"], np.float32)


def _get(port: int, path: str) -> dict:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=60) as resp:
        return json.load(resp)


def _forward(model, vols: np.ndarray) -> torch.Tensor:
    with torch.inference_mode():
        return model(torch.from_numpy(vols).cuda()).float()


def _served_vs_direct(server: InferenceServer, requests: list, answers: list) -> float:
    """Max |served − direct| over the answers: each request's logits against
    a direct forward of the server's model at the same bucket shape."""
    diff = 0.0
    for vols, got in zip(requests, answers):
        bucket = next(b for b in server.buckets if b >= vols.shape[0])
        padded = np.concatenate([vols, np.zeros((bucket - vols.shape[0], *vols.shape[1:]),
                                                np.float32)])
        want = _forward(server.model, padded)[:vols.shape[0]].cpu().numpy()
        diff = max(diff, float(np.abs(got - want).max()))
    return diff


def _profile(model, x: torch.Tensor) -> dict:
    """One forward under torch.profiler (see ``_profiled``)."""
    with torch.inference_mode():
        model(x)
        torch.cuda.synchronize()
        return _profiled(lambda: model(x))


def _profiled(fn, marks: dict[str, tuple[str, ...]] | None = None) -> dict:
    """One call of fn under torch.profiler: device time by kernel, the
    device's busy time against the call's wall time (its idle share), and
    for each label of ``marks`` the device time of the kernels whose names
    hold one of its marks."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = _kernel_rows(prof)
    PROFILER_LOG["sessions"] += 1
    PROFILER_LOG["empty"] += not rows
    busy = sum(r[1] for r in rows)
    rows.sort(key=lambda r: -r[1])
    by_layer: dict[str, float] = {}
    for key, ms, _ in rows:
        layer = next((name for name, marks in PROFILE_LAYERS if any(m in key for m in marks)),
                     "other")
        by_layer[layer] = by_layer.get(layer, 0.0) + ms
    return {"device_ms_total": busy, "wall_ms": wall_ms,
            "idle_share": max(0.0, 1.0 - busy / wall_ms),
            "kernel_launches": sum(r[2] for r in rows),
            "device_ms_by_layer": dict(sorted(by_layer.items(), key=lambda kv: -kv[1])),
            "device_ms_marked": {label: sum(ms for key, ms, _ in rows
                                            if any(m in key for m in ms_marks))
                                 for label, ms_marks in (marks or {}).items()},
            "top": [{"kernel": k[:80], "ms": ms, "calls": c} for k, ms, c in rows[:8]]}


def phase_serve(tmp: Path) -> dict:
    cfg = live_config(use_flash=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    source = ModelCross(cfg, device="cuda", generator=g)
    n_params = source.num_params()
    check(abs(n_params - LIVE_PARAMS) < 0.05e6, f"{n_params} params, expected 241.9M")
    ckpt = tmp / "epoch=00-val_loss=0.0000.npz"
    t0 = time.perf_counter()
    save_pytree(ckpt, {"params": jax_params_from_model(source), "epoch": np.zeros((), np.int32)})
    save_config(tmp, cfg)
    write_s = time.perf_counter() - t0
    del source
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    server = InferenceServer(ckpt, img_types=MODALITIES, buckets=(1, 2, 4, 8), device="cuda")
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    httpd = serve(server, host="127.0.0.1", port=0)     # warms up every bucket, starts
    warmup_s = time.perf_counter() - t0
    port = httpd.server_address[1]
    http_thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    http_thread.start()
    rng = np.random.default_rng(0)
    img = tuple(cfg.img_size)
    requests = [(rng.normal(size=(b, len(MODALITIES), 1, *img)) * 100).astype(np.float32)
                for b in REQUEST_SIZES]
    answers = []
    try:
        health = _get(port, "/healthz")
        check(health["status"] == "ok" and health["params"] == n_params, f"healthz: {health}")
        forwards_before = len(server.stats["device_ms"])
        fa.flash_attention_qkv.launches = 0
        for i, vols in enumerate(requests):
            answers.append(_post_predict(port, vols) if i == 0 else server.predict(vols))
        launches = fa.flash_attention_qkv.launches
        forwards = len(server.stats["device_ms"]) - forwards_before
        stats = _get(port, "/stats")
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.stop()
    check(not server._dispatcher.is_alive(), "dispatcher thread did not stop")

    for vols, got in zip(requests, answers):
        check(got.shape == (vols.shape[0], cfg.num_classes), f"logits shape {got.shape}")
        check(bool(np.isfinite(got).all()), "non-finite logits")
    check(forwards == len(requests), f"{forwards} bucket forwards for {len(requests)} requests")
    check(launches == 12 * forwards,
          f"kernel launched {launches} times in {forwards} bucket forwards (12 each expected)")

    model = server.model
    direct_diff = _served_vs_direct(server, requests, answers)
    check(direct_diff == 0.0, f"served logits differ from a direct forward by {direct_diff}")

    # kernel path against the plain path (and both against f32) at bucket 8
    b8 = requests[2]
    flash8 = torch.from_numpy(answers[2])
    plain = ModelCross(live_config(use_flash=False), device="cuda")
    plain.load_state_dict(model.state_dict())
    plain8 = _forward(plain, b8).cpu()
    del plain
    cfg32 = live_config(use_flash=False)
    modify_config(cfg32, {"compute_dtype": "float32", "activation_dtype": "float32"})
    ref32 = ModelCross(cfg32, device="cuda")
    ref32.load_state_dict(model.state_dict())
    f32_8 = _forward(ref32, b8).cpu()
    del ref32
    torch.cuda.empty_cache()
    scale = plain8.abs().max().item()
    flash_vs_plain = (flash8 - plain8).abs().max().item() / scale
    check(flash_vs_plain <= SERVE_TOL,
          f"bucket-8 logits: kernel path vs plain path {flash_vs_plain:.3e} > {SERVE_TOL}")

    bucket_ms = {}
    for b in server.buckets:
        x = torch.from_numpy(requests[2][:b]).cuda()
        with torch.inference_mode():
            bucket_ms[b] = cuda_ms(lambda: model(x), runs=5, calls=5)
    profiles = {str(b): _profile(model, torch.from_numpy(requests[2][:b]).cuda())
                for b in (1, 8)}

    # what serving would pay for holding f32 masters and casting the GEMM
    # weights on every call, as the training model does, at bucket 8
    masters = ModelCross(cfg, device="cuda", master_weights=True)
    masters.load_state_dict(model.state_dict())
    x8 = torch.from_numpy(b8).cuda()
    with torch.inference_mode():
        weights_ms = {"cast_once_device_ms": device_ms(lambda: model(x8), calls=5),
                      "f32_masters_device_ms": device_ms(lambda: masters(x8), calls=5),
                      "cast_once_ms": bucket_ms[8],
                      "f32_masters_ms": cuda_ms(lambda: masters(x8), runs=5, calls=5)}
    del masters
    torch.cuda.empty_cache()

    result = {"phase": "serve", "model": "ModelCross", "params": n_params,
              "streams": len(MODALITIES), "hidden": cfg.hidden_dim, "heads": cfg.num_heads,
              "tokens": server.model.pos_embedding.shape[1], "dtype": "bfloat16", "gelu": "tanh",
              "requests": len(requests), "request_sizes": list(REQUEST_SIZES),
              "http_requests": 1, "answered": len(answers), "bucket_forwards": forwards,
              "kernel_launches": launches, "launches_per_forward": launches / forwards,
              "served_vs_direct_max_abs": direct_diff,
              "flash_vs_plain_norm": flash_vs_plain, "tol": SERVE_TOL,
              "flash_vs_f32_norm": (flash8 - f32_8).abs().max().item() / f32_8.abs().max().item(),
              "plain_vs_f32_norm": (plain8 - f32_8).abs().max().item() / f32_8.abs().max().item(),
              "logit_max_abs": scale,
              "ms_per_bucket_forward": {str(b): ms for b, ms in bucket_ms.items()},
              "bucket8_by_weight_storage": weights_ms,
              "server_device_ms": stats["device_ms"], "server_transfer_ms": stats["transfer_ms"],
              "server_latency_ms": stats["latency_ms"],
              "checkpoint_write_s": write_s, "server_load_s": load_s, "warmup_s": warmup_s,
              "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9,
              "profile": profiles}
    emit(result)
    return result


# each kernel's launch count: (wrapper, attribute)
_COUNTERS = {"K1": (fa.flash_attention_qkv, "launches"),
             "K2": (fa.flash_attention_qkv_bwd, "launches"),
             "K3": (rs.resample_axis_windowed_batched, "launches"),
             "K4": (rs.resample_axis_windowed_batched, "full_launches"),
             "K5F": (fa.flash_attention_single_fwd, "launches"),
             "K5DQ": (fa.flash_attention_single_bwd, "dq_launches"),
             "K5DKV": (fa.flash_attention_single_bwd, "dkdv_launches"),
             "K7F": (fa.flash_attention_stream_fwd, "launches"),
             "K7DQ": (fa.flash_attention_stream_bwd, "dq_launches"),
             "K7DKV": (fa.flash_attention_stream_bwd, "dkdv_launches"),
             "K6F": (fa.flash_attention_tn_fwd, "launches"),
             "K6DQ": (fa.flash_attention_tn_bwd, "dq_launches"),
             "K6DKV": (fa.flash_attention_tn_bwd, "dkdv_launches"),
             "K8": (fa.fused_qkv_bwd, "launches")}


def _counts() -> dict:
    return {name: getattr(fn, attr) for name, (fn, attr) in _COUNTERS.items()}


def _zero_counts() -> None:
    for fn, attr in _COUNTERS.values():
        setattr(fn, attr, 0)


def _run_steps(step, img: torch.Tensor, labels: torch.Tensor, lr_at, host_gen) -> tuple:
    """TRAIN_STEPS train steps from launch counts of 0: per step the loss,
    the ms by CUDA events, the kernel launches and the volumes that drew the
    affine."""
    losses, step_ms, per_step, affine_drawn = [], [], [], []
    _zero_counts()
    for i in range(TRAIN_STEPS):
        counts0 = _counts()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        aux = step(img, labels, lr_at(i), host_gen)
        end.record()
        end.synchronize()
        step_ms.append(start.elapsed_time(end))
        losses.append(float(aux["loss"]))
        per_step.append({k: v - counts0[k] for k, v in _counts().items()})
        affine_drawn.append(step.augmented.get("affine", 0))
    return losses, step_ms, per_step, affine_drawn


def _grads_after_step(cfg, state: dict, img: torch.Tensor, labels: torch.Tensor,
                      model_cls=ModelCross, aux_out: dict | None = None
                      ) -> dict[str, torch.Tensor]:
    """The f32 gradient of every parameter after one train step of a model
    built from ``cfg`` and loaded with the f32 masters ``state``; the step's
    aux dict goes into ``aux_out`` when given."""
    model = model_cls(cfg, device="cuda", master_weights=True)
    model.load_state_dict(state)
    step = make_train_step(model, Adam(model.parameters(), cfg.weight_decay), cfg)
    aux = step(img, labels, cfg.lr, torch.Generator().manual_seed(0))
    check(bool(torch.isfinite(aux["loss"])), "non-finite loss in the comparison step")
    if aux_out is not None:
        aux_out.update(aux)
    grads = {name: p.grad.float() for name, p in model.named_parameters()}
    del model, step
    torch.cuda.empty_cache()
    return grads


def _leaf_errs(got: dict, want: dict) -> dict[str, float]:
    """Per parameter: max |got − want| over the leaf, normalised by the
    leaf's own max |want|."""
    return {name: _norm_err(got[name], w)[1] for name, w in want.items()}


def _by_kind(*errs: dict) -> dict[str, list[float]]:
    """The worst leaf of each parameter kind (the name with its block and
    stream indices replaced by *), one value per reading in ``errs``."""
    kinds: dict[str, list[float]] = {}
    for name in errs[0]:
        parts = name.split(".")
        kind = ".".join("*" if p.isdigit() and (parts[i - 1] in _INDEXED or parts[i - 2] == "blocks")
                        else p for i, p in enumerate(parts))
        row = kinds.setdefault(kind, [0.0] * len(errs))
        for j, e in enumerate(errs):
            row[j] = max(row[j], e[name])
    return kinds


def phase_train() -> dict:
    cfg = live_config(use_flash=True)
    torch.cuda.reset_peak_memory_stats()
    model = ModelCross(cfg, device="cuda", generator=torch.Generator(device="cuda").manual_seed(0),
                       master_weights=True)
    n_params = model.num_params()
    check(abs(n_params - LIVE_PARAMS) < 0.05e6, f"{n_params} params, expected 241.9M")
    optimizer = Adam(model.parameters(), weight_decay=cfg.weight_decay)
    step = make_train_step(model, optimizer, cfg)
    op = cfg.optim_params
    lr_at = cosine_annealing_lr(cfg.lr, op["T_max"], op["eta_min"])
    rng = np.random.default_rng(1)
    img = torch.from_numpy((rng.normal(size=(8, len(MODALITIES), 1, *cfg.img_size)) * 100)
                           .astype(np.float32)).cuda()
    labels = torch.tensor([0, 1] * 4, device="cuda")
    # the seeded masters, kept on the host (out of the peak memory): the
    # gradient comparison below starts from them
    state0 = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    host_gen = torch.Generator().manual_seed(TRAIN_SEED)

    losses, step_ms, per_step, affine_drawn = _run_steps(step, img, labels, lr_at, host_gen)
    launches = _counts()
    changed = max((p.detach() - state0[name].cuda()).abs().max().item()
                  for name, p in model.named_parameters())
    check(all(np.isfinite(losses)), f"non-finite training loss: {losses}")
    check(changed > 0, "the parameters did not change over the training steps")
    for i, (c, drawn) in enumerate(zip(per_step, affine_drawn)):
        check(c["K1"] == 12 and c["K2"] == 12,
              f"step {i}: K1 launched {c['K1']}, K2 {c['K2']} times (12 each expected)")
        check(c["K3"] == (4 if drawn else 0) and c["K4"] == 0,
              f"step {i}: K3 launched {c['K3']} times with {drawn} affine volumes")
    check(launches["K3"] > 0, "no step drew the affine: K3 never ran on the training path")

    # augmentation and trunk apart: the pipeline alone on the same batch, and
    # steps of the same model with augmentation off
    aug_gen = torch.Generator().manual_seed(TRAIN_SEED + 1)
    bf16_img = img.to(torch.bfloat16)
    aug_ms = cuda_ms(lambda: augment.augment_batch(bf16_img, aug_gen), runs=5, calls=2, warmup=1)
    trunk_cfg = live_config(use_flash=True)
    trunk_cfg.img_aug = False
    trunk_step = make_train_step(model, optimizer, trunk_cfg)
    trunk_ms = cuda_ms(lambda: trunk_step(img, labels, lr_at(0), host_gen), runs=3, calls=2,
                       warmup=1)
    profile = _profiled(lambda: step(img, labels, lr_at(0), host_gen))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del model, optimizer, step, trunk_step
    torch.cuda.empty_cache()

    # the kernel path against the plain path, one step at dropout 0 without
    # augmentation from the seeded f32 masters and the same batch, both
    # beside f32; each parameter's gradient is normalised by its own maximum
    def cmp_cfg(use_flash: bool, dtype: str = "bfloat16"):
        c = live_config(use_flash)
        modify_config(c, {"dropout": 0.0, "img_aug": False, "compute_dtype": dtype,
                          "activation_dtype": dtype})
        return c
    _zero_counts()
    g_flash = _grads_after_step(cmp_cfg(True), state0, img, labels)
    cmp_launches = _counts()
    # the same step with the fused QKV-projection backward (K8)
    fa.FUSED_QKV_GRADS = True
    try:
        _zero_counts()
        g_fused = _grads_after_step(cmp_cfg(True), state0, img, labels)
        fused_launches = _counts()
    finally:
        fa.FUSED_QKV_GRADS = False
    g_plain = _grads_after_step(cmp_cfg(False), state0, img, labels)
    g_f32 = _grads_after_step(cmp_cfg(False, "float32"), state0, img, labels)
    del state0
    check(cmp_launches["K1"] == 12 and cmp_launches["K2"] == 12 and cmp_launches["K8"] == 0,
          f"comparison step launches {cmp_launches}")
    check(fused_launches["K1"] == 12 and fused_launches["K8"] == 12
          and fused_launches["K2"] == 0,
          f"comparison step with FUSED_QKV_GRADS on: launches {fused_launches}")
    flash_vs_plain = _leaf_errs(g_flash, g_plain)
    fused_vs_plain, fused_vs_flash = _leaf_errs(g_fused, g_plain), _leaf_errs(g_fused, g_flash)
    flash_vs_f32, plain_vs_f32 = _leaf_errs(g_flash, g_f32), _leaf_errs(g_plain, g_f32)
    gated = [n for n in flash_vs_plain if not n.endswith(ZERO_GRAD_LEAF)]
    worst = max(gated, key=flash_vs_plain.get)
    # the skipped leaves' largest gradient beside their key weight's
    key_bias_rel = max(g_flash[n].abs().max().item()
                       / g_flash[n[:-len("bias")] + "weight"].abs().max().item()
                       for n in flash_vs_plain if n.endswith(ZERO_GRAD_LEAF))
    worst_fused = max(gated, key=fused_vs_plain.get)
    del g_flash, g_fused, g_plain, g_f32
    torch.cuda.empty_cache()

    result = {"phase": "train", "model": "ModelCross", "params": n_params, "batch": 8,
              "streams": len(MODALITIES), "hidden": cfg.hidden_dim, "heads": cfg.num_heads,
              "dtype": "bfloat16", "augment_dtype": cfg.augment_dtype, "dropout": cfg.dropout,
              "steps": TRAIN_STEPS, "losses": losses, "max_param_change": changed,
              "launches": launches, "launches_per_step": per_step,
              "affine_volumes_per_step": affine_drawn,
              "step_ms": step_ms, "step_ms_steady": statistics.median(step_ms[1:]),
              "augment_ms": aug_ms, "trunk_ms": trunk_ms, "profile": profile,
              "peak_device_gb": peak_gb, "grad_leaves": len(flash_vs_plain),
              "grad_leaves_gated": len(gated),
              "grad_flash_vs_plain_worst_leaf": [worst, flash_vs_plain[worst]], "tol": SERVE_TOL,
              "grad_flash_vs_f32_worst_leaf": max(flash_vs_f32[n] for n in gated),
              "grad_plain_vs_f32_worst_leaf": max(plain_vs_f32[n] for n in gated),
              "grad_key_bias_vs_key_weight": key_bias_rel,
              "fused_qkv_grads": {"launches": fused_launches,
                                  "grad_fused_vs_plain_worst_leaf":
                                      [worst_fused, fused_vs_plain[worst_fused]],
                                  "grad_fused_vs_unfused_worst_leaf":
                                      max(fused_vs_flash[n] for n in gated)},
              # [kernel vs plain, kernel vs f32, plain vs f32] per parameter kind
              "grad_by_kind": _by_kind(flash_vs_plain, flash_vs_f32, plain_vs_f32)}
    emit(result)
    check(flash_vs_plain[worst] <= SERVE_TOL,
          f"gradient of {worst}: kernel path vs plain path {flash_vs_plain[worst]:.3e} "
          f"> {SERVE_TOL}")
    check(fused_vs_plain[worst_fused] <= SERVE_TOL,
          f"gradient of {worst_fused}: FUSED_QKV_GRADS path vs plain path "
          f"{fused_vs_plain[worst_fused]:.3e} > {SERVE_TOL}")
    return result


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _gloo_ranks(flag: str, world: int, tmp: Path, name: str,
                timeout_s: float) -> list[dict]:
    """``world`` processes of ``chip_smoke.py <flag> rank world port tmp``
    sharing the card over gloo (NCCL refuses two ranks on one card); each
    writes ``<name>_rank<r>.json``."""
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), flag, str(rank),
                               str(world), str(port), str(tmp)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for rank in range(world)]
    errs = []
    try:
        for p in procs:
            errs.append(p.communicate(timeout=timeout_s)[1])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, err) in enumerate(zip(procs, errs)):
        check(p.returncode == 0, f"{name} rank {rank} exited {p.returncode}:\n{err[-4000:]}")
    return [json.loads((tmp / f"{name}_rank{r}.json").read_text()) for r in range(world)]


def _dp_cmp_cfg():
    """The live configuration at dropout 0 without augmentation: the
    comparison steps of phase train_dp."""
    cfg = live_config(use_flash=True)
    modify_config(cfg, {"dropout": 0.0, "img_aug": False})
    return cfg


def _train_batch(cfg) -> tuple[torch.Tensor, torch.Tensor]:
    """Phase train's batch of 8 (the same seed), on the card."""
    rng = np.random.default_rng(1)
    img = torch.from_numpy((rng.normal(size=(8, len(MODALITIES), 1, *cfg.img_size)) * 100)
                           .astype(np.float32)).cuda()
    return img, torch.tensor([0, 1] * 4, device="cuda")


def _full_grads(trainer) -> dict[str, torch.Tensor]:
    """Every parameter's gradient, whole (FSDP shards, experts split over
    'expert', TP slices and the other stages' layers gathered: a
    collective)."""
    model = unwrap(trainer.model)
    return {n: g.float() for n, g in whole_tensors(
        model, {n: full_tensor(p.grad) for n, p in model.named_parameters()}).items()}


def _timed_step(step, img, labels, lr: float, gen) -> tuple[dict, float]:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    aux = step(img, labels, lr, gen)
    end.record()
    end.synchronize()
    return aux, start.elapsed_time(end)


def phase_train_dp(tmp: Path) -> dict:
    """The live ModelCross through ``Trainer(mesh=...)``: (a) at world size 1
    over NCCL in this process, with no mesh, under DDP and under FSDP —
    ``TRAIN_STEPS`` steps with augmentation and dropout, then one step at
    dropout 0 without augmentation from the seeded masters, each mesh's
    gradients against the no-mesh step's; (b) two gloo ranks sharing the
    card under DDP, batch 4 each (``dp_worker``)."""
    cfg = live_config(use_flash=True)
    op = cfg.optim_params
    lr_at = cosine_annealing_lr(cfg.lr, op["T_max"], op["eta_min"])
    img, labels = _train_batch(cfg)
    multihost_init(f"127.0.0.1:{_free_port()}", 1, 0, device="cuda", timeout_s=DP_TIMEOUT_S)
    modes, grads, cmp_launches = {}, {}, {}
    try:
        mesh = make_mesh(1)
        check(mesh.device_type == "cuda" and torch.distributed.get_backend() == "nccl",
              f"world-1 mesh on {mesh.device_type} over {torch.distributed.get_backend()}")
        for mode, mesh_kw in (("none", {}), ("ddp", {"mesh": mesh}),
                              ("fsdp", {"mesh": mesh, "fsdp": True})):
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            t = Trainer(ModelCross, cfg, max_epochs=1, device="cuda", **mesh_kw).init_state()
            before = {n: full_tensor(p).detach().clone()
                      for n, p in unwrap(t.model).named_parameters()}
            losses, step_ms, per_step, affine = _run_steps(t.train_step, img, labels, lr_at,
                                                           torch.Generator().manual_seed(TRAIN_SEED))
            launches = _counts()
            changed = max((full_tensor(p).detach() - before[n]).abs().max().item()
                          for n, p in unwrap(t.model).named_parameters())
            sharded = sum(isinstance(p, DTensor) for p in t.model.parameters())
            modes[mode] = {"losses": losses, "step_ms": step_ms,
                           "step_ms_steady": statistics.median(step_ms[1:]),
                           "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9,
                           "max_param_change": changed, "launches": launches,
                           "launches_per_step": per_step, "affine_volumes_per_step": affine,
                           "dtensor_params": sharded}
            del t, before
            check(all(np.isfinite(losses)), f"{mode}: non-finite training loss {losses}")
            check(changed > 0, f"{mode}: the parameters did not change")
            for i, c in enumerate(per_step):
                check(c["K1"] == 12 and c["K2"] == 12,
                      f"{mode} step {i}: K1 launched {c['K1']}, K2 {c['K2']} times")
            check(launches["K3"] > 0, f"{mode}: no step drew the affine (K3 never ran)")
            # the comparison step from the same seeded masters
            gc.collect()
            torch.cuda.empty_cache()
            t = Trainer(ModelCross, _dp_cmp_cfg(), max_epochs=1, device="cuda",
                        **mesh_kw).init_state()
            _zero_counts()
            aux, _ = _timed_step(t.train_step, img, labels, cfg.lr, torch.Generator().manual_seed(0))
            cmp_launches[mode] = _counts()
            check(bool(torch.isfinite(aux["loss"])), f"{mode}: non-finite comparison loss")
            grads[mode] = _full_grads(t)
            del t
        check(modes["fsdp"]["dtensor_params"] > 0, "FSDP sharded no parameter")
    finally:
        torch.distributed.destroy_process_group()
    errs = {mode: _leaf_errs(grads[mode], grads["none"]) for mode in ("ddp", "fsdp")}
    torch.save({n: g.cpu() for n, g in grads["none"].items()}, tmp / "grads_one_process.pt")
    del grads
    gc.collect()
    torch.cuda.empty_cache()
    gloo = _two_gloo_ranks(tmp)
    result = {"phase": "train_dp", "model": "ModelCross", "batch": 8,
              "nccl_world_1": {m: {k: v for k, v in r.items() if k != "launches_per_step"}
                               for m, r in modes.items()},
              "grad_vs_no_mesh_worst_leaf": {m: max(e.values()) for m, e in errs.items()},
              "comparison_launches": cmp_launches, "tol": SERVE_TOL,
              "gloo_two_ranks": gloo}
    emit(result)
    for mode, e in errs.items():
        gated = {n: v for n, v in e.items() if not n.endswith(ZERO_GRAD_LEAF)}
        worst = max(gated, key=gated.get)
        check(gated[worst] <= SERVE_TOL, f"{mode}: gradient of {worst} vs the no-mesh step "
                                         f"{gated[worst]:.3e} > {SERVE_TOL}")
    for mode, c in cmp_launches.items():
        check(c["K1"] == 12 and c["K2"] == 12, f"{mode} comparison step launches {c}")
    return result


def _two_gloo_ranks(tmp: Path) -> dict:
    """Phase train_dp (b): ``dp_worker`` in two processes on this card."""
    ranks = _gloo_ranks("--dp-worker", 2, tmp, "dp", DP_TIMEOUT_S)
    check(ranks[0]["param_sha256"] == ranks[1]["param_sha256"],
          "the two gloo ranks' parameters differ after the steps")
    for r, got in enumerate(ranks):
        check(got["grad_vs_one_process_worst_gated"] <= SERVE_TOL,
              f"gloo rank {r}: gradient vs the one-process batch-8 step "
              f"{got['grad_vs_one_process_worst_gated']:.3e} > {SERVE_TOL}")
        check(all(c["K1"] == 12 and c["K2"] == 12 for c in got["launches_per_step"]),
              f"gloo rank {r}: launches {got['launches_per_step']}")
    return {"ranks": ranks, "params_identical": True}


def dp_worker(rank: int, world: int, port: int, tmp: Path) -> int:
    """One of phase train_dp's two gloo ranks on cuda:0: ``DP_STEPS`` DDP
    steps of batch 4 at dropout 0 without augmentation from the seeded
    masters; the first step's gradients against the one-process batch-8
    step's; a digest of the parameters; then steps with and without the
    gradient all-reduce, for its share of the step."""
    multihost_init(f"127.0.0.1:{port}", world, rank, backend="gloo", device="cuda",
                   timeout_s=DP_TIMEOUT_S)
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        cfg = _dp_cmp_cfg()
        mesh = make_mesh(2)
        t = Trainer(ModelCross, cfg, max_epochs=1, mesh=mesh, device="cuda").init_state()
        img, labels = shard_batch(_train_batch(cfg), mesh)     # this rank's 4 of the 8
        want = torch.load(tmp / "grads_one_process.pt", map_location="cuda")
        _zero_counts()
        losses, step_ms, per_step = [], [], []
        for s in range(DP_STEPS):
            counts0 = _counts()
            aux, ms = _timed_step(t.train_step, img, labels, cfg.lr,
                                  torch.Generator().manual_seed(s))
            losses.append(float(aux["loss"]))
            step_ms.append(ms)
            per_step.append({k: v - counts0[k] for k, v in _counts().items()})
            if s == 0:
                errs = _leaf_errs(_full_grads(t), want)
                del want
        launches = _counts()
        digest = hashlib.sha256()
        for p in t.model.parameters():
            digest.update(p.detach().cpu().numpy().tobytes())
        # the step with and without the gradient all-reduce, in turns
        synced, unsynced = [], []
        for sync in (True, False, True, False, True, False):
            with contextlib.nullcontext() if sync else t.model.no_sync():
                _, ms = _timed_step(t.train_step, img, labels, cfg.lr,
                                    torch.Generator().manual_seed(0))
            (synced if sync else unsynced).append(ms)
        gated = [v for n, v in errs.items() if not n.endswith(ZERO_GRAD_LEAF)]
        sync_ms, nosync_ms = statistics.median(synced), statistics.median(unsynced)
        (tmp / f"dp_rank{rank}.json").write_text(json.dumps({
            "rank": rank, "backend": torch.distributed.get_backend(), "device": str(t.device),
            "batch": 4, "losses": losses, "step_ms": step_ms,
            "grad_vs_one_process_worst_leaf": max(errs.values()),
            "grad_vs_one_process_worst_gated": max(gated),
            "param_sha256": digest.hexdigest(), "launches": launches,
            "launches_per_step": per_step, "step_ms_synced": sync_ms,
            "step_ms_without_grad_allreduce": nosync_ms,
            "grad_allreduce_share": 1.0 - nosync_ms / sync_ms}))
        check(all(np.isfinite(losses)), f"gloo rank {rank}: non-finite loss {losses}")
    finally:
        torch.distributed.destroy_process_group()
    return 0


def _vit_expected(tokens: int, per: int) -> dict:
    """Kernel launches of ``per`` attention layers: K1/K2 up to the switch,
    K7 above it (the same rule as the JAX package's)."""
    short = tokens <= fa._SINGLE_BLOCK_MAX
    return {"K1": per * short, "K2": per * short, "K7F": per * (not short),
            "K7DQ": per * (not short), "K7DKV": per * (not short)}


def phase_serve_vit(tmp: Path) -> dict:
    """Both ModelVIT configurations served from a JAX-layout checkpoint."""
    results = {}
    for name, streams, want_params, tokens in VIT_CONFIGS:
        cfg = vit_config(streams, use_flash=True)
        source = ModelVIT(cfg, device="cuda", generator=torch.Generator(device="cuda").manual_seed(0))
        n_params = source.num_params()
        check(n_params == want_params, f"{name}: {n_params} params, expected {want_params}")
        check(source.pos_embedding.shape[1] == tokens, f"{name}: {source.pos_embedding.shape}")
        sub = tmp / name
        sub.mkdir()
        ckpt = sub / "epoch=00-val_loss=0.0000.npz"
        save_pytree(ckpt, {"params": jax_params_from_model(source),
                           "epoch": np.zeros((), np.int32)})
        save_config(sub, cfg)
        del source
        torch.cuda.empty_cache()

        rng = np.random.default_rng(10 + len(streams))
        requests = [(rng.normal(size=(b, len(streams), 1, *cfg.img_size)) * 100)
                    .astype(np.float32) for b in REQUEST_SIZES]
        server, answers, counts, forwards = _serve_mode(ckpt, "vit", streams, None, (1, 2, 4, 8),
                                                        requests, http=False)
        health = server.health()
        check(health["model"] == "vit" and health["params"] == n_params, f"healthz: {health}")
        want = _vit_expected(tokens, cfg.num_layers)
        per_forward = {k: counts[k] / forwards for k in ("K1", "K7F")}
        check(per_forward == {k: want[k] for k in per_forward},
              f"{name}: launches per bucket forward {per_forward}, expected K1 {want['K1']}, "
              f"K7 forward {want['K7F']}")
        model = server.model
        b8 = requests[2]
        flash8 = torch.from_numpy(answers[2])
        plain = ModelVIT(vit_config(streams, use_flash=False), device="cuda")
        plain.load_state_dict(model.state_dict())
        plain8 = _forward(plain, b8).cpu()
        del plain
        torch.cuda.empty_cache()
        flash_vs_plain = (flash8 - plain8).abs().max().item() / plain8.abs().max().item()
        x8 = torch.from_numpy(b8).cuda()
        with torch.inference_mode():
            ms8 = cuda_ms(lambda: model(x8), runs=3, calls=3)
        profile = _profile(model, x8)
        result = {"phase": "serve_vit", "config": name, "model": "ModelVIT", "params": n_params,
                  "streams": list(streams), "tokens": tokens, "layers": cfg.num_layers,
                  "hidden": cfg.hidden_dim, "heads": cfg.num_heads, "dtype": "bfloat16",
                  "gelu": "tanh", "requests": len(requests), "bucket_forwards": forwards,
                  "launches": counts, "launches_per_forward": per_forward,
                  "flash_vs_plain_norm": flash_vs_plain,
                  "tol": SERVE_TOL, "bucket8_ms": ms8, "profile_bucket8": profile,
                  "server_device_ms": server.stats_view()["device_ms"]}
        emit(result)
        check(flash_vs_plain <= SERVE_TOL,
              f"{name} bucket-8 logits: kernel path vs plain path {flash_vs_plain:.3e} "
              f"> {SERVE_TOL}")
        del server, model, x8
        torch.cuda.empty_cache()
        results[name] = result
    return results


def _in_turns(models: dict, x: torch.Tensor) -> dict:
    """Device ms per forward of each model on x, timed in turns (the models
    in order, then in reverse) and averaged over both readings, with one
    profiled forward each for the idle share."""
    order = list(models) + list(models)[::-1]
    readings: dict[str, list[float]] = {name: [] for name in models}
    with torch.inference_mode():
        for name in order:
            readings[name].append(device_ms(lambda: models[name](x), calls=5))
    return {name: {"device_ms": statistics.mean(ms), "readings": ms,
                   "profile": _profile(models[name], x)}
            for name, ms in readings.items()}


def _int8_gemm_timing() -> dict:
    """One FFN GEMM of the ModelCross bucket-8 forward, (8·513, 1024) ×
    (1024, 4096): torch._int_mm with its rescale, the whole ``qlinear``
    (with the dynamic activation quantization), the bf16 GEMM alone and the
    port's float ``linear`` (f32 output, bias, one cast)."""
    M, K, N = FFN_GEMM
    g = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn((M, K), generator=g, device="cuda").to(torch.bfloat16)
    w = torch.randn((N, K), generator=g, device="cuda") * K ** -0.5
    bias = torch.zeros(N, device="cuda")
    layer = QuantLinear(*quantize_weight(w), bias)
    wb = w.to(torch.bfloat16)
    xq, xs = dynamic_quantize(x)
    exact = layer.int_mm(xq)
    check(torch.equal(exact, (xq.double() @ layer.weight_q.double().t()).int()),
          "torch._int_mm differs from the exact integer product")
    return {"shape": list(FFN_GEMM),
            "int8_gemm_rescale_ms": device_ms(
                lambda: layer.int_mm(xq).float() * (xs * layer.weight_scale)),
            "qlinear_ms": device_ms(lambda: qlinear(x, layer)),
            "bf16_gemm_ms": device_ms(lambda: torch.matmul(x, wb.t())),
            "bf16_linear_ms": device_ms(lambda: linear(x, wb, bias))}


def _serve_mode(ckpt: Path, family: str, streams: tuple, mode: str | None, buckets: tuple,
                requests: list, http: bool) -> tuple:
    """A server of ``ckpt`` under ``mode``, asked ``requests`` (the first
    over HTTP when ``http``) from launch counts of 0.  Returns (server,
    answers, counts, bucket forwards); the server is stopped."""
    server = InferenceServer(ckpt, family, img_types=streams, buckets=buckets, quantize=mode,
                             device="cuda")
    httpd = serve(server, host="127.0.0.1", port=0)    # warms up every bucket, starts
    port = httpd.server_address[1]
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        forwards_before = len(server.stats["device_ms"])
        _zero_counts()
        answers = [_post_predict(port, vols) if http and i == 0 else server.predict(vols)
                   for i, vols in enumerate(requests)]
        counts = _counts()
        forwards = len(server.stats["device_ms"]) - forwards_before
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.stop()
    check(not server._dispatcher.is_alive(), "dispatcher thread did not stop")
    check(forwards == len(requests), f"{forwards} bucket forwards for {len(requests)} requests")
    for vols, got in zip(requests, answers):
        check(got.shape == (vols.shape[0], 2) and bool(np.isfinite(got).all()),
              f"{family} {mode}: logits {got.shape}, finite {np.isfinite(got).all()}")
    direct_diff = _served_vs_direct(server, requests, answers)
    check(direct_diff == 0.0, f"{family} {mode}: served logits differ from a direct forward "
                              f"by {direct_diff}")
    return server, answers, counts, forwards


def _plain_logits(ckpt: Path, family: str, streams: tuple, mode: str, vols: np.ndarray):
    """Bucket logits of the plain path (impl 'xla': ``_sdpa`` and K1's plain
    GEMMs) with the same quantized weights."""
    plain = InferenceServer(ckpt, family, img_types=streams, quantize=mode, device="cuda",
                            config_overrides={"use_flash_attention": False})
    logits = _forward(plain.model, vols).cpu()
    del plain
    torch.cuda.empty_cache()
    return logits


def phase_serve_int8(tmp: Path) -> dict:
    """The live ModelCross from phase_serve's checkpoint served under
    quantize="int8" and "int8+attn", then both ModelVITs under int8+attn."""
    ckpt = tmp / "epoch=00-val_loss=0.0000.npz"
    rng = np.random.default_rng(0)          # phase_serve's requests
    requests = [(rng.normal(size=(b, len(MODALITIES), 1, *VOLUME)) * 100).astype(np.float32)
                for b in REQUEST_SIZES]
    b8 = requests[2]
    float_server = InferenceServer(ckpt, img_types=MODALITIES, device="cuda")
    models = {"bf16": float_server.model}
    bf16_8 = _forward(float_server.model, b8).cpu()
    results = {"phase": "serve_int8", "model": "ModelCross", "tol": SERVE_TOL, "modes": {}}
    for mode in ("int8", "int8+attn"):
        server, answers, counts, forwards = _serve_mode(
            ckpt, "cross", MODALITIES, mode, (1, 2, 4, 8), requests, http=True)
        health = server.health()
        check(health["quantize"] == mode and health["quantized_kernels"] == QUANTIZED[mode],
              f"{mode}: healthz {health}")
        per = {k: counts[k] / forwards for k in ("K1", "K5F", "K7F")}
        want = {"K1": 12.0 * (mode == "int8"), "K5F": 12.0 * (mode == "int8+attn"), "K7F": 0.0}
        check(per == want, f"{mode}: launches per bucket forward {per}, expected {want}")
        flash8 = torch.from_numpy(answers[2])
        plain8 = _plain_logits(ckpt, "cross", MODALITIES, mode, b8)
        flash_vs_plain = (flash8 - plain8).abs().max().item() / plain8.abs().max().item()
        n_q, q_bytes = count_quantized(server.model)
        results["modes"][mode] = {
            "quantized_kernels": n_q, "int8_weight_bytes": q_bytes,
            "same_layers_bf16_bytes": 2 * q_bytes,
            "model_weight_bytes": sum(t.numel() * t.element_size()
                                      for t in server.model.state_dict().values()),
            "requests": len(requests), "http_requests": 1, "bucket_forwards": forwards,
            "launches": counts, "launches_per_forward": per,
            "flash_vs_plain_norm": flash_vs_plain,
            "vs_bf16_norm": (flash8 - bf16_8).abs().max().item() / bf16_8.abs().max().item(),
            "argmax_equal_bf16": bool((flash8.argmax(1) == bf16_8.argmax(1)).all()),
            "server_device_ms": server.stats_view()["device_ms"]}
        check(flash_vs_plain <= SERVE_TOL, f"{mode} bucket-8 logits: kernel path vs plain path "
                                           f"{flash_vs_plain:.3e} > {SERVE_TOL}")
        models[mode] = server.model
    results["bf16_model_weight_bytes"] = sum(t.numel() * t.element_size()
                                             for t in float_server.model.state_dict().values())
    results["bucket8_in_turns"] = _in_turns(models, torch.from_numpy(b8).cuda())
    del models, float_server
    gc.collect()
    torch.cuda.empty_cache()
    results["ffn_gemm"] = _int8_gemm_timing()
    emit(results)

    vit = {}
    for name, streams, _, tokens in VIT_CONFIGS:
        vckpt = tmp / name / "epoch=00-val_loss=0.0000.npz"
        vrng = np.random.default_rng(30 + len(streams))
        vreq = [(vrng.normal(size=(b, len(streams), 1, *VOLUME)) * 100).astype(np.float32)
                for b in (1, 8)]
        server, answers, counts, forwards = _serve_mode(
            vckpt, "vit", streams, "int8+attn", (1, 8), vreq, http=False)
        check(server.health()["quantized_kernels"] == VIT_QUANTIZED,
              f"{name}: healthz {server.health()}")
        per = {k: counts[k] / forwards for k in ("K1", "K5F", "K7F")}
        short = tokens <= fa._SINGLE_BLOCK_MAX
        want = {"K1": 0.0, "K5F": 4.0 * short, "K7F": 4.0 * (not short)}
        check(per == want, f"{name} int8+attn: launches per bucket forward {per}, "
                           f"expected {want}")
        plain8 = _plain_logits(vckpt, "vit", streams, "int8+attn", vreq[1])
        flash8 = torch.from_numpy(answers[1])
        flash_vs_plain = (flash8 - plain8).abs().max().item() / plain8.abs().max().item()
        vit[name] = {"phase": "serve_int8_vit", "config": name, "mode": "int8+attn",
                     "tokens": tokens, "quantized_kernels": VIT_QUANTIZED,
                     "bucket_forwards": forwards, "launches": counts,
                     "launches_per_forward": per, "flash_vs_plain_norm": flash_vs_plain,
                     "tol": SERVE_TOL, "server_device_ms": server.stats_view()["device_ms"]}
        emit(vit[name])
        check(flash_vs_plain <= SERVE_TOL, f"{name} int8+attn bucket-8 logits: kernel path vs "
                                           f"plain path {flash_vs_plain:.3e} > {SERVE_TOL}")
        del server
        torch.cuda.empty_cache()
    results["vit"] = vit
    return results


def phase_train_vit() -> dict:
    """Both ModelVIT configurations trained TRAIN_STEPS steps at batch 8."""
    results = {}
    for name, streams, want_params, tokens in VIT_CONFIGS:
        cfg = vit_config(streams, use_flash=True)
        gc.collect()      # what earlier phases dropped, out of this phase's peak
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        model = ModelVIT(cfg, device="cuda", master_weights=True,
                         generator=torch.Generator(device="cuda").manual_seed(1))
        check(model.num_params() == want_params, f"{name}: {model.num_params()} params")
        optimizer = Adam(model.parameters(), weight_decay=cfg.weight_decay)
        step = make_train_step(model, optimizer, cfg)
        op = cfg.optim_params
        lr_at = cosine_annealing_lr(cfg.lr, op["T_max"], op["eta_min"])
        rng = np.random.default_rng(20 + len(streams))
        img = torch.from_numpy((rng.normal(size=(8, len(streams), 1, *cfg.img_size)) * 100)
                               .astype(np.float32)).cuda()
        labels = torch.tensor([0, 1] * 4, device="cuda")
        state0 = {k: v.detach().cpu() for k, v in model.state_dict().items()}
        host_gen = torch.Generator().manual_seed(TRAIN_SEED)

        losses, step_ms, per_step, affine_drawn = _run_steps(step, img, labels, lr_at,
                                                             host_gen)
        launches = _counts()
        changed = max((p.detach() - state0[n].cuda()).abs().max().item()
                      for n, p in model.named_parameters())
        check(all(np.isfinite(losses)), f"{name}: non-finite training loss: {losses}")
        check(changed > 0, f"{name}: the parameters did not change over the training steps")
        want = _vit_expected(tokens, cfg.num_layers)
        for i, (c, drawn) in enumerate(zip(per_step, affine_drawn)):
            got = {k: c[k] for k in want}
            check(got == want, f"{name} step {i}: attention launches {got}, expected {want}")
            check(c["K3"] == (4 if drawn else 0) and c["K4"] == 0,
                  f"{name} step {i}: K3 launched {c['K3']} times with {drawn} affine volumes")
        check(launches["K3"] > 0, f"{name}: no step drew the affine: K3 never ran")
        profile = _profiled(lambda: step(img, labels, lr_at(0), host_gen))
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        del model, optimizer, step
        torch.cuda.empty_cache()

        def cmp_cfg(use_flash: bool):
            c = vit_config(streams, use_flash)
            modify_config(c, {"dropout": 0.0, "img_aug": False})
            return c
        _zero_counts()
        g_flash = _grads_after_step(cmp_cfg(True), state0, img, labels, ModelVIT)
        cmp_launches = _counts()
        aux_plain = {}
        g_plain = _grads_after_step(cmp_cfg(False), state0, img, labels, ModelVIT, aux_plain)
        del state0
        check({k: cmp_launches[k] for k in want} == want,
              f"{name}: comparison step launches {cmp_launches}")
        flash_vs_plain = _leaf_errs(g_flash, g_plain)
        head_bias_own = flash_vs_plain[HEAD_BIAS]
        summand = (aux_plain["probs"] - labels.float()).abs().max().item() / len(labels)
        flash_vs_plain[HEAD_BIAS] = (g_flash[HEAD_BIAS] - g_plain[HEAD_BIAS]).abs().max().item() \
            / summand
        worst = max(flash_vs_plain, key=flash_vs_plain.get)
        del g_flash, g_plain
        torch.cuda.empty_cache()
        result = {"phase": "train_vit", "config": name, "model": "ModelVIT",
                  "params": want_params, "streams": list(streams), "tokens": tokens,
                  "batch": 8, "dtype": "bfloat16", "augment_dtype": cfg.augment_dtype,
                  "dropout": cfg.dropout, "steps": TRAIN_STEPS, "losses": losses,
                  "max_param_change": changed, "launches": launches,
                  "launches_per_step": per_step, "affine_volumes_per_step": affine_drawn,
                  "step_ms": step_ms, "step_ms_steady": statistics.median(step_ms[1:]),
                  "profile": profile, "peak_device_gb": peak_gb,
                  "grad_leaves": len(flash_vs_plain),
                  "grad_flash_vs_plain_worst_leaf": [worst, flash_vs_plain[worst]],
                  "tol": SERVE_TOL, "grad_by_kind": _by_kind(flash_vs_plain),
                  "head_bias_norm_by_own_max": head_bias_own,
                  "head_bias_norm_by_summand": flash_vs_plain[HEAD_BIAS]}
        emit(result)
        check(flash_vs_plain[worst] <= SERVE_TOL,
              f"{name}: gradient of {worst}: kernel path vs plain path "
              f"{flash_vs_plain[worst]:.3e} > {SERVE_TOL}")
        results[name] = result
    return results


def _write_cohort(root: Path, modalities: tuple = MODALITIES, subjects: int = CLI_SUBJECTS,
                  volume: tuple = RAW_VOLUME) -> tuple[Path, Path, list[str]]:
    """``subjects`` subjects of ``modalities`` volumes (default the raw
    UCSF-PDGM size, int16 with a scaling slope, gzipped NIfTI), and a labels
    CSV that also holds one blacklisted ID and one indeterminate row, neither
    on disk.  Returns (labels CSV, data folder, the subjects' folder IDs)."""
    data = root / "ucsf-data"
    data.mkdir(parents=True)
    ids = [f"UCSF-PDGM-{n}" for n in range(1, subjects + 1)]    # unpadded, as the CSV
    rows = [(i, "positive" if j % 2 else "negative") for j, i in enumerate(ids)]
    rows += [("UCSF-PDGM-138", "positive"), ("UCSF-PDGM-500", "indeterminate")]
    labels = root / "labels.csv"
    labels.write_text("ID,MGMT status\n" + "".join(f"{i},{t}\n" for i, t in rows))
    padded = [f"UCSF-PDGM-{n:04d}" for n in range(1, subjects + 1)]

    def write(job):
        j, case, mod = job
        rng = np.random.default_rng(j)
        (data / f"{case}_nifti").mkdir(parents=True, exist_ok=True)
        vol = rng.integers(0, 1200, size=volume, dtype=np.int16)
        write_volume(data / f"{case}_nifti" / f"{case}_{mod}.nii.gz", vol, scl_slope=0.5)

    jobs = [(j, c, m) for j, (c, m) in enumerate(itertools.product(padded, modalities))]
    with ThreadPoolExecutor(8) as pool:
        list(pool.map(write, jobs))
    return labels, data, padded


def _metrics_as_evaluate(logits: torch.Tensor, targets: torch.Tensor) -> dict:
    """The metric dict ``evaluate.main`` reports, from (n, 2) logits on the
    host."""
    metrics = {k: float(v) for k, v in compute_metrics(logits.argmax(1), targets).items()}
    probs = np.exp(logits.numpy() - logits.numpy().max(1, keepdims=True))
    probs = (probs / probs.sum(1, keepdims=True))[:, 1]
    metrics["auc_roc"] = float(binary_auroc(torch.from_numpy(probs), targets))
    metrics["n"] = len(targets)
    return metrics


def phase_train_cli(tmp: Path) -> dict:
    """The experiments CLI on a synthetic NIfTI cohort: one epoch, then a
    resumed second; the evaluate CLI on the best checkpoint."""
    from cross_attention_vit_tpu_torch.data.dataset import BrainDataset
    from cross_attention_vit_tpu_torch.data.labels import clean_data, load_labels
    from cross_attention_vit_tpu_torch.data.loader import transfer_dtype_for

    free = shutil.disk_usage(tmp).free
    check(free >= CLI_DISK_BYTES,
          f"train_cli writes ~12 GB of checkpoints under {tmp}: {free / 1e9:.1f} GB free, "
          f"{CLI_DISK_BYTES / 1e9:.0f} GB needed")
    root = tmp / "train_cli"
    try:
        t0 = time.perf_counter()
        labels, data, padded = _write_cohort(root)
        cohort_s = time.perf_counter() - t0
        out = root / "runs"
        args = ["--model", "cross", "--grid-index", "0", "--seeds", "2004", "--batch-size", "8",
                "--only-available", "--labels", str(labels), "--data", str(data),
                "--out", str(out),
                # the live bench configuration: bf16, flash attention, tanh GELU
                "--set", "compute_dtype='bfloat16'", "--set", "activation_dtype='bfloat16'",
                "--set", "augment_dtype='bfloat16'", "--set", "use_flash_attention=True",
                "--set", "gelu_approx=True"]
        run = "test_200_0_0_0"
        runs = []
        fa.FUSED_QKV_GRADS = True
        try:
            for epochs in (1, 2):
                _zero_counts()
                write0 = ckpt.write_seconds()
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(sys.stderr):    # its epoch lines
                    histories = experiments.main(args + ["--epochs", str(epochs)])
                torch.cuda.synchronize()
                runs.append({"epochs": epochs, "wall_s": time.perf_counter() - t0,
                             "checkpoint_write_s": ckpt.write_seconds() - write0,
                             "launches": _counts(), "history": histories[run]})
                gc.collect()
                torch.cuda.empty_cache()
        finally:
            fa.FUSED_QKV_GRADS = False
        cfg = ckpt.load_config_for(next((out / "checkpoints" / "cross").glob("*.npz")))
        # the split of train_full: 16 subjects, ceil(15%) test, ceil(18%) of the rest val
        n_test = -(-CLI_SUBJECTS * 15 // 100)
        n_val = -(-(CLI_SUBJECTS - n_test) * 18 // 100)
        steps = -(-(CLI_SUBJECTS - n_test - n_val) // 8)
        manifest = json.loads((out / "checkpoints" / "cross" / f"manifest_{run}.json").read_text())
        best = out / "checkpoints" / "cross" / manifest[0]["file"]
        files = sorted(str(p.relative_to(out)) for p in out.rglob("*")
                       if p.is_file() and "vol_cache" not in p.parts)
        csv_rows = (out / "csv_logs" / "cross" / run / "metrics.csv").read_text().splitlines()

        args_eval = ["--checkpoint", str(best), "--model", "cross", "--labels", str(labels),
                     "--data", str(data), "--img-types", *MODALITIES, "--only-available"]
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):            # its JSON report
            metrics = evaluate.main(args_eval)
        eval_s = time.perf_counter() - t0
        # the direct forward: the checkpoint's params in a fresh model, every
        # subject on disk in label order, batches of 8
        model = ModelCross(cfg, device="cuda", master_weights=True)
        from cross_attention_vit_tpu_torch.models.convert import load_jax_params
        load_jax_params(model, params_from_flat(ckpt.restore_flat(best)))
        table = clean_data(load_labels(labels), "MGMT status")
        ds = BrainDataset(table, cfg, types=MODALITIES, is_train=False, folder=data)
        logits, targets = [], []
        with torch.inference_mode():
            for b0 in range(0, len(ds), 8):
                imgs, lab = ds.batch(range(b0, min(b0 + 8, len(ds))))
                x = torch.from_numpy(imgs).to(torch.bfloat16).cuda()
                logits.append(model(x).float().cpu())
                targets.append(torch.from_numpy(lab))
        direct = _metrics_as_evaluate(torch.cat(logits), torch.cat(targets))
        del model
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)

    hist = [row for r in runs for row in r["history"]]
    result = {"phase": "train_cli", "model": "ModelCross", "subjects": CLI_SUBJECTS,
              "raw_volume": list(RAW_VOLUME), "cohort_write_s": cohort_s,
              "split": {"test": n_test, "val": n_val, "train": CLI_SUBJECTS - n_test - n_val},
              "steps_per_epoch": steps, "decoder": "native" if native.available() else "python",
              "transfer_dtype": transfer_dtype_for(cfg), "fused_qkv_grads": True,
              "runs": [{k: v for k, v in r.items() if k != "history"} for r in runs],
              "history": hist, "files": files, "csv_rows": len(csv_rows) - 1,
              "evaluate": metrics, "direct": direct, "evaluate_s": eval_s,
              "epoch_time_s": [row["epoch_time_s"] for row in hist],
              "step_s": [row["epoch_time_s"] / steps for row in hist],
              "checkpoint_write_share": sum(r["checkpoint_write_s"] for r in runs)
                                        / sum(r["wall_s"] for r in runs)}
    emit(result)
    check(len(runs[0]["history"]) == 1 and len(runs[1]["history"]) == 1,
          f"epochs run: {[len(r['history']) for r in runs]} (1, then 1 resumed, expected)")
    check(all(np.isfinite(v) for row in hist for v in row.values()),
          f"non-finite history: {hist}")
    for r in runs:
        c = r["launches"]
        check(c["K8"] == 12 * steps and c["K2"] == 0,
              f"run to {r['epochs']} epochs: K8 {c['K8']} calls, K2 {c['K2']} launches "
              f"({12 * steps} and 0 expected)")
    want = {f"checkpoints/cross/config_{run}.json", f"checkpoints/cross/manifest_{run}.json",
            f"csv_logs/cross/{run}/metrics.csv", f"latest/{run}/step={steps}.npz",
            f"latest/{run}/step={2 * steps}.npz"}
    check(want <= set(files) and sum(f.startswith("checkpoints/cross/epoch=") for f in files) == 2
          and any(f.startswith(f"lightning_logs/cross/{run}/events.out.tfevents") for f in files)
          and len(csv_rows) == 3, f"run files: {files}, {len(csv_rows)} CSV lines")
    check(metrics == direct, f"evaluate.main {metrics} != direct forward {direct}")
    return result


MOE_PARAMS = 544_168_966
MOE_SITES = 12          # 3 streams x 2 multi-blocks x 2 self-blocks
BALANCE_TOL = 2e-6      # |(loss - CE) - 0.01 x mean balance|, f32 rounding of the sum
RING_NS = (513, 1537)
# The only f32 GEMMs of the bf16 MoE step: the MoE's router and experts
# (cuBLAS/CUTLASS f32 kernels: "sgemm", "gemm_f32f32")
MOE_GEMM_MARKS = ("sgemm", "f32f32")


def moe_config(use_flash: bool):
    """The live configuration with ``moe_experts = 4``."""
    cfg = live_config(use_flash)
    modify_config(cfg, {"moe_experts": 4})
    return cfg


def phase_train_moe(tmp: Path) -> dict:
    cfg = moe_config(use_flash=True)
    torch.cuda.reset_peak_memory_stats()
    model = ModelCross(cfg, device="cuda", generator=torch.Generator(device="cuda").manual_seed(0),
                       master_weights=True)
    n_params = model.num_params()
    check(n_params == MOE_PARAMS, f"{n_params} params, expected {MOE_PARAMS}")
    check(len(moe_sites(model)) == MOE_SITES, f"{len(moe_sites(model))} MoE sites")
    optimizer = Adam(model.parameters(), weight_decay=cfg.weight_decay)
    step = make_train_step(model, optimizer, cfg)
    op = cfg.optim_params
    lr_at = cosine_annealing_lr(cfg.lr, op["T_max"], op["eta_min"])
    img, labels = _train_batch(cfg)
    state0 = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    host_gen = torch.Generator().manual_seed(TRAIN_SEED)

    losses, step_ms, per_step, affine_drawn = _run_steps(step, img, labels, lr_at, host_gen)
    launches = _counts()
    check(all(np.isfinite(losses)), f"non-finite training loss: {losses}")
    for i, (c, drawn) in enumerate(zip(per_step, affine_drawn)):
        check(c["K1"] == 12 and c["K2"] == 12,
              f"step {i}: K1 launched {c['K1']}, K2 {c['K2']} times (12 each expected)")
        check(c["K3"] == (4 if drawn else 0), f"step {i}: K3 launched {c['K3']} times")
    check(launches["K3"] > 0, "no step drew the affine: K3 never ran on the MoE path")
    dispatch = model.moe_aux["dispatch_fraction"].tolist()

    # the balance term: loss - CE of one train-mode forward
    with torch.no_grad():
        logits, loss = model(img, labels, train=True,
                             generator=torch.Generator(device="cuda").manual_seed(0))
        ce = cross_entropy(logits, labels, cfg.label_smoothing)
    balance = model.moe_aux["balance_loss"]
    gap, want_gap = float(loss - ce), 0.01 * float(balance.mean())
    check(abs(gap - want_gap) <= BALANCE_TOL,
          f"loss - CE = {gap:.9f}, 0.01 x mean balance = {want_gap:.9f}")
    profile = _profiled(lambda: step(img, labels, lr_at(0), host_gen),
                        marks={"moe_f32_gemms": MOE_GEMM_MARKS})
    moe_gemm_ms = profile["device_ms_marked"]["moe_f32_gemms"]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del model, optimizer, step
    torch.cuda.empty_cache()
    steady = statistics.median(step_ms[1:])

    # kernel path against plain path: one step at dropout 0 without
    # augmentation from the seeded masters.  Top-2 routing is discontinuous:
    # bf16 attention outputs that differ in their last bits send near-tie
    # tokens to other experts, so the bf16 kernel path is reported beside
    # the f32 plain path, and the gate holds the two paths at f32 (the f32
    # kernels), where no routing flips, at the f32 kernels' tolerance.
    def cmp_cfg(use_flash: bool, dtype: str = "bfloat16"):
        c = moe_config(use_flash)
        modify_config(c, {"dropout": 0.0, "img_aug": False, "compute_dtype": dtype,
                          "activation_dtype": dtype})
        return c
    grads, cmp_launches = {}, {}
    for name, use_flash, dtype in (("flash", True, "bfloat16"), ("flash32", True, "float32"),
                                   ("plain32", False, "float32")):
        _zero_counts()
        grads[name] = _grads_after_step(cmp_cfg(use_flash, dtype), state0, img, labels)
        cmp_launches[name] = _counts()
    errs = _leaf_errs(grads["flash32"], grads["plain32"])
    bf16 = _leaf_errs(grads["flash"], grads["plain32"])
    torch.save({n: g.cpu() for n, g in grads["flash"].items()}, tmp / "moe_grads_one_process.pt")
    del grads
    torch.cuda.empty_cache()
    ep_gloo = _two_gloo_ep_ranks(tmp)
    gated = [n for n in errs if not n.endswith(ZERO_GRAD_LEAF)]
    worst = max(gated, key=errs.get)
    bf16_worst = max(bf16[n] for n in gated)
    for name in ("flash", "flash32"):
        c = cmp_launches[name]
        check(c["K1"] == 12 and c["K2"] == 12, f"comparison step {name} launches {c}")

    # a MoE checkpoint served on the card
    ckpt = tmp / "epoch=00-val_loss=0.0000.npz"
    save_pytree(ckpt, {"params": jax_params_from_state_dict(
        {k: v.numpy() for k, v in state0.items()}, cfg)})
    save_config(tmp, cfg)
    del state0
    server = InferenceServer(ckpt, img_types=MODALITIES, buckets=(8,), device="cuda")
    server.warmup()
    server.start()
    vols = (np.random.default_rng(5).normal(size=(8, len(MODALITIES), 1, *cfg.img_size))
            * 100).astype(np.float32)
    try:
        fa.flash_attention_qkv.launches = 0
        served = server.predict(vols)
        serve_launches = fa.flash_attention_qkv.launches
    finally:
        server.stop()
    served_vs_direct = _served_vs_direct(server, [vols], [served])
    serve_site = server.model.transformer[0].blocks[0][0].ffn.fn
    moe_f32 = serve_site.router.weight.dtype == serve_site.experts["fc1"].weight.dtype \
        == torch.float32
    del server, serve_site
    torch.cuda.empty_cache()
    check(bool(np.isfinite(served).all()) and served.shape == (8, cfg.num_classes),
          f"served MoE logits {served.shape}")
    check(serve_launches == 12, f"served MoE forward launched K1 {serve_launches} times")
    check(served_vs_direct == 0.0, f"served MoE logits differ from a direct forward by "
                                   f"{served_vs_direct}")
    check(moe_f32, "the serving model's router or experts are not float32")

    result = {"phase": "train_moe", "model": "ModelCross", "params": n_params,
              "moe_experts": 4, "moe_sites": MOE_SITES, "moe_num_selected": 2,
              "moe_capacity_factor": 1.25, "tokens_per_site": 8 * 513,
              "capacity": expert_capacity(8 * 513, 4, 2, 1.25), "batch": 8, "dtype": "bfloat16",
              "moe_dtype": "float32", "dropout": cfg.dropout, "steps": TRAIN_STEPS,
              "losses": losses, "launches": launches, "launches_per_step": per_step,
              "affine_volumes_per_step": affine_drawn,
              "dispatch_fraction_by_site": dispatch,
              "balance_by_site": balance.tolist(), "loss_minus_ce": gap,
              "balance_term": want_gap, "balance_tol": BALANCE_TOL,
              "step_ms": step_ms, "step_ms_steady": steady,
              "moe_f32_gemm_device_ms": moe_gemm_ms,
              "moe_f32_gemm_share_of_device_ms": (moe_gemm_ms / profile["device_ms_total"]
                                                  if profile["device_ms_total"] else None),
              "profile": profile, "peak_device_gb": peak_gb,
              "grad_leaves": len(errs),
              "grad_f32_flash_vs_plain_worst_leaf": [worst, errs[worst]],
              "tol": KERNEL_TOL[torch.float32],
              "grad_bf16_flash_vs_f32_plain_worst_gated": bf16_worst,
              # [f32 kernel vs plain, bf16 kernel vs f32 plain]
              "grad_by_kind": _by_kind(errs, bf16),
              "serve_bucket8": {"launches": serve_launches,
                                "served_vs_direct_max_abs": served_vs_direct,
                                "moe_float32": moe_f32},
              "ep_gloo_two_ranks": ep_gloo}
    emit(result)
    check(errs[worst] <= KERNEL_TOL[torch.float32],
          f"MoE gradient of {worst}: f32 kernel path vs plain path {errs[worst]:.3e} > "
          f"{KERNEL_TOL[torch.float32]}")
    return result


def _two_gloo_ep_ranks(tmp: Path) -> dict:
    """Phase train_moe's expert parallelism on this card: ``moe_worker`` in
    two processes over gloo (NCCL refuses two ranks on one card), each
    holding 2 of the 4 experts of every site."""
    ranks = _gloo_ranks("--moe-worker", 2, tmp, "moe", DP_TIMEOUT_S)
    check(ranks[0]["loss"] == ranks[1]["loss"], "the two EP ranks' losses differ")
    for r, got in enumerate(ranks):
        check(got["experts_here"] == 2, f"gloo EP rank {r} holds {got['experts_here']} experts")
        check(got["launches"]["K1"] == 12 and got["launches"]["K2"] == 12,
              f"gloo EP rank {r}: launches {got['launches']}")
        # each expert's own GEMMs: a split of the experts computes what one
        # process computes, bit for bit
        check(got["grad_vs_one_process_max_abs"] == 0.0,
              f"gloo EP rank {r}: gradient vs the one-process step differs by "
              f"{got['grad_vs_one_process_max_abs']} (worst leaf "
              f"{got['grad_vs_one_process_worst_gated']})")
    return {"ranks": ranks}


def moe_worker(rank: int, world: int, port: int, tmp: Path) -> int:
    """One of phase train_moe's two gloo ranks on cuda:0, mesh (data 1,
    expert 2): one step of the MoE ModelCross at dropout 0 without
    augmentation from the seeded masters, its gradients (this rank's
    experts, the rest whole) against the one-process step's, and a second
    step's time."""
    multihost_init(f"127.0.0.1:{port}", world, rank, backend="gloo", device="cuda",
                   timeout_s=DP_TIMEOUT_S)
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        cfg = moe_config(use_flash=True)
        modify_config(cfg, {"dropout": 0.0, "img_aug": False})
        t = Trainer(ModelCross, cfg, max_epochs=1, mesh=make_mesh(1, expert=2),
                    device="cuda").init_state()
        model = unwrap(t.model)
        want = local_experts(model, torch.load(tmp / "moe_grads_one_process.pt",
                                               map_location="cuda"))
        img, labels = _train_batch(cfg)
        _zero_counts()
        aux, ms = _timed_step(t.train_step, img, labels, cfg.lr,
                              torch.Generator().manual_seed(0))
        launches = _counts()
        got = {n: p.grad.float() for n, p in model.named_parameters()}
        errs = _leaf_errs(got, want)
        gated = {n: e for n, e in errs.items() if not n.endswith(ZERO_GRAD_LEAF)}
        worst = max(gated, key=gated.get)
        max_abs = max((got[n] - want[n]).abs().max().item() for n in want)
        _, ms2 = _timed_step(t.train_step, img, labels, cfg.lr, torch.Generator().manual_seed(0))
        (tmp / f"moe_rank{rank}.json").write_text(json.dumps({
            "rank": rank, "backend": "gloo", "mesh": {"data": 1, "expert": 2},
            "experts_here": model.transformer[0].blocks[0][0].ffn.fn.experts["fc1"].weight
                                 .shape[0],
            "loss": float(aux["loss"]), "launches": launches, "step_ms": [ms, ms2],
            "grad_vs_one_process_worst_gated": [worst, gated[worst]],
            "grad_vs_one_process_max_abs": max_abs}))
    finally:
        torch.distributed.destroy_process_group()
    return 0


def _ring_case(N: int, dtype: torch.dtype) -> dict:
    """The ring forced at one rank against ``_sdpa``: out, dq, dk, dv
    normalised errors, and both timed forward and backward."""
    g = torch.Generator(device="cuda").manual_seed(N)
    q, k, v = (torch.randn(8, 16, N, 64, device="cuda", generator=g).to(dtype)
               .requires_grad_() for _ in range(3))
    dout = torch.randn(8, 16, N, 64, device="cuda", generator=g).to(dtype)
    scale = 64 ** -0.5

    def run(fn):
        for t in (q, k, v):
            t.grad = None
        out = fn(q, k, v)
        out.backward(dout)
        return [out.detach().float()] + [t.grad.float() for t in (q, k, v)]

    ring = lambda q, k, v: ring_attention(q, k, v, scale=scale, force_ring=True)  # noqa: E731
    dense = lambda q, k, v: _sdpa(q, k, v, scale)  # noqa: E731
    got, want = run(ring), run(dense)
    errs = {name: _norm_err(a, b)[1] for name, a, b in zip(("out", "dq", "dk", "dv"), got, want)}
    times = {"ring_ms": cuda_ms(lambda: run(ring), runs=3, calls=2, warmup=1),
             "dense_ms": cuda_ms(lambda: run(dense), runs=3, calls=2, warmup=1)}
    del q, k, v, dout, got, want
    torch.cuda.empty_cache()
    return {"N": N, "dtype": str(dtype).split(".")[-1], "norm_err": errs,
            "tol": KERNEL_TOL[dtype], "fwd_bwd": times}


def phase_ring() -> dict:
    cases = [_ring_case(N, dt) for N in RING_NS for dt in (torch.bfloat16, torch.float32)]
    for c in cases:
        worst = max(c["norm_err"].values())
        check(worst <= c["tol"], f"ring at N={c['N']} {c['dtype']}: normalised error {worst:.3e} "
                                 f"> {c['tol']}")

    # seq_parallel = 2 with no seq mesh is the dense attention, bit for bit
    def sp_cfg(sp: bool):
        c = live_config(use_flash=not sp)
        if sp:
            modify_config(c, {"seq_parallel": 2})
        else:
            modify_config(c, {"use_flash_attention": False})
        return c
    rng = np.random.default_rng(1)
    img = torch.from_numpy((rng.normal(size=(8, len(MODALITIES), 1, 128, 128, 64)) * 100)
                           .astype(np.float32)).cuda()
    labels = torch.tensor([0, 1] * 4, device="cuda")
    runs = {}
    for sp in (True, False):      # the same seeded masters, batch and host generator
        cfg = sp_cfg(sp)
        model = ModelCross(cfg, device="cuda", master_weights=True,
                           generator=torch.Generator(device="cuda").manual_seed(0))
        check(model.opts.impl == ("ring" if sp else "xla"), f"attention impl {model.opts.impl}")
        step = make_train_step(model, Adam(model.parameters(), cfg.weight_decay), cfg)
        op = cfg.optim_params
        lr_at = cosine_annealing_lr(cfg.lr, op["T_max"], op["eta_min"])
        losses, step_ms, per_step, drawn = _run_steps(step, img, labels, lr_at,
                                                      torch.Generator().manual_seed(TRAIN_SEED))
        runs[sp] = {"losses": losses, "launches": _counts(), "step_ms": step_ms,
                    "params": {k: v.detach().cpu() for k, v in model.state_dict().items()}}
        del model, step
        torch.cuda.empty_cache()
    sp_run, dense_run = runs[True], runs[False]
    param_diff = max((v - dense_run["params"][k]).abs().max().item()
                     for k, v in sp_run["params"].items())
    launches = sp_run["launches"]
    result = {"phase": "ring", "shape": "B=8 K=16 D=64", "cases": cases,
              "sp_step": {"model": "ModelCross", "seq_parallel": 2, "seq_mesh": None,
                          "steps": TRAIN_STEPS, "losses": sp_run["losses"],
                          "dense_losses": dense_run["losses"],
                          "max_param_diff_vs_dense": param_diff, "launches": launches,
                          "step_ms": sp_run["step_ms"], "dense_step_ms": dense_run["step_ms"]}}
    emit(result)
    check(sp_run["losses"] == dense_run["losses"] and param_diff == 0.0,
          f"seq_parallel without a seq mesh is not the dense path bit for bit: losses "
          f"{sp_run['losses']} vs {dense_run['losses']}, params {param_diff}")
    check(launches["K1"] == launches["K2"] == 0, f"the SP step launched attention kernels: "
                                                 f"{launches}")
    check(launches["K3"] > 0, "no SP step drew the affine: K3 never ran on the SP path")
    return result


# -- tensor and pipeline parallelism: phases train_tp, serve_tp, train_pp -------------

TP_STEPS = 3            # bf16 steps of the TP ranks (gloo moves every partial sum by host)
PP_STEPS = 3
PIPE_MB = 4             # pipeline_microbatches: B = 2 rows a microbatch
SPLIT_TIMEOUT_S = 900
SPLIT_SERVE = ((3, 11), (8, 12))     # (volumes, seed) of the sharded server's requests
LOSS_REL_TOL = 1e-5     # JAX's own rel for a split step's loss (tests/test_parallel.py)
# the bf16 TP first step against one process's: another summation order of
# the row-split products flips roundings; ~12x the 4.1e-4 it reads on an H100
TP_BF16_LOSS_REL_TOL = 5e-3


def _f32(cfg):
    """``cfg`` computing and storing activations in f32 (the comparison
    steps: at bf16 another summation order flips roundings, which no 1e-5
    gate can hold)."""
    modify_config(cfg, {"compute_dtype": "float32", "activation_dtype": "float32"})
    return cfg


def _pp_config(dtype: str = "bfloat16"):
    """The 2-stream ModelVIT (params_list2[1], N = 1025, 4 layers) in
    ``pipeline_stages`` = 2 with PIPE_MB microbatches."""
    cfg = vit_config(("SWI", "DWI"), use_flash=True)
    modify_config(cfg, {"pipeline_stages": 2, "pipeline_microbatches": PIPE_MB})
    return _f32(cfg) if dtype == "float32" else cfg


def _vit_batch(cfg) -> tuple[torch.Tensor, torch.Tensor]:
    rng = np.random.default_rng(22)
    img = torch.from_numpy((rng.normal(size=(8, cfg.num_modalities, 1, *cfg.img_size)) * 100)
                           .astype(np.float32)).cuda()
    return img, torch.tensor([0, 1] * 4, device="cuda")


@contextlib.contextmanager
def _attention_shapes(seen: set):
    """Record the (kernel, B, K) of every K1/K2/K7 launch while it is open:
    which batch and heads each kernel ran at (launches only, the counts are
    the kernels' own)."""
    names = ("flash_attention_qkv_fwd", "flash_attention_qkv_bwd", "flash_attention_stream_fwd")
    saved = {n: getattr(fa, n) for n in names}

    def spy(name, fn):
        def call(q, *args, **kwargs):
            out = fn(q, *args, **kwargs)
            k = q.shape[3] if q.dim() == 5 else q.shape[1]
            seen.add((name, int(q.shape[0]), int(k)))
            return out
        call.__dict__ = fn.__dict__     # the wrappers count on their own attributes
        return call
    for n in names:
        setattr(fa, n, spy(n, saved[n]))
    try:
        yield seen
    finally:
        for n in names:
            setattr(fa, n, saved[n])


def _gated_worst(errs: dict) -> tuple[str, float]:
    gated = {n: e for n, e in errs.items() if not n.endswith(ZERO_GRAD_LEAF)}
    worst = max(gated, key=gated.get)
    return worst, gated[worst]


def _vit_head_bias_by_summand(errs: dict, got: dict, want: dict, aux: dict) -> None:
    """ModelVIT's classifier bias normalised by its largest summand, as
    phase train_vit does (``HEAD_BIAS``), from a step's (global) aux."""
    labels = aux["labels"]
    summand = (aux["probs"] - labels.float()).abs().max().item() / len(labels)
    errs[HEAD_BIAS] = (got[HEAD_BIAS] - want[HEAD_BIAS]).abs().max().item() / summand


def phase_split(tmp: Path) -> tuple[dict, dict, dict]:
    """Phases train_tp, serve_tp and train_pp: the one-process references
    here, then two gloo ranks sharing the card (``chip_smoke.py
    --split-worker``) run TP over (model 2) and PP over (pipe 2)."""
    gc.collect()
    torch.cuda.empty_cache()
    # -- references: the live ModelCross from the Trainer's seed
    cfg = live_config(use_flash=True)
    model = ModelCross(cfg, device="cuda", generator=torch.Generator(device="cuda").manual_seed(0),
                       master_weights=True)
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    del model
    img, labels = _train_batch(cfg)
    refs = {}
    aux = {}
    grads = _grads_after_step(_f32(live_config(True)), state, img, labels, aux_out=aux)
    torch.save({n: g.cpu() for n, g in grads.items()}, tmp / "tp_grads.pt")
    refs["tp_f32_loss"] = float(aux["loss"])
    del grads
    aux = {}
    _grads_after_step(live_config(True), state, img, labels, aux_out=aux)
    refs["tp_bf16_loss"] = float(aux["loss"])
    # the checkpoint the sharded server serves, and a direct forward of it
    (tmp / "tp_serve").mkdir()
    ckpt_path = tmp / "tp_serve" / "epoch=00-val_loss=0.0000.npz"
    save_pytree(ckpt_path, {"params": jax_params_from_state_dict(
        {k: v.numpy() for k, v in state.items()}, cfg)})
    save_config(tmp / "tp_serve", cfg)
    del state
    server = InferenceServer(ckpt_path, img_types=MODALITIES, buckets=(1, 2, 4, 8),
                             device="cuda")
    direct = {}
    for n, seed in SPLIT_SERVE:
        vols = (np.random.default_rng(seed).normal(size=(n, 3, 1, *cfg.img_size)) * 100
                ).astype(np.float32)
        bucket = next(b for b in server.buckets if b >= n)
        padded = np.concatenate([vols, np.zeros((bucket - n, *vols.shape[1:]), np.float32)])
        direct[n] = _forward(server.model, padded)[:n].cpu().numpy().tolist()
    refs["serve_direct"] = direct
    del server
    # -- references: the 2-stream ModelVIT, the serial schedule and the plain trunk
    pcfg = _pp_config("float32")
    vit = ModelVIT(pcfg, device="cuda", generator=torch.Generator(device="cuda").manual_seed(0),
                   master_weights=True)
    vstate = {k: v.detach().cpu() for k, v in vit.state_dict().items()}
    del vit
    vimg, vlabels = _vit_batch(pcfg)
    plain_cfg = _f32(vit_config(("SWI", "DWI"), True))
    modify_config(plain_cfg, {"dropout": 0.0, "img_aug": False})
    serial_cfg = _pp_config("float32")
    modify_config(serial_cfg, {"dropout": 0.0, "img_aug": False})
    aux_plain, aux_serial = {}, {}
    g_plain = _grads_after_step(plain_cfg, vstate, vimg, vlabels, ModelVIT, aux_plain)
    _zero_counts()
    seen: set = set()
    with _attention_shapes(seen):
        g_serial = _grads_after_step(serial_cfg, vstate, vimg, vlabels, ModelVIT, aux_serial)
    serial_launches = _counts()
    serial_vs_plain = _leaf_errs(g_serial, g_plain)
    _vit_head_bias_by_summand(serial_vs_plain, g_serial, g_plain, aux_plain)
    serial_loss_rel = abs(float(aux_serial["loss"]) / float(aux_plain["loss"]) - 1)
    del g_plain, g_serial
    aux = {}
    # the pipe ranks' comparison: dropout 0.1 and augmentation on, the same masks
    grads = _grads_after_step(_pp_config("float32"), vstate, vimg, vlabels, ModelVIT, aux)
    torch.save({n: g.cpu() for n, g in grads.items()}, tmp / "pp_grads.pt")
    refs["pp_f32_loss"] = float(aux["loss"])
    refs["pp_probs"] = aux["probs"].tolist()
    del grads, vstate
    gc.collect()
    torch.cuda.empty_cache()
    (tmp / "split_refs.json").write_text(json.dumps(refs))

    ranks = _gloo_ranks("--split-worker", 2, tmp, "split", SPLIT_TIMEOUT_S)

    # -- train_tp
    tp = [r["train_tp"] for r in ranks]
    for r, got in enumerate(tp):
        check(got["f32_loss_rel"] <= LOSS_REL_TOL,
              f"TP rank {r}: f32 step loss {got['f32_loss']} vs one process "
              f"{refs['tp_f32_loss']} (rel {got['f32_loss_rel']:.2e} > {LOSS_REL_TOL})")
        check(got["f32_grad_worst_gated"][1] <= KERNEL_TOL[torch.float32],
              f"TP rank {r}: f32 gradient of {got['f32_grad_worst_gated'][0]} "
              f"{got['f32_grad_worst_gated'][1]:.3e} > {KERNEL_TOL[torch.float32]}")
        check(got["bf16_first_loss_rel"] <= TP_BF16_LOSS_REL_TOL,
              f"TP rank {r}: bf16 first-step loss rel {got['bf16_first_loss_rel']:.3e} > "
              f"{TP_BF16_LOSS_REL_TOL}")
        check(all(np.isfinite(got["losses"])), f"TP rank {r}: non-finite losses")
        for i, c in enumerate(got["launches_per_step"]):
            check(c["K1"] == 12 and c["K2"] == 12,
                  f"TP rank {r} step {i}: K1 {c['K1']}, K2 {c['K2']} (12 each expected)")
        check(got["attention_shapes"] == [["flash_attention_qkv_bwd", 8, 8],
                                          ["flash_attention_qkv_fwd", 8, 8]],
              f"TP rank {r}: attention kernels ran at (kernel, B, K) {got['attention_shapes']}")
    train_tp = {"phase": "train_tp", "model": "ModelCross", "mesh": {"data": 1, "model": 2},
                "backend": "gloo, two ranks sharing one card (not a speed figure)",
                "heads_per_rank": 8, "batch": 8, "dtype": "bfloat16", "steps": TP_STEPS,
                "one_process_f32_loss": refs["tp_f32_loss"],
                "one_process_bf16_loss": refs["tp_bf16_loss"],
                "loss_rel_tol": LOSS_REL_TOL, "bf16_loss_rel_tol": TP_BF16_LOSS_REL_TOL,
                "grad_tol": KERNEL_TOL[torch.float32], "ranks": tp}
    emit(train_tp)
    # -- serve_tp
    sv = [r["serve_tp"] for r in ranks]
    check(sv[0]["served_vs_direct_max_abs"] <= SERVE_TOL,
          f"sharded server vs direct forward {sv[0]['served_vs_direct_max_abs']:.3e} > "
          f"{SERVE_TOL}")
    for r, got in enumerate(sv):
        check(got["launches"]["K1"] == 12 * len(SPLIT_SERVE),
              f"serve_tp rank {r}: K1 launched {got['launches']['K1']} times for "
              f"{len(SPLIT_SERVE)} forwards")
        check(all(k == 8 for _, _, k in got["attention_shapes"]),
              f"serve_tp rank {r}: attention at {got['attention_shapes']}")
    serve_tp = {"phase": "serve_tp", "model": "ModelCross", "mesh": {"data": 1, "model": 2},
                "buckets": [1, 2, 4, 8], "requests": [n for n, _ in SPLIT_SERVE],
                "tol": SERVE_TOL, "ranks": sv}
    emit(serve_tp)
    # -- train_pp
    pp = [r["train_pp"] for r in ranks]
    check(serial_loss_rel <= LOSS_REL_TOL,
          f"serial schedule vs plain trunk: loss rel {serial_loss_rel:.2e}")
    worst = _gated_worst(serial_vs_plain)
    check(worst[1] <= KERNEL_TOL[torch.float32],
          f"serial schedule vs plain trunk: gradient of {worst[0]} {worst[1]:.3e}")
    check(serial_launches["K1"] == 16 and serial_launches["K2"] == 16,
          f"serial schedule launches {serial_launches} (16 K1, 16 K2 expected)")
    check(sorted(seen) == [("flash_attention_qkv_bwd", 2, 16), ("flash_attention_qkv_fwd", 2, 16)],
          f"serial schedule: attention at {sorted(seen)}")
    for r, got in enumerate(pp):
        check(got["f32_loss_rel"] <= LOSS_REL_TOL,
              f"PP rank {r}: f32 loss rel {got['f32_loss_rel']:.2e} vs the serial schedule")
        check(got["f32_grad_worst_gated"][1] <= KERNEL_TOL[torch.float32],
              f"PP rank {r}: f32 gradient of {got['f32_grad_worst_gated'][0]} "
              f"{got['f32_grad_worst_gated'][1]:.3e}")
        check(all(np.isfinite(got["losses"])), f"PP rank {r}: non-finite losses")
        for i, c in enumerate(got["launches_per_step"]):
            check(c["K1"] == 8 and c["K2"] == 8,
                  f"PP rank {r} step {i}: K1 {c['K1']}, K2 {c['K2']} (2 layers x 4 "
                  "microbatches = 8 each expected)")
        check(got["attention_shapes"] == [["flash_attention_qkv_bwd", 2, 16],
                                          ["flash_attention_qkv_fwd", 2, 16]],
              f"PP rank {r}: attention at {got['attention_shapes']}")
    train_pp = {"phase": "train_pp", "model": "ModelVIT", "streams": ["SWI", "DWI"],
                "tokens": 1025, "layers": 4, "mesh": {"pipe": 2, "data": 1},
                "pipeline_microbatches": PIPE_MB, "rows_per_microbatch": 8 // PIPE_MB,
                "bubble_fraction": bubble_fraction(2, PIPE_MB),
                "backend": "gloo, two ranks sharing one card (not a speed figure)",
                "serial_vs_plain": {"loss_rel": serial_loss_rel, "grad_worst_gated": worst,
                                    "launches": serial_launches},
                "one_process_serial_f32_loss": refs["pp_f32_loss"],
                "loss_rel_tol": LOSS_REL_TOL, "grad_tol": KERNEL_TOL[torch.float32],
                "ranks": pp}
    emit(train_pp)
    return train_tp, serve_tp, train_pp


def _split_steps(t, cfg, img, labels, steps: int) -> dict:
    """``steps`` bf16 train steps of a Trainer over its mesh: losses, ms,
    launches per step and the attention kernels' (kernel, B, K), peak memory."""
    op = cfg.optim_params
    lr_at = cosine_annealing_lr(cfg.lr, op["T_max"], op["eta_min"])
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms, per_step, seen = [], [], [], set()
    _zero_counts()
    with _attention_shapes(seen):
        for s in range(steps):
            counts0 = _counts()
            aux, ms = _timed_step(t.train_step, img, labels, lr_at(s),
                                  torch.Generator().manual_seed(s))
            losses.append(float(aux["loss"]))
            step_ms.append(ms)
            per_step.append({k: v - counts0[k] for k, v in _counts().items()})
    return {"losses": losses, "step_ms": step_ms, "launches": _counts(),
            "launches_per_step": per_step, "attention_shapes": sorted(map(list, seen)),
            "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9}


def _split_cmp(t, img, labels, want_path: Path, want_loss: float, vit: bool) -> dict:
    """One f32 step of a Trainer over its mesh against the one-process
    step's loss and gradients (gathered to the whole layout)."""
    aux, ms = _timed_step(t.train_step, img, labels, t.config.lr, torch.Generator().manual_seed(0))
    got = _full_grads(t)
    want = torch.load(want_path, map_location="cuda")
    errs = _leaf_errs(got, want)
    if vit:
        _vit_head_bias_by_summand(errs, got, want, aux)
    loss = float(aux["loss"])
    del got, want
    return {"f32_loss": loss, "f32_loss_rel": abs(loss / want_loss - 1), "f32_step_ms": ms,
            "f32_grad_worst_gated": list(_gated_worst(errs)), "f32_grad_leaves": len(errs)}


def split_worker(rank: int, world: int, port: int, tmp: Path) -> int:
    """One of the two gloo ranks of phases train_tp, serve_tp and train_pp on
    cuda:0: the live ModelCross over (model 2) — an f32 comparison step with
    dropout and augmentation against the one-process step, TP_STEPS bf16
    steps, then InferenceServer(mesh=) — and the 2-stream ModelVIT over
    (pipe 2): an f32 comparison step against the serial schedule, PP_STEPS
    bf16 steps."""
    multihost_init(f"127.0.0.1:{port}", world, rank, backend="gloo", device="cuda",
                   timeout_s=SPLIT_TIMEOUT_S)
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        refs = json.loads((tmp / "split_refs.json").read_text())
        out = {"rank": rank}
        # -- train_tp
        mesh = make_mesh(1, model=2)
        cfg = live_config(use_flash=True)
        img, labels = _train_batch(cfg)
        t = Trainer(ModelCross, _f32(live_config(True)), max_epochs=1, mesh=mesh,
                    device="cuda").init_state()
        tp = _split_cmp(t, img, labels, tmp / "tp_grads.pt", refs["tp_f32_loss"], vit=False)
        del t
        torch.cuda.empty_cache()
        t = Trainer(ModelCross, cfg, max_epochs=1, mesh=mesh, device="cuda").init_state()
        tp.update(_split_steps(t, cfg, img, labels, TP_STEPS))
        tp["bf16_first_loss_rel"] = abs(tp["losses"][0] / refs["tp_bf16_loss"] - 1)
        tp["local_to_qkv"] = list(unwrap(t.model).transformer[0].blocks[0][0].attn.fn
                                  .to_qkv.weight.shape)
        del t
        torch.cuda.empty_cache()
        out["train_tp"] = tp
        # -- serve_tp: rank 0 answers, rank 1 runs its part of each batch
        server = InferenceServer(next((tmp / "tp_serve").glob("epoch=*.npz")),
                                 img_types=MODALITIES, buckets=(1, 2, 4, 8), mesh=mesh,
                                 device="cuda")
        sv, seen = {}, set()
        _zero_counts()
        with _attention_shapes(seen):
            if rank == 0:
                server.start()
                try:
                    diff = 0.0
                    for n, seed in SPLIT_SERVE:
                        vols = (np.random.default_rng(seed).normal(
                            size=(n, 3, 1, *cfg.img_size)) * 100).astype(np.float32)
                        got = server.predict(vols)
                        check(bool(np.isfinite(got).all()) and got.shape == (n, 2),
                              f"served logits {got.shape}")
                        diff = max(diff, float(np.abs(got - np.asarray(
                            refs["serve_direct"][str(n)])).max()))
                    sv["served_vs_direct_max_abs"] = diff
                    sv["device_ms"] = server.stats_view()["device_ms"]
                finally:
                    server.stop()
            else:
                server.run_worker()
        sv["launches"] = _counts()
        sv["attention_shapes"] = sorted(map(list, seen))
        del server
        torch.cuda.empty_cache()
        out["serve_tp"] = sv
        # -- train_pp
        pmesh = make_mesh(1, pipe=2)
        pcfg = _pp_config()
        vimg, vlabels = _vit_batch(pcfg)
        t = Trainer(ModelVIT, _pp_config("float32"), max_epochs=1, mesh=pmesh,
                    device="cuda").init_state()
        pp = _split_cmp(t, vimg, vlabels, tmp / "pp_grads.pt", refs["pp_f32_loss"], vit=True)
        del t
        torch.cuda.empty_cache()
        t = Trainer(ModelVIT, pcfg, max_epochs=1, mesh=pmesh, device="cuda").init_state()
        pp.update(_split_steps(t, pcfg, vimg, vlabels, PP_STEPS))
        pp["stage_layers"] = list(unwrap(t.model).stage.local())
        out["train_pp"] = pp
        (tmp / f"split_rank{rank}.json").write_text(json.dumps(out))
    finally:
        torch.distributed.destroy_process_group()
    return 0


# -- the composed axes: TP x EP and a synchronised BatchNorm over 'data' ---------

COMPOSE_TIMEOUT_S = 900
# the MoE ModelCross over (expert 2 x model 2): 4 ranks, each half the heads and
# 2 of the 4 experts of every site
TP_EP_MESH = {"data": 1, "expert": 2, "model": 2}
# ViT3D at train_vit3d's width over (data 2): 4 volumes a rank; BN statistics
# after BN_STEPS steps against one process at batch 8
BN_STEPS = 2
BN_STAT_REL_TOL = 1e-5
# The stem's gradients are ill-conditioned in f32: each conv feeds a BatchNorm,
# whose backward leaves a nearly zero-mean gradient, so the conv weights' and
# the next BatchNorm's gradients are small sums of large terms, and the
# one-process gradient itself moves up to ~1.4e-2 normalised on an H100 when
# the batch's rows come in another order (PERF.md §6).  Each leaf is held to
# BN_NOISE_FACTOR × its own reorder spread in this run, never looser than
# ``KERNEL_TOL[float32]``.
BN_NOISE_FACTOR = 3.0
BN_REORDERS = ((7, 6, 5, 4, 3, 2, 1, 0), (4, 5, 6, 7, 0, 1, 2, 3))
# the stem's conv biases each feed a BatchNorm: zero gradient in exact arithmetic
BN_ZERO_GRAD = tuple(f"encoder.conv{i}.bias" for i in range(1, 5))


def _tp_ep_cfg():
    """The MoE ModelCross in f32 at dropout 0 without augmentation."""
    cfg = _f32(moe_config(use_flash=True))
    modify_config(cfg, {"dropout": 0.0, "img_aug": False})
    return cfg


def phase_train_tp_ep(tmp: Path) -> dict:
    """Phase train_tp_ep: the MoE ModelCross over four gloo ranks sharing the
    card, (expert 2 x model 2), against one-process references taken first:
    one f32 step's loss and gradients, the balance term, the K1/K2 launches
    at 8 heads, then the same weights through ``InferenceServer(mesh=)``
    against a direct one-process forward."""
    _fresh_peak()
    cfg = _tp_ep_cfg()
    model = ModelCross(cfg, device="cuda", generator=torch.Generator(device="cuda").manual_seed(0),
                       master_weights=True)
    check(model.num_params() == MOE_PARAMS, f"{model.num_params()} params, expected {MOE_PARAMS}")
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    del model
    img, labels = _train_batch(cfg)
    aux = {}
    grads = _grads_after_step(cfg, state, img, labels, aux_out=aux)
    torch.save({n: g.cpu() for n, g in grads.items()}, tmp / "tp_ep_grads.pt")
    refs = {"loss": float(aux["loss"])}
    del grads
    (tmp / "tp_ep_serve").mkdir()
    ckpt_path = tmp / "tp_ep_serve" / "epoch=00-val_loss=0.0000.npz"
    save_pytree(ckpt_path, {"params": jax_params_from_state_dict(
        {k: v.numpy() for k, v in state.items()}, cfg)})
    save_config(tmp / "tp_ep_serve", cfg)
    del state
    server = InferenceServer(ckpt_path, img_types=MODALITIES, buckets=(1, 2, 4, 8),
                             device="cuda")
    direct = {}
    for n, seed in SPLIT_SERVE:
        vols = (np.random.default_rng(seed).normal(size=(n, 3, 1, *cfg.img_size)) * 100
                ).astype(np.float32)
        bucket = next(b for b in server.buckets if b >= n)
        padded = np.concatenate([vols, np.zeros((bucket - n, *vols.shape[1:]), np.float32)])
        direct[n] = _forward(server.model, padded)[:n].cpu().numpy().tolist()
    refs["serve_direct"] = direct
    del server
    _fresh_peak()
    (tmp / "tp_ep_refs.json").write_text(json.dumps(refs))

    ranks = _gloo_ranks("--tp-ep-worker", 4, tmp, "tp_ep", COMPOSE_TIMEOUT_S)
    H, mlp = cfg.hidden_dim, cfg.mlp_dim
    for r, got in enumerate(ranks):
        check(got["f32_loss_rel"] <= LOSS_REL_TOL,
              f"TPxEP rank {r}: f32 loss {got['f32_loss']} vs one process {refs['loss']}")
        check(got["f32_grad_worst_gated"][1] <= KERNEL_TOL[torch.float32],
              f"TPxEP rank {r}: gradient of {got['f32_grad_worst_gated'][0]} "
              f"{got['f32_grad_worst_gated'][1]:.3e} > {KERNEL_TOL[torch.float32]}")
        check(abs(got["loss_minus_ce"] - got["balance_term"]) <= BALANCE_TOL,
              f"TPxEP rank {r}: loss - CE {got['loss_minus_ce']:.9f} vs 0.01 x balance "
              f"{got['balance_term']:.9f}")
        check(got["launches"]["K1"] == 12 and got["launches"]["K2"] == 12,
              f"TPxEP rank {r}: launches {got['launches']} (12 K1, 12 K2 expected)")
        check(got["attention_shapes"] == [["flash_attention_qkv_bwd", 8, 8],
                                          ["flash_attention_qkv_fwd", 8, 8]],
              f"TPxEP rank {r}: attention at (kernel, B, K) {got['attention_shapes']}")
        check(got["local_experts"] == [2, mlp, H] and got["local_to_qkv"] == [3 * H // 2, H],
              f"TPxEP rank {r}: local experts {got['local_experts']}, qkv {got['local_to_qkv']}")
        check(got["serve"]["launches"]["K1"] == 12 * len(SPLIT_SERVE),
              f"TPxEP server rank {r}: K1 launched {got['serve']['launches']['K1']} times")
    check(ranks[0]["serve"]["served_vs_direct_max_abs"] <= SERVE_TOL,
          f"TPxEP server vs direct forward {ranks[0]['serve']['served_vs_direct_max_abs']:.3e}")
    result = {"phase": "train_tp_ep", "model": "ModelCross", "params": MOE_PARAMS,
              "moe_experts": 4, "mesh": TP_EP_MESH, "heads_per_rank": 8,
              "experts_per_rank": 2, "batch": 8, "dtype": "float32",
              "backend": "gloo, four ranks sharing one card (not a speed figure)",
              "one_process_f32_loss": refs["loss"], "loss_rel_tol": LOSS_REL_TOL,
              "grad_tol": KERNEL_TOL[torch.float32], "balance_tol": BALANCE_TOL,
              "serve_tol": SERVE_TOL, "ranks": ranks}
    emit(result)
    return result


def tp_ep_worker(rank: int, world: int, port: int, tmp: Path) -> int:
    """One of phase train_tp_ep's four gloo ranks on cuda:0."""
    multihost_init(f"127.0.0.1:{port}", world, rank, backend="gloo", device="cuda",
                   timeout_s=COMPOSE_TIMEOUT_S)
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        from cross_attention_vit_tpu_torch.parallel import set_expert_mesh

        refs = json.loads((tmp / "tp_ep_refs.json").read_text())
        mesh = make_mesh(1, model=2, expert=2)
        cfg = _tp_ep_cfg()
        img, labels = _train_batch(cfg)
        torch.cuda.reset_peak_memory_stats()
        t = Trainer(ModelCross, cfg, max_epochs=1, mesh=mesh, device="cuda").init_state()
        seen: set = set()
        _zero_counts()
        with _attention_shapes(seen):
            aux, ms = _timed_step(t.train_step, img, labels, cfg.lr,
                                  torch.Generator().manual_seed(0))
        out = {"rank": rank, "launches": _counts(), "attention_shapes": sorted(map(list, seen)),
               "f32_loss": float(aux["loss"]), "f32_loss_rel": abs(float(aux["loss"])
                                                                   / refs["loss"] - 1)}
        got = _full_grads(t)
        want = torch.load(tmp / "tp_ep_grads.pt", map_location="cuda")
        errs = _leaf_errs(got, want)
        del got, want
        out["f32_grad_worst_gated"] = list(_gated_worst(errs))
        out["f32_grad_leaves"] = len(errs)
        model = unwrap(t.model)
        site = model.transformer[0].blocks[0][0]
        out["local_experts"] = list(site.ffn.fn.experts["fc1"].weight.shape)
        out["local_to_qkv"] = list(site.attn.fn.to_qkv.weight.shape)
        # the balance term of one train-mode forward over the mesh
        set_expert_mesh(mesh)
        try:
            with torch.no_grad():
                logits, loss = model(img, labels, train=True,
                                     generator=torch.Generator(device="cuda").manual_seed(0))
                ce = cross_entropy(logits, labels, cfg.label_smoothing)
        finally:
            set_expert_mesh(None)
        out["loss_minus_ce"] = float(loss - ce)
        out["balance_term"] = 0.01 * float(model.moe_aux["balance_loss"].mean())
        _, ms2 = _timed_step(t.train_step, img, labels, cfg.lr, torch.Generator().manual_seed(1))
        out["step_ms"] = [ms, ms2]
        out["peak_device_gb"] = torch.cuda.max_memory_allocated() / 1e9
        del t, model, site
        torch.cuda.empty_cache()
        # the sharded server: rank 0 answers, the others run their part
        server = InferenceServer(next((tmp / "tp_ep_serve").glob("epoch=*.npz")),
                                 img_types=MODALITIES, buckets=(1, 2, 4, 8), mesh=mesh,
                                 device="cuda")
        sv, seen = {}, set()
        _zero_counts()
        with _attention_shapes(seen):
            if rank == 0:
                server.start()
                try:
                    diff = 0.0
                    for n, seed in SPLIT_SERVE:
                        vols = (np.random.default_rng(seed).normal(
                            size=(n, 3, 1, *cfg.img_size)) * 100).astype(np.float32)
                        ans = server.predict(vols)
                        check(bool(np.isfinite(ans).all()) and ans.shape == (n, 2),
                              f"served logits {ans.shape}")
                        diff = max(diff, float(np.abs(ans - np.asarray(
                            refs["serve_direct"][str(n)])).max()))
                    sv["served_vs_direct_max_abs"] = diff
                finally:
                    server.stop()
            else:
                server.run_worker()
        sv["launches"] = _counts()
        sv["attention_shapes"] = sorted(map(list, seen))
        out["serve"] = sv
        del server
        (tmp / f"tp_ep_rank{rank}.json").write_text(json.dumps(out))
    finally:
        torch.distributed.destroy_process_group()
    return 0


def _bn_cfg():
    """train_vit3d's configuration (``drivers/legacy.py``) at dropout 0."""
    cfg = get_mgmt_config()
    modify_config(cfg, dict(lr=1e-4, dropout=0.0, weight_decay=5e-4, label_smoothing=0.0,
                            img_aug=False, num_modalities=1,
                            optim_params={"factor": 0.5, "patience": 10, "type": "val_loss"}))
    return cfg


def _bn_batch(cfg, step: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Step ``step``'s 8 volumes, from a seed, on the card."""
    rng = np.random.default_rng(31 + step)
    img = torch.from_numpy((rng.normal(size=(8, 1, 1, *cfg.img_size)) * 100 + 300)
                           .astype(np.float32)).cuda()
    return img, torch.tensor([0, 1] * 4, device="cuda")


def _bn_trainer(cfg, tmp: Path, mesh=None):
    from cross_attention_vit_tpu_torch.models.vit3d import ViT3D

    flat = ckpt.restore_flat(tmp / "bn_init.npz")
    trees = {w: ckpt.unflatten({k[len(w) + 1:]: v for k, v in flat.items()
                                if k.startswith(w + "/")}) for w in ("params", "state")}
    return Trainer(ViT3D, cfg, max_epochs=1, stateful=True, schedule="plateau", mesh=mesh,
                   device="cuda").init_state(trees["params"], trees["state"])


def _bn_steps(t, rows, steps: int = BN_STEPS) -> dict:
    """BN_STEPS stateful steps at learning rate 0 on ``rows`` of each step's
    batch: the first step's whole gradients, the losses, ms, launches and
    the BatchNorm buffers after each step.  At learning rate 0 the second
    step's statistics come from the same parameters in both runs: Adam's
    first update is ±lr wherever a gradient sits in its rounding noise, and
    a batch split another way rounds otherwise."""
    out = {"loss": [], "step_ms": [], "buffers": []}
    _zero_counts()
    for s in range(steps):
        img, labels = (x[rows] for x in _bn_batch(t.config, s))
        aux, ms = _timed_step(t.train_step, img, labels, 0.0, torch.Generator().manual_seed(s))
        out["loss"].append(float(aux["loss"]))
        out["step_ms"].append(ms)
        if s == 0:
            out["grads"] = _full_grads(t)
        out["buffers"].append({n: b.detach().clone() for n, b in unwrap(t.model).named_buffers()
                               if n.endswith(("running_mean", "running_var"))})
    out["launches"] = _counts()
    return out


def phase_train_sync_bn(tmp: Path) -> dict:
    """Phase train_sync_bn: ViT3D at train_vit3d's width (CNN3DEncoder 128/256/
    512/1024, hidden 1024, 16 heads, 4 layers, 257 tokens, T1c) over two gloo
    ranks sharing the card, (data 2), 4 volumes a rank, against one process
    at batch 8: the running statistics after each of BN_STEPS steps (the
    global batch's, ``ops.conv.batch_norm3d``), the first step's gradients,
    both ranks' buffers bit-equal."""
    from cross_attention_vit_tpu_torch.models.convert import jax_state_from_model
    from cross_attention_vit_tpu_torch.models.vit3d import ViT3D

    _fresh_peak()
    cfg = _bn_cfg()
    model = ViT3D(cfg, device="cuda", generator=torch.Generator(device="cuda").manual_seed(0))
    n_params = model.num_params()
    save_pytree(tmp / "bn_init.npz", {"params": jax_params_from_model(model),
                                      "state": jax_state_from_model(model)})
    del model
    one = _bn_steps(_bn_trainer(cfg, tmp), slice(None))
    # the one-process gradient's own spread: the same step on the batch's rows
    # in other orders
    floor = {}
    for order in BN_REORDERS:
        rows = torch.tensor(order, device="cuda")
        errs = _leaf_errs(_bn_steps(_bn_trainer(cfg, tmp), rows, steps=1)["grads"], one["grads"])
        floor = {n: max(e, floor.get(n, 0.0)) for n, e in errs.items()}
    torch.save({"grads": {n: g.cpu() for n, g in one["grads"].items()},
                "buffers": [{n: b.cpu() for n, b in bufs.items()} for bufs in one["buffers"]],
                "floor": floor}, tmp / "bn_ref.pt")
    del one["grads"], one["buffers"]
    _fresh_peak()
    ranks = _gloo_ranks("--bn-worker", 2, tmp, "sync_bn", COMPOSE_TIMEOUT_S)
    check(ranks[0]["buffers_sha256"] == ranks[1]["buffers_sha256"],
          "the two ranks' BatchNorm buffers differ")
    for r, got in enumerate(ranks):
        for s, worst in enumerate(got["stat_rel_worst"]):
            check(worst[1] <= BN_STAT_REL_TOL,
                  f"SyncBN rank {r} step {s}: running statistic {worst[0]} rel "
                  f"{worst[1]:.3e} > {BN_STAT_REL_TOL}")
        name, err, bound = got["grad_worst_gated"]
        check(err <= bound, f"SyncBN rank {r}: gradient of {name} {err:.3e} > {bound:.3e} "
                            f"(max of {KERNEL_TOL[torch.float32]} and {BN_NOISE_FACTOR} x its "
                            "reorder spread)")
        check(got["sync_groups"] == 4, f"SyncBN rank {r}: {got['sync_groups']} BatchNorms synced")
        check(all(np.isfinite(got["loss"])), f"SyncBN rank {r}: non-finite losses")
    result = {"phase": "train_sync_bn", "model": "ViT3D", "params": n_params,
              "stem": "CNN3DEncoder 128/256/512/1024", "tokens": 257, "mesh": {"data": 2},
              "volumes_per_rank": 4, "steps": BN_STEPS, "lr": 0.0, "dtype": "float32",
              "backend": "gloo, two ranks sharing one card (not a speed figure)",
              "one_process": {"loss": one["loss"], "step_ms": one["step_ms"],
                              "launches": one["launches"]},
              "stat_rel_tol": BN_STAT_REL_TOL, "grad_tol": KERNEL_TOL[torch.float32],
              "grad_noise_factor": BN_NOISE_FACTOR, "reorders": BN_REORDERS,
              "reorder_spread_worst": list(max(floor.items(), key=lambda kv: kv[1])),
              "ranks": ranks}
    emit(result)
    return result


def bn_worker(rank: int, world: int, port: int, tmp: Path) -> int:
    """One of phase train_sync_bn's two gloo ranks on cuda:0."""
    multihost_init(f"127.0.0.1:{port}", world, rank, backend="gloo", device="cuda",
                   timeout_s=COMPOSE_TIMEOUT_S)
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        cfg = _bn_cfg()
        mesh = make_mesh(world)
        torch.cuda.reset_peak_memory_stats()
        t = _bn_trainer(cfg, tmp, mesh)
        per = 8 // world
        got = _bn_steps(t, slice(rank * per, (rank + 1) * per))
        ref = torch.load(tmp / "bn_ref.pt", map_location="cuda")
        rel = [{n: float((b - want[n]).abs().max() / want[n].abs().max())
                for n, b in bufs.items()} for bufs, want in zip(got["buffers"], ref["buffers"])]
        errs = _leaf_errs(got["grads"], ref["grads"])
        bound = {n: max(KERNEL_TOL[torch.float32], BN_NOISE_FACTOR * f)
                 for n, f in ref["floor"].items()}
        gated = {n: e for n, e in errs.items() if n not in BN_ZERO_GRAD}
        worst = max(gated, key=lambda n: gated[n] / bound[n])
        digest = hashlib.sha256()
        for bufs in got["buffers"]:
            for n in sorted(bufs):
                digest.update(bufs[n].cpu().numpy().tobytes())
        out = {"rank": rank, "loss": got["loss"], "step_ms": got["step_ms"],
               "launches": got["launches"], "stat_rel": rel,
               "stat_rel_worst": [list(max(r.items(), key=lambda kv: kv[1])) for r in rel],
               "grad_worst_gated": [worst, gated[worst], bound[worst]],
               "grad_zero_in_exact_arithmetic": {n: errs[n] for n in BN_ZERO_GRAD},
               # the leaves nearest their bounds: (name, error, reorder spread)
               "grad_nearest_bound": [[n, gated[n], ref["floor"][n]] for n in sorted(
                   gated, key=lambda n: -gated[n] / bound[n])[:6]],
               "sync_groups": sum(getattr(m, "sync_group", None) is not None
                                  for m in unwrap(t.model).modules()),
               "buffers_sha256": digest.hexdigest(),
               "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9}
        (tmp / f"sync_bn_rank{rank}.json").write_text(json.dumps(out))
    finally:
        torch.distributed.destroy_process_group()
    return 0


# -- the legacy families, the DICOM path and the convert CLI --------------------

# phase legacy_rsna: synthetic DICOM cases (slices per case 64 + 2·i)
RSNA_CASES = 8
# ViT3D's step and the other legacy steps timed by CUDA events
LEGACY_STEPS = 3


def _cuda_step_ms(fn, steps: int = LEGACY_STEPS) -> list[float]:
    """Each call's ms by CUDA events, one after another."""
    times = []
    for _ in range(steps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def _fresh_peak() -> None:
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


# the port's conv3d with the process-wide TF32 flag on against off: its
# input and weight gradients (cuDNN's backward is not bitwise deterministic,
# so not bit for bit) within f32 reordering, far below TF32's error (~3e-4
# normalised on the forward, ``library_tf32_vs_f32_norm_err``)
TF32_GRAD_TOL = 1e-5
# each of conv3d's three products against an f64 conv on the same inputs,
# normalised by the f64 maximum: the same f32 bound
CONV_F64_TOL = TF32_GRAD_TOL
# (name, input shape at batch 8, output channels, kernel, stride, padding):
# the legacy stems' convolutions that carry their time
CONV_SHAPES = (("vit3d conv1", (8, 1, 128, 128, 64), 128, 3, 1, 1),
               ("vit3d conv2", (8, 128, 64, 64, 32), 256, 3, 1, 1),
               ("vit3d conv3", (8, 256, 32, 32, 16), 512, 3, 2, 1),
               ("vit3d conv4", (8, 512, 16, 16, 8), 1024, 3, 2, 1),
               ("cnn_vit inc.conv2", (8, 16, 128, 128, 64), 16, 3, 1, 1),
               ("densenet conv0", (8, 1, 128, 128, 64), 64, 7, 2, 3))


def _tf32_scoping() -> dict:
    """The port's conv3d under the process-wide cuDNN TF32 flag on and off:
    the forward equal bit for bit and both gradients within
    ``TF32_GRAD_TOL`` (its cuDNN calls are given allow_tf32=False; its weight
    gradient is GEMMs); F.conv3d itself with the flag on, beside it, shows
    what TF32 would have changed.  ViT3D's conv2 shape at batch 2."""
    from cross_attention_vit_tpu_torch.ops.conv import conv3d

    g = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn((2, 128, 64, 64, 32), generator=g, device="cuda", requires_grad=True)
    w = (torch.randn((256, 128, 3, 3, 3), generator=g, device="cuda") * 0.03).requires_grad_()
    out, dx, dw = {}, {}, {}
    flag = torch.backends.cudnn.allow_tf32
    try:
        for on in (True, False):
            torch.backends.cudnn.allow_tf32 = on
            y = conv3d(x, w, padding=1)
            dx[on], dw[on] = torch.autograd.grad(y.square().sum(), (x, w))
            out[on] = y.detach()
        torch.backends.cudnn.allow_tf32 = True
        with torch.no_grad():
            tf32 = F.conv3d(x, w, padding=1)
    finally:
        torch.backends.cudnn.allow_tf32 = flag
    result = {"flag_on_equals_off": bool(torch.equal(out[True], out[False])),
              "grad_flag_on_vs_off_norm_err": {
                  "dx": _norm_err(dx[True], dx[False])[1], "dw": _norm_err(dw[True], dw[False])[1]},
              "grad_tol": TF32_GRAD_TOL,
              "library_tf32_vs_f32_norm_err": _norm_err(tf32, out[False])[1]}
    check(result["flag_on_equals_off"]
          and max(result["grad_flag_on_vs_off_norm_err"].values()) <= TF32_GRAD_TOL,
          f"conv3d ran TF32 under the process-wide flag: {result}")
    return result


def _conv_products() -> list[dict]:
    """conv3d's three products (forward, input gradient, weight gradient) at
    each of ``CONV_SHAPES``: against an f64 conv on two samples (the port's
    gated at ``CONV_F64_TOL``, cuDNN's own f32 products beside them) and
    timed at batch 8 against cuDNN's (F.conv3d; ``aten.convolution_backward``
    for one gradient at a time), the cuDNN TF32 flag off."""
    from cross_attention_vit_tpu_torch.ops import conv as tc

    def cudnn_grad(g, x, w, s, p, which):
        mask = [which == "dx", which == "dw", False]
        out = torch.ops.aten.convolution_backward(g, x, w, None, [s] * 3, [p] * 3, [1] * 3,
                                                  False, [0] * 3, 1, mask)
        return out[0] if which == "dx" else out[1]

    flag = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    rows = []
    try:
        for name, shape, co, k, s, p in CONV_SHAPES:
            gen = torch.Generator(device="cuda").manual_seed(6)
            x = torch.randn(shape, generator=gen, device="cuda")
            w = torch.randn((co, shape[1], k, k, k), generator=gen, device="cuda") \
                * (shape[1] * k ** 3) ** -0.5
            out = F.conv3d(x[:1], w, None, s, p).shape[2:]
            g = torch.randn((shape[0], co, *out), generator=gen, device="cuda")
            kk, st, pd = (k,) * 3, (s,) * 3, (p,) * 3
            extra = [shape[2 + i] + 2 * p - k - (out[i] - 1) * s for i in range(3)]
            port = {"y": lambda x, g, w: tc._conv(x, w, st, pd),
                    "dx": lambda x, g, w: tc._conv_transpose(g, w, st, pd, extra),
                    "dw": lambda x, g, w: tc._weight_grad(x, g, kk, st, pd)}
            cudnn = {"y": lambda x, g, w: F.conv3d(x, w, None, s, p),
                     "dx": lambda x, g, w: cudnn_grad(g, x, w, s, p, "dx"),
                     "dw": lambda x, g, w: cudnn_grad(g, x, w, s, p, "dw")}
            row = {"shape": name, "x": list(shape), "out_channels": co, "kernel": k,
                   "stride": s, "padding": p, "vs_f64_norm_err": {}, "cudnn_vs_f64_norm_err": {},
                   "ms": {}, "cudnn_ms": {}}
            for prod in ("y", "dx", "dw"):
                ref = cudnn[prod](x[:2].double(), g[:2].double(), w.double())
                row["vs_f64_norm_err"][prod] = _norm_err(port[prod](x[:2], g[:2], w), ref)[1]
                row["cudnn_vs_f64_norm_err"][prod] = _norm_err(cudnn[prod](x[:2], g[:2], w),
                                                               ref)[1]
                del ref
                row["ms"][prod] = device_ms(lambda: port[prod](x, g, w), calls=3, warmup=1)
                row["cudnn_ms"][prod] = device_ms(lambda: cudnn[prod](x, g, w), calls=3, warmup=1)
            rows.append(row)
            del x, w, g
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.allow_tf32 = flag
    bad = [r for r in rows if max(r["vs_f64_norm_err"].values()) > CONV_F64_TOL]
    check(not bad, f"conv3d's products stray from f64 beyond {CONV_F64_TOL}: {bad}")
    return rows


def phase_legacy_vit3d(tmp: Path) -> dict:
    """train_vit3d at its own configuration (ViT3D, CNN3DEncoder 128/256/512/
    1024, hidden 1024, 16 heads, 4 layers, 128×128×64, T1c, dropout 0.1,
    plateau, 257 tokens) over a synthetic T1c cohort at batch 8: one epoch,
    then a fresh stateful Trainer resumed from the driver's checkpoint trains
    the second on the driver's split and sampler; the BatchNorm buffers
    across train and eval steps; step time and peak memory."""
    from cross_attention_vit_tpu_torch.data.dataset import (BrainDataset, WeightedRandomSampler,
                                                            create_sampler_weights)
    from cross_attention_vit_tpu_torch.data.labels import (clean_data, load_labels,
                                                           train_test_split)
    from cross_attention_vit_tpu_torch.data.loader import PrefetchLoader
    from cross_attention_vit_tpu_torch.drivers.experiments import filter_available
    from cross_attention_vit_tpu_torch.drivers.legacy import train_vit3d
    from cross_attention_vit_tpu_torch.models.vit3d import ViT3D

    root = tmp / "legacy_vit3d"
    try:
        t0 = time.perf_counter()
        labels, data, _ = _write_cohort(root, ("T1c",))
        cohort_s = time.perf_counter() - t0
        out = root / "runs"
        _fresh_peak()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):        # its epoch lines
            trainer, hist = train_vit3d(labels_csv=labels, folder=data, out_dir=out,
                                        max_epochs=1, batch_size=8, only_available=True,
                                        device="cuda")
        torch.cuda.synchronize()
        runs = [{"epochs": 1, "wall_s": time.perf_counter() - t0,
                 "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9, "history": hist}]
        # resumed to two epochs: the driver's epoch-0 checkpoint (params, Adam,
        # model_state, plateau) as the rolling checkpoint of a fresh stateful
        # Trainer, which restores it and trains epoch 1 on the driver's split
        cfg = trainer.config
        saved = (ckpt.flatten(trainer.model_state), trainer.plateau)
        latest = ckpt.LatestCheckpointer(out / "latest")
        latest.save(trainer.global_step, ckpt.restore_flat(trainer.checkpoint.best_path()))
        del trainer
        trainer = Trainer(ViT3D, cfg, max_epochs=2, stateful=True, schedule="plateau",
                          checkpoint_monitor="train_loss", seed=909, latest=latest,
                          device="cuda").init_state()
        resumed_at = trainer.maybe_resume()
        got = ckpt.flatten(trainer.model_state)
        state_equal = got.keys() == saved[0].keys() and all(
            np.array_equal(got[k], v) for k, v in saved[0].items())
        f32 = np.float32
        plateau_equal = (f32(trainer.plateau.lr) == f32(saved[1].lr)
                         and f32(trainer.plateau.best) == f32(saved[1].best)
                         and trainer.plateau.num_bad == saved[1].num_bad)
        resume = {"epoch": resumed_at, "global_step": trainer.global_step,
                  "model_state_equal": state_equal, "plateau_equal": plateau_equal}
        train_df, val_df = train_test_split(
            filter_available(clean_data(load_labels(labels), cfg.target), data), 0.15, 909)
        sampler = WeightedRandomSampler(create_sampler_weights(train_df, cfg.target),
                                        num_samples=len(train_df), seed=909)
        train_ld, val_ld = (PrefetchLoader(BrainDataset(df, cfg, types=("T1c",), is_train=tr,
                                                        folder=data),
                                           batch_size=8, num_workers=5, device="cuda")
                            for df, tr in ((train_df, True), (val_df, False)))
        _fresh_peak()
        t0 = time.perf_counter()
        hist = trainer.fit(train_ld, val_ld, sampler=sampler, start_epoch=resumed_at,
                           verbose=False)
        torch.cuda.synchronize()
        runs.append({"epochs": 2, "wall_s": time.perf_counter() - t0,
                     "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9,
                     "history": hist})
        cfg = trainer.config
        tokens = trainer.model.pos_embed.shape[1]
        params = trainer.model.num_params()
        table = clean_data(load_labels(labels), cfg.target)
        img, lab = BrainDataset(table, cfg, types=("T1c",), is_train=False,
                                folder=data).batch(range(8))
        img, lab = torch.from_numpy(img).cuda(), torch.from_numpy(lab).cuda()

        # eval reads the running statistics and moves none; train moves them
        state0 = ckpt.flatten(trainer.model_state)
        aux = trainer.eval_step(img, lab)
        with torch.no_grad():
            direct = trainer.model(img)
        eval_equal = bool(torch.equal(aux["logits"], direct))
        eval_still = all(np.array_equal(v, state0[k])
                         for k, v in ckpt.flatten(trainer.model_state).items())
        _fresh_peak()
        gen = torch.Generator().manual_seed(1)
        step_ms = _cuda_step_ms(lambda: trainer.train_step(img, lab, cfg.lr, gen))
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        profile = _profiled(lambda: trainer.train_step(img, lab, cfg.lr, gen))
        moved = [k for k, v in ckpt.flatten(trainer.model_state).items()
                 if not np.array_equal(v, state0[k])]
        tf32 = _tf32_scoping()
        conv_products = _conv_products()
        del trainer, aux, direct
    finally:
        shutil.rmtree(root, ignore_errors=True)
    hist = [row for r in runs for row in r["history"]]
    result = {"phase": "legacy_vit3d", "model": "ViT3D (CNN3DEncoder)", "params": params,
              "tokens": tokens, "batch": 8, "img_size": list(cfg.img_size),
              "hidden_dim": cfg.hidden_dim, "dropout": cfg.dropout, "cohort_write_s": cohort_s,
              "runs": [{k: v for k, v in r.items() if k != "history"} for r in runs],
              "history": hist, "resume": resume, "eval_step_equals_direct": eval_equal,
              "eval_leaves_state": eval_still, "bn_buffers_moved_by_train_step": len(moved),
              "step_ms": step_ms, "step_ms_steady": statistics.median(step_ms[1:]),
              "peak_device_gb": peak_gb, "profile": profile, "tf32": tf32,
              "conv_products": conv_products}
    emit(result)
    check(len(runs[0]["history"]) == 1 and len(runs[1]["history"]) == 1,
          f"epochs run: {[len(r['history']) for r in runs]} (1, then 1 resumed, expected)")
    check(all(np.isfinite(v) for row in hist for v in row.values()),
          f"non-finite history: {hist}")
    check(resume["epoch"] == 1 and resume["model_state_equal"] and resume["plateau_equal"],
          f"the resumed state differs from the saved one: {resume}")
    check(eval_equal and eval_still, "the stateful eval step moved the BatchNorm buffers or "
                                     "differs from a direct eval forward")
    check(len(moved) == 8, f"train steps moved {len(moved)} of the 8 BatchNorm buffers")
    check(tokens == 257, f"ViT3D has {tokens} tokens, 257 expected")
    return result


def phase_legacy_densenet() -> dict:
    """ViT3D with the DenseNet-121 stem truncated at denseblock3.denselayer24
    .layers.conv1 (hidden 64 = bn_size 4 × growth 16, 4 heads, one modality,
    128×128×64, batch 8): the stem's output shape, one stateful train step,
    one eval forward."""
    from cross_attention_vit_tpu_torch.models.vit3d import DENSENET_TRUNCATION, ViT3D
    from cross_attention_vit_tpu_torch.train.trainer import make_stateful_train_step

    cfg = get_mgmt_config()
    modify_config(cfg, dict(hidden_dim=64, num_heads=4, num_modalities=1, pretrained_cnn=True,
                            lr=1e-4, dropout=0.1, weight_decay=5e-4, label_smoothing=0.0,
                            img_aug=False, optim_params={"factor": 0.5, "patience": 10}))
    _fresh_peak()
    model = ViT3D(cfg, device="cuda", generator=torch.Generator(device="cuda").manual_seed(2))
    rng = np.random.default_rng(7)
    img = torch.from_numpy((rng.normal(size=(8, 1, 1, *cfg.img_size)) * 100)
                           .astype(np.float32)).cuda()
    labels = torch.tensor([0, 1] * 4, device="cuda")
    with torch.no_grad():
        stem = tuple(model.encoder(img[:, 0], False, upto=DENSENET_TRUNCATION).shape)
    step = make_stateful_train_step(model, Adam(model.parameters(), cfg.weight_decay), cfg)
    gen = torch.Generator().manual_seed(3)
    losses = []
    step_ms = _cuda_step_ms(lambda: losses.append(float(step(img, labels, cfg.lr, gen)["loss"])))
    profile = _profiled(lambda: step(img, labels, cfg.lr, gen))
    with torch.no_grad():
        logits = model(img)
    result = {"phase": "legacy_densenet", "model": "ViT3D (DenseNet-121 stem)",
              "params": model.num_params(), "truncation": DENSENET_TRUNCATION,
              "stem_output": list(stem), "tokens": model.pos_embed.shape[1], "batch": 8,
              "losses": losses, "step_ms": step_ms,
              "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9, "profile": profile,
              "eval_logits_finite": bool(torch.isfinite(logits).all())}
    emit(result)
    del model, step
    check(stem == (8, 64, 8, 8, 4), f"the truncated stem emits {stem}, (8, 64, 8, 8, 4) expected")
    check(all(np.isfinite(losses)) and result["eval_logits_finite"],
          f"non-finite DenseNet-stem ViT3D: losses {losses}")
    return result


def phase_legacy_cnn_vit() -> dict:
    """CNNViT at its defaults (hidden 128, grid 8³, 4 layers, 8 heads, MLP
    512, encoder channels 16/32/64, down 2) on 2 modalities at 128×128×64,
    batch 8: forward, BCE, Adam steps (the reference's lr 1e-3)."""
    from cross_attention_vit_tpu_torch.models.cnn_vit import CNNViT

    cfg = get_mgmt_config()
    modify_config(cfg, {"num_modalities": 2})
    _fresh_peak()
    model = CNNViT(cfg, device="cuda", generator=torch.Generator(device="cuda").manual_seed(4))
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    opt = Adam(model.parameters())
    rng = np.random.default_rng(8)
    img = torch.from_numpy(rng.normal(size=(8, 2, 1, *cfg.img_size)).astype(np.float32)).cuda()
    labels = torch.tensor([0.0, 1.0] * 4, device="cuda")
    losses = []

    def train_step():
        for p in model.parameters():
            p.grad = None
        logits, loss = model(img, labels, train=True)
        loss.backward()
        opt.step(1e-3)
        losses.append(loss.item())
        return logits

    step_ms = _cuda_step_ms(train_step)
    profile = _profiled(train_step)
    changed = sum(not torch.equal(before[n], p) for n, p in model.named_parameters())
    result = {"phase": "legacy_cnn_vit", "model": "CNNViT", "params": model.num_params(),
              "tokens": 1 + 2 * (model.pos_embed.shape[1] - 1), "batch": 8, "losses": losses,
              "step_ms": step_ms, "params_changed": changed,
              "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9, "profile": profile}
    emit(result)
    n_params = len(before)
    del model, opt, before
    check(all(np.isfinite(losses)), f"non-finite CNNViT loss: {losses}")
    check(changed == n_params, f"{changed} of {n_params} CNNViT parameters changed")
    return result


def _write_rsna(root: Path) -> tuple[Path, Path]:
    """RSNA_CASES DICOM series of 64 + 2·i slices at 256×256 (a disc whose
    radius peaks at slice 20 + 3·i, over noise), written by the port's
    write_dicom, and a labels CSV with zero-padded IDs."""
    from cross_attention_vit_tpu_torch.data.dicom import write_dicom

    folder = root / "rsna"
    yy, xx = np.mgrid[:256, :256]
    ids = [f"{i:05d}" for i in range(RSNA_CASES)]
    for i, case in enumerate(ids):
        d = folder / case / "FLAIR"
        d.mkdir(parents=True)
        rng = np.random.default_rng(30 + i)
        n, peak = 64 + 2 * i, 20 + 3 * i
        for j in range(n):
            r = 20 + 80 * (1 - abs(j - peak) / n)
            px = rng.integers(0, 50, size=(256, 256)).astype(np.uint16)
            px[(yy - 128) ** 2 + (xx - 128) ** 2 < r * r] += np.uint16(600 + 5 * j)
            write_dicom(d / f"Image-{j + 1}.dcm", px, window_center=400, window_width=900,
                        instance_number=j + 1)
    labels = root / "train_labels.csv"
    labels.write_text("ID,MGMT_value\n" + "".join(f"{c},{i % 2}\n" for i, c in enumerate(ids)))
    return labels, folder


def phase_legacy_rsna(tmp: Path) -> dict:
    """train_rsna end to end at rsna_config's full width (ModelVIT hidden
    512, 8 heads, 4 layers, (32, 32, 32) patches over 256×256×64, 129 tokens)
    with bf16 compute and flash attention: 1 epoch at batch 4 on synthetic
    DICOM cases, then predict.  K1 and K2 at B=4 K=8 N=129: 4 launches of
    each a train step (the last one, eval and predict at B=2: the kernel
    phases hold both shapes); the step timed and profiled under
    profile_trace."""
    from cross_attention_vit_tpu_torch.data.dataset_rsna import RSNADataset
    from cross_attention_vit_tpu_torch.data.labels import load_labels, train_test_split
    from cross_attention_vit_tpu_torch.drivers.legacy import train_rsna
    from cross_attention_vit_tpu_torch.utils.profiling import profile_trace

    root = tmp / "legacy_rsna"
    try:
        t0 = time.perf_counter()
        labels, folder = _write_rsna(root)
        write_s = time.perf_counter() - t0
        _fresh_peak()
        _zero_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            trainer, hist, preds = train_rsna(
                labels_csv=labels, folder=folder, out_dir=root / "runs", num_imgs=64, size=256,
                max_epochs=1, batch_size=4, seed=0,
                overrides={"compute_dtype": "bfloat16", "use_flash_attention": True},
                device="cuda")
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = _counts()
        train_df, val_df = train_test_split(load_labels(labels), 0.2, 0)
        steps, val_batches = -(-len(train_df) // 4), -(-len(val_df) // 4)
        # the batch sizes the run gave K1 and K2 (the last batch is short)
        batch_rows = {min(4, n - b0) for n in (len(train_df), len(val_df))
                      for b0 in range(0, n, 4)}
        cfg = trainer.config
        img, lab = RSNADataset(train_df, folder=folder, num_imgs=64, size=256).batch(range(4))
        img, lab = torch.from_numpy(img).cuda(), torch.from_numpy(lab).cuda()
        gen = torch.Generator().manual_seed(2)
        _fresh_peak()
        _zero_counts()
        step_ms = _cuda_step_ms(lambda: trainer.train_step(img, lab, cfg.lr, gen))
        per_step = {k: v / LEGACY_STEPS for k, v in _counts().items() if v}
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        profile = _profiled(lambda: trainer.train_step(img, lab, cfg.lr, gen))
        trace = {}
        for attempt in range(3):            # a profile now and then records no kernel
            with profile_trace(root / "trace"):
                trainer.train_step(img, lab, cfg.lr, gen)
            text = (root / "trace" / "trace.json").read_text()
            trace = {"attempt": attempt, "bytes": len(text),
                     "k1_events": text.count("attn_fwd_qkv"), "k2_events": text.count("attn_bwd_")}
            if trace["k1_events"] and trace["k2_events"]:
                break
        del trainer
    finally:
        shutil.rmtree(root, ignore_errors=True)
    result = {"phase": "legacy_rsna", "model": "ModelVIT (rsna_config)", "tokens": 129,
              "attention_shape": "B=4 K=8 D=64 N=129", "cases": RSNA_CASES,
              "dicom_write_s": write_s, "wall_s": wall_s, "history": hist,
              "predictions": preds.tolist(), "steps": steps, "val_batches": val_batches,
              "attention_batches": sorted(batch_rows),
              "launches": launches, "launches_per_timed_step": per_step, "step_ms": step_ms,
              "step_ms_steady": statistics.median(step_ms[1:]), "peak_device_gb": peak_gb,
              "profile": profile, "profile_trace": trace}
    emit(result)
    check(all(np.isfinite(v) for row in hist for v in row.values()),
          f"non-finite RSNA history: {hist}")
    check(len(preds) == len(val_df) and bool(((preds >= 0) & (preds <= 1)).all()),
          f"predictions {preds}")
    held = {(B, K, N) for B, K, N in RSNA_ATTN_SHAPES}
    check({(b, 8, 129) for b in batch_rows} <= held,
          f"the RSNA run gave K1/K2 batches {sorted(batch_rows)}; the kernel phases hold "
          f"{sorted(held)}")
    # train: 4 layers a step; eval and predict: 4 each per validation batch
    want = {"K1": 4 * (steps + 2 * val_batches), "K2": 4 * steps}
    check({k: launches[k] for k in want} == want, f"RSNA run launches {launches}, want {want}")
    check(per_step.get("K1") == 4 and per_step.get("K2") == 4,
          f"a timed RSNA step launched {per_step}, 4 K1 and 4 K2 expected")
    check(trace["k1_events"] > 0 and trace["k2_events"] > 0,
          f"profile_trace's trace holds no K1/K2 kernel: {trace}")
    return result


def phase_convert_cli(tmp: Path) -> dict:
    """A Lightning-style container of the live ModelCross (f32 weights from a
    seed) through the port's convert CLI to an npz; evaluate.main on that npz
    against a direct forward of the same weights; --export back to the
    container's state dict bit for bit."""
    from cross_attention_vit_tpu_torch.data.dataset import BrainDataset
    from cross_attention_vit_tpu_torch.data.labels import clean_data, load_labels
    from cross_attention_vit_tpu_torch.drivers import convert
    from cross_attention_vit_tpu_torch.models.convert import load_jax_params

    root = tmp / "convert_cli"
    try:
        cfg = live_config(use_flash=True)
        source = ModelCross(cfg, device="cuda", master_weights=True,
                            generator=torch.Generator(device="cuda").manual_seed(6))
        sd = {k: v.detach().cpu() for k, v in source.state_dict().items()}
        root.mkdir(parents=True)
        torch.save({"state_dict": {f"model.{k}": v for k, v in sd.items()}, "epoch": 7},
                   root / "ref.ckpt")
        labels, data, _ = _write_cohort(root, MODALITIES, subjects=4, volume=VOLUME)
        flags = ["--model", "cross", "--torch-ckpt", str(root / "ref.ckpt"), "--img-types",
                 *MODALITIES, "--attn-order", "0:1,1:2,2:0", "--set", "compute_dtype='bfloat16'",
                 "--set", "activation_dtype='bfloat16'", "--set", "use_flash_attention=True",
                 "--set", "gelu_approx=True", "--out", str(root / "migrated.npz")]
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            npz = convert.main(flags)
        import_s = time.perf_counter() - t0
        _zero_counts()
        with contextlib.redirect_stdout(sys.stderr):
            metrics = evaluate.main(["--checkpoint", str(npz), "--model", "cross", "--labels",
                                     str(labels), "--data", str(data), "--img-types",
                                     *MODALITIES, "--only-available"])
        eval_launches = _counts()
        direct_model = ModelCross(ckpt.load_config_for(npz), device="cuda", master_weights=True)
        load_jax_params(direct_model, params_from_flat(ckpt.restore_flat(npz)))
        table = clean_data(load_labels(labels), "MGMT status")
        ds = BrainDataset(table, cfg, types=MODALITIES, is_train=False, folder=data)
        imgs, targets = ds.batch(range(len(ds)))
        x = torch.from_numpy(imgs).to(torch.bfloat16).cuda()
        with torch.inference_mode():
            logits = direct_model(x).float().cpu()
            source_logits = source(x).float().cpu()
        direct = _metrics_as_evaluate(logits, torch.from_numpy(targets))
        with contextlib.redirect_stdout(sys.stderr):
            pt = convert.main(["--model", "cross", "--checkpoint", str(npz), "--export",
                               "--out", str(root / "back.pt")])
        exported = torch.load(pt)
        export_equal = set(exported) == set(sd) and all(torch.equal(exported[k], v)
                                                        for k, v in sd.items())
        del source, direct_model
    finally:
        shutil.rmtree(root, ignore_errors=True)
    result = {"phase": "convert_cli", "model": "ModelCross (live, 241.9M)", "container":
              "Lightning {'state_dict': {'model.' + name: tensor}}", "import_s": import_s,
              "evaluate": metrics, "direct": direct, "evaluate_launches": eval_launches,
              "source_vs_npz_logits_max_abs": (logits - source_logits).abs().max().item(),
              "export_bit_equal": export_equal, "tensors": len(sd)}
    emit(result)
    check(metrics == direct, f"evaluate.main {metrics} != direct forward {direct}")
    check(result["source_vs_npz_logits_max_abs"] == 0.0,
          "the migrated npz's forward differs from the source model's")
    check(export_equal, "--export did not return the source state dict bit for bit")
    return result


def _launch_rows(paths: dict[str, dict]) -> dict[str, dict]:
    """Each kernel's launches summed over the main paths' runs, and by path."""
    rows = {}
    for kernel in _COUNTERS:
        by_path = {path: counts[kernel] for path, counts in paths.items() if counts.get(kernel)}
        rows[kernel] = {"launches": sum(by_path.values()), "launches_by_path": by_path}
    return rows


def main() -> int:
    t_start = time.perf_counter()
    try:
        device = phase_device()
        phase_build()
        k1 = phase_kernels()
        k2 = phase_kernels_k2()
        k3, k4 = phase_kernels_resample()
        k7 = phase_kernels_k7()
        k5 = phase_kernels_k5()
        k6 = phase_kernels_k6()
        k8 = phase_kernels_k8()
        with tempfile.TemporaryDirectory() as tmp:
            served = phase_serve(Path(tmp))
            served_vit = phase_serve_vit(Path(tmp))
            served_int8 = phase_serve_int8(Path(tmp))
        trained = phase_train()
        with tempfile.TemporaryDirectory() as tmp:
            trained_dp = phase_train_dp(Path(tmp))
        trained_vit = phase_train_vit()
        with tempfile.TemporaryDirectory() as tmp:
            trained_moe = phase_train_moe(Path(tmp))
        ring = phase_ring()
        with tempfile.TemporaryDirectory() as tmp:
            trained_tp, served_tp, trained_pp = phase_split(Path(tmp))
        with tempfile.TemporaryDirectory() as tmp:
            trained_tp_ep = phase_train_tp_ep(Path(tmp))
        with tempfile.TemporaryDirectory() as tmp:
            trained_sync_bn = phase_train_sync_bn(Path(tmp))
        with tempfile.TemporaryDirectory() as tmp:
            trained_cli = phase_train_cli(Path(tmp))
        with tempfile.TemporaryDirectory() as tmp:
            phase_legacy_vit3d(Path(tmp))
        phase_legacy_densenet()
        phase_legacy_cnn_vit()
        with tempfile.TemporaryDirectory() as tmp:
            legacy_rsna = phase_legacy_rsna(Path(tmp))
        with tempfile.TemporaryDirectory() as tmp:
            converted = phase_convert_cli(Path(tmp))
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    paths = {"serve": {"K1": served["kernel_launches"]}, "train": trained["launches"]}
    for mode, result in trained_dp["nccl_world_1"].items():
        paths[f"train_dp_{mode}"] = result["launches"]
    for result in trained_dp["gloo_two_ranks"]["ranks"]:
        paths[f"train_dp_gloo_rank{result['rank']}"] = result["launches"]
    for name, result in served_vit.items():
        paths[f"serve_{name}"] = result["launches"]
    for name, result in trained_vit.items():
        paths[f"train_{name}"] = result["launches"]
    for mode, result in served_int8["modes"].items():
        paths[f"serve_{mode}"] = result["launches"]
    for name, result in served_int8["vit"].items():
        paths[f"serve_int8+attn_{name}"] = result["launches"]
    for r in trained_cli["runs"]:
        paths[f"train_cli_{r['epochs']}_epochs"] = r["launches"]
    paths["train_moe"] = trained_moe["launches"]
    paths["train_moe_serve_bucket8"] = {"K1": trained_moe["serve_bucket8"]["launches"]}
    paths["train_sp_no_mesh"] = ring["sp_step"]["launches"]
    for name, result in (("train_tp", trained_tp), ("serve_tp", served_tp),
                         ("train_pp", trained_pp)):
        for r, rank in enumerate(result["ranks"]):
            paths[f"{name}_rank{r}"] = rank["launches"]
    paths["train_pp_serial_f32"] = trained_pp["serial_vs_plain"]["launches"]
    for r, rank in enumerate(trained_tp_ep["ranks"]):
        paths[f"train_tp_ep_rank{r}"] = rank["launches"]
        paths[f"serve_tp_ep_rank{r}"] = rank["serve"]["launches"]
    for r, rank in enumerate(trained_sync_bn["ranks"]):
        paths[f"train_sync_bn_rank{r}"] = rank["launches"]
    paths["legacy_rsna"] = legacy_rsna["launches"]
    paths["convert_cli_evaluate"] = converted["evaluate_launches"]
    launches = _launch_rows(paths)
    k5s, k5v = k5[513], k5[1025]
    k5_shape = "B=8 K=16 D=64 N=513 bfloat16 (ModelCross int8+attn serving shape)"
    attn = "B=8 K=16 D=64 N=513 bfloat16"
    rsna_shape = "B=4 K=8 D=64 N=129 bfloat16 (the legacy RSNA driver's training shape)"
    k7_shape = "B=8 K=16 D=64 N=1537 bfloat16 (3-stream ModelVIT training shape)"
    bound = k7["bound"]
    k6d, k6c = k6["dminor"], k6["contiguous"]
    k6_shape = "B=8 K=16 D=64 N=513 bfloat16, (B, K, D, N) views of (B, K, N, D) tensors"
    def at(e: dict, **extra) -> dict:
        """The timed numbers of a K1 or K2 entry."""
        return {"ms": e["kernel_ms"], "ms_spread": e["kernel_ms_spread"],
                "plain_ms": e["plain_ms"], "bound_ms": e["bound_us"] / 1e3,
                "bound_by": e["bound_by"], "library_ms": e["library_ms"],
                "library_ms_spread": e["library_ms_spread"], **extra}

    emit({"phase": "profiler", **PROFILER_LOG})
    emit({"kernels": [
        {**K1, **launches["K1"], "max_abs_err": k1[513]["max_abs_err"],
         "stats_err": k1[513]["stats_err"],
         **at(k1[513], with_stats_ms=k1[513]["kernel_with_stats_ms"]),
         "library": "scaled_dot_product_attention", "shape": attn,
         "at_n1025": at(k1[1025], with_stats_ms=k1[1025]["kernel_with_stats_ms"]),
         "at_n129": at(k1[129], with_stats_ms=k1[129]["kernel_with_stats_ms"],
                       shape=rsna_shape, max_abs_err=k1[129]["max_abs_err"])},
        {**K2, **launches["K2"], "max_abs_err": k2[513]["max_abs_err"],
         **at(k2[513], ms_by_kernel=k2[513]["kernel_ms_by_kernel"]),
         "run_to_run_max_abs": k2[513]["run_to_run_max_abs"],
         "library": "backward of scaled_dot_product_attention through autograd (dq, dk, dv)",
         "shape": attn, "at_n1025": at(k2[1025], ms_by_kernel=k2[1025]["kernel_ms_by_kernel"]),
         "at_n129": at(k2[129], ms_by_kernel=k2[129]["kernel_ms_by_kernel"], shape=rsna_shape,
                       max_abs_err=k2[129]["max_abs_err"])},
        {**K3, **launches["K3"], **k3,
         "shape": "V=8 (128, 128, 64) bfloat16, per launch over the 4 live LU passes"},
        {**K4, **launches["K4"], **k4,
         "shape": "V=8 (128, 128, 64) bfloat16, LU pass U0 with all 44 taps"},
        {**K7F, **launches["K7F"],
         "max_abs_err": k7["max_abs_err"]["out"], "lse_max_abs_err": k7["max_abs_err"]["lse"],
         "at_kernel_tile": k7["at_kernel_tile"],
         "ms": k7["kernel_ms"], "plain_ms": k7["plain_ms"], "bound_ms": bound["fwd"]["ms"],
         "bound_by": bound["fwd"]["by"], "library_ms": k7["library_ms"],
         "library": "scaled_dot_product_attention", "shape": k7_shape},
        {**K7DKV, **launches["K7DKV"],
         "max_abs_err": max(k7["max_abs_err"]["dk"], k7["max_abs_err"]["dv"]),
         "run_to_run_max_abs": k7["run_to_run_max_abs"],
         **part_ms(k7["bwd_kernel_ms"], "dkdv"), "plain_ms": k7["bwd_plain_ms"]["dkdv"],
         "bound_ms": bound["dkdv"]["ms"], "bound_by": bound["dkdv"]["by"],
         "library_ms": k7["bwd_library_ms"],
         "library": "backward of scaled_dot_product_attention through autograd: dq, dk and "
                    "dv together, as the dq and dk/dv kernels are together",
         "backward_bound_ms": bound["bwd"]["ms"], "shape": k7_shape},
        {**K7DQ, **launches["K7DQ"],
         "max_abs_err": k7["max_abs_err"]["dq"], "run_to_run_max_abs": k7["run_to_run_max_abs"],
         **part_ms(k7["bwd_kernel_ms"], "dq"), "plain_ms": k7["bwd_plain_ms"]["dq"],
         "bound_ms": bound["dq"]["ms"], "bound_by": bound["dq"]["by"],
         "library_ms": k7["bwd_library_ms"],
         "library": "backward of scaled_dot_product_attention through autograd (dq, dk, dv)",
         "shape": k7_shape},
        {**K5F, **launches["K5F"],
         "max_abs_err": k5s["max_abs_err"]["out"], "stats_err": k5s["stats_err"],
         "ms": k5s["kernel_ms"], "ms_spread": k5s["kernel_ms_spread"],
         "with_stats_ms": k5s["kernel_with_stats_ms"],
         "plain_ms": k5s["plain_ms"], "bound_ms": k5s["bound"]["fwd"]["ms"],
         "bound_by": k5s["bound"]["fwd"]["by"], "library_ms": k5s["library_ms"],
         "library_ms_spread": k5s["library_ms_spread"],
         "library": "scaled_dot_product_attention", "shape": k5_shape,
         "at_n1025": {"ms": k5v["kernel_ms"], "ms_spread": k5v["kernel_ms_spread"],
                      "plain_ms": k5v["plain_ms"],
                      "bound_ms": k5v["bound"]["fwd"]["ms"], "bound_by": k5v["bound"]["fwd"]["by"],
                      "library_ms": k5v["library_ms"]}},
        {**K5B, **launches["K5DQ"],
         "launches_note": "0 on every main path: no model trains through the public "
                          "flash_attention; its gradient is checked in phase kernels_k5",
         "max_abs_err": max(k5s["max_abs_err"][n] for n in ("dq", "dk", "dv")),
         "run_to_run_max_abs": k5s["run_to_run_max_abs"],
         "ms": k5s["bwd"]["kernel_ms"], "ms_spread": k5s["bwd"]["kernel_ms_spread"],
         "ms_by_kernel": k5s["bwd"]["kernel_ms_by_kernel"],
         "plain_ms": k5s["bwd"]["plain_ms"], "bound_ms": k5s["bound"]["bwd"]["ms"],
         "bound_by": k5s["bound"]["bwd"]["by"], "library_ms": k5s["bwd"]["library_ms"],
         "library_ms_spread": k5s["bwd"]["library_ms_spread"],
         "library": "backward of scaled_dot_product_attention through autograd (dq, dk, dv)",
         "shape": k5_shape,
         "at_n1025": {"ms": k5v["bwd"]["kernel_ms"], "ms_spread": k5v["bwd"]["kernel_ms_spread"],
                      "ms_by_kernel": k5v["bwd"]["kernel_ms_by_kernel"],
                      "plain_ms": k5v["bwd"]["plain_ms"],
                      "bound_ms": k5v["bound"]["bwd"]["ms"], "bound_by": k5v["bound"]["bwd"]["by"],
                      "library_ms": k5v["bwd"]["library_ms"]}},
        {**K6F, **launches["K6F"],
         "launches_note": "0 on every main path: K6 is the public flash_attention_tn, which "
                          "no module calls; it is checked in phase kernels_k6",
         "max_abs_err": k6d["max_abs_err"]["out"], "ms": k6d["kernel_ms"],
         "plain_ms": k6d["plain_ms"], "bound_ms": k6d["bound"]["fwd"]["ms"],
         "bound_by": k6d["bound"]["fwd"]["by"], "library_ms": k6d["library_ms"],
         "library": "scaled_dot_product_attention", "shape": k6_shape,
         "contiguous_bkdn": {"ms": k6c["kernel_ms"], "max_abs_err": k6c["max_abs_err"]["out"]}},
        {**K6B, **launches["K6DQ"],
         "launches_note": "0 on every main path (the public flash_attention_tn)",
         "max_abs_err": max(k6d["max_abs_err"][n] for n in ("dq", "dk", "dv")),
         "ms": k6d["bwd_kernel_ms"], "ms_by_kernel": k6d["bwd_kernel_ms_by_kernel"],
         "plain_ms": k6d["bwd_plain_ms"], "bound_ms": k6d["bound"]["bwd"]["ms"],
         "bound_by": k6d["bound"]["bwd"]["by"], "library_ms": k6d["bwd_library_ms"],
         "library": "backward of scaled_dot_product_attention through autograd (dq, dk, dv)",
         "shape": k6_shape,
         "contiguous_bkdn": {"ms": k6c["bwd_kernel_ms"],
                             "max_abs_err": max(k6c["max_abs_err"][n]
                                                for n in ("dq", "dk", "dv"))}},
        {**K8, **launches["K8"],
         "launches_note": "K8 calls (4 kernels each) on the FUSED_QKV_GRADS runs of "
                          "train_cli; the default training path leaves the flag off",
         "max_abs_err": max(k8["max_abs_err"].values()), "ms": k8["kernel_ms"],
         "ms_by_kernel": k8["kernel_ms_by_kernel"], "plain_ms": k8["plain_ms"],
         "bound_ms": k8["bound"]["ms"], "bound_by": k8["bound"]["by"],
         "library_ms": k8["library_ms"],
         "library": "backward of scaled_dot_product_attention through autograd, then dx and "
                    "dW as two cuBLAS GEMMs",
         "products": {"ms": k8["products_ms"], "plain_ms": k8["products_plain_ms"],
                      "bound_ms": k8["products_bound"]["ms"],
                      "bound_by": k8["products_bound"]["by"],
                      "library_ms": k8["products_library_ms"],
                      "library": "dx and dW as two cuBLAS GEMMs on the same dqkv",
                      "dW_norm_err": k8["products"]["dW_norm_err"],
                      "dx_ulps": k8["products"]["dx_ulps"]},
         "unfused_ms": k8["unfused_ms"], "run_to_run_max_abs": k8["run_to_run_max_abs"],
         "shape": "B=8 N=513 K=16 D=64 H=1024 bfloat16 (live ModelCross training shape)"}]})
    print(f"# total {time.perf_counter() - t_start:.1f} s", file=sys.stderr)
    print(device["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


# the worker processes of the phases over gloo ranks sharing the card
WORKERS = {"--dp-worker": dp_worker, "--moe-worker": moe_worker, "--split-worker": split_worker,
           "--tp-ep-worker": tp_ep_worker, "--bn-worker": bn_worker}

if __name__ == "__main__":
    if sys.argv[1:2] and sys.argv[1] in WORKERS:     # rank world port tmp
        sys.exit(WORKERS[sys.argv[1]](int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]),
                                      Path(sys.argv[5])))
    sys.exit(main())
