"""Smoke run of the PyTorch port (fusiondepth_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card, the CUDA toolkit (nvcc) and PyTorch; not JAX. In
order, it:

1. refuses to run without a card (exit code 1, no result printed);
2. turns TF32 off for the plain PyTorch comparisons;
3. builds the port's kernels from fusiondepth_torch/kernels/csrc;
4. inference: holds the forward kernels against their plain versions on
   the inputs the depth path gives them (ResNet-18 at 640x192, batch 1,
   weights and BatchNorm statistics made from a seed), then drives
   Infer.run_split over 8 synthetic frames at batch 1 and
   predict_disparities with the flip post-process at batch 4, both loading
   those weights as a checkpoint, with the launch counts set to 0 before
   each and read after; checks the cached files and disparities, that every
   forward kernel ran, and the forward against the all-plain one;
5. training (ResNet-18, 640x192, fp32): holds every kernel, forward and
   backward, against its plain version on the inputs a batch-2 and a
   batch-12 train step record and on the edge cases of `edge_calls`
   (ties, NaN, odd and ragged sizes, border and far-out warp coordinates,
   warps of W odd, W = 1, 2, 3 with H = 1 and inputs not 8-byte
   aligned),
   a positive BN shift; for the fused reprojection loss H no multiple of
   16, W = 2, H = 2, warped == target): the pools exactly, the warp at
   atol 1e-5, the convs and dgrad at atol and rtol 1e-4, wgrad to 1e-3 of
   the plain result's largest magnitude, the reprojection loss map at
   atol 1e-5 and its warped cotangent at atol and rtol 1e-4; the backward
   kernels on the batch-12 step's calls also with unit-scale cotangents
   (`unit_cotangents`: a step's own are too small for the absolute
   terms to fail); checks a whole batch-2 step through the kernels
   against all-plain with the same weights and noise: the loss within
   1e-5, and every gradient leaf against a float64 all-plain step
   (`hold_step`); then drives
   Trainer.run_epoch over 36 synthetic frames (3 steps at batch 12) with
   the counts set to 0 before and read after, requires every kernel to
   have run and finite losses, saves a checkpoint and reloads it in Infer;
6. offline GDC (path B): writes a synthetic KITTI drive at the native
   375 x 1242 with numpy only (calib, velodyne and 4-beam bins), caches
   inf_depth disparities with Infer.run_split, holds the KNN kernel
   against its plain version on a frame's cloud and on a GDC-sized cloud
   with duplicates, a grid and sentinels (sorted neighbour distances
   within 1e-6 relative), requires the kernel and plain KNN to give the
   frame the same neighbour graph and GDC through either to agree bit for
   bit, holds and times the KNN kernel on the cloud of a frame at
   capacities that hold the whole frame (N = 77824; the default ones drop
   about half of its pseudo-LiDAR points), then drives run_inf_gdc over 3
   frames at the default capacities (N = 40960);
7. the refiner (path B, BASELINE config 4: ResNet-18, 640x192, batch 4):
   holds the kernels on the calls of a batch-4 refine step (the backward
   ones also with unit-scale cotangents, as in 5), a whole
   batch-2 refine step through the kernels against all-plain (loss within
   1e-5, each refine2d gradient leaf against a float64 step as in 5),
   drives Refiner.run_epoch over 12 frames carrying inf_gdc (3 steps at
   batch 4) requiring every kernel of the step, times the warp calls of
   the batch-4 step (`timing_call` lines), saves and reloads the refine
   checkpoint, and runs evaluate with refine_2d and with refine_2d and
   eval_gdc over the drive's frames; then the refiner with
   train_entire_net (the stage-1 nets train with the refine decoder, their
   BatchNorm in eval mode, so every training kernel runs): the kernels on
   the calls of a batch-4 step (the backward ones also with unit-scale
   cotangents), a whole batch-2 step against all-plain and float64 with
   every stage-1 leaf, Refiner.run_epoch (3 steps at batch 4) with every
   training kernel launched and the stage-1 BN statistics unchanged, each
   kernel's calls of the batch-4 step and the step timed; then one refine
   step with the stage-1 variants of REFINE_VARIANT (posecnn + use_stereo
   + predictive_mask), its kernel calls held and every refine kernel
   launched;
7b. the sparse-3D refiner (`refine3d_phase`: Refiner3D over the frozen
   ResNet-18 stage 1 at 640x192, batch 4, each voxel net of the selectors
   at the JAX defaults, 0.5 m voxels and 16384 a sample; the seeded stage
   1's disparity head shifted so that its depths span ~2-31 m,
   REFINE3D_DISP_SHIFT): holds the forward kernels on the calls of a
   batch-4 step and times them; holds the voxel tables of one stage-1
   depth built on the card against the CPU's (from the same float32
   points and from the same float64 depth: every integer array equal, the
   features within REFINE3D_FEAT_RTOL; the U-Net's pyramid too), and of
   the same frame at REFINE3D_OVERFLOW_SHIFT, past the capacity; for each
   net a whole batch-2 step through the kernels against all-plain and
   float64 (`hold_step`: the loss and every voxel-net leaf, the BN
   running statistics included), all on the kernel step's voxel tables
   (`fixed_voxel_tables`), then Refiner3D.train() over 12 frames
   (3 steps at batch 4) with the counts set to 0 before and read after
   (every forward kernel launched, every voxel-net leaf moved, stage 1
   unchanged), a step and `infer` (refined disparities in [1e-4, 1]);
   times the U-Net's batch-4 step against all-plain, with its peak memory
   and the frame's unique voxels against the capacity;
8. completion (BASELINE config 5: ResNet-50 depth and beam encoders,
   ResNet-18 pose encoders, 352 x 1216, batch 4, fp32): holds every
   stage-1 kernel on the calls of a batch-4 completion step at the
   tolerances of 5 (the backward ones also with unit-scale cotangents),
   a whole batch-2 completion step through the kernels against all-plain
   and float64 as in 5, drives Completor.run_step over 12 synthetic
   frames (3 steps at batch 4) with the counts set to 0 before and read
   after (every kernel must have run, the losses be
   finite; the peak memory is printed), runs Completor.validate on 3
   frames carrying depth_gt (finite rmse, mae, irmse, imae; the
   best_completion checkpoint saved, then reloaded into a new Completor
   that must predict the same depths), and times each kernel's calls of
   the batch-4 step and the step through the kernels against all-plain;
   then remat: a batch-4 step with remat against one without from the same
   weights and noise (the loss within 1e-5, each gradient leaf within
   1e-3 relative L2, the BN statistics after it equal),
   Completor.run_step with remat over 3 steps with every kernel launched,
   and the peak memory and time of a step with and without remat; then one
   batch-2 completion step with the stage-1 variants of COMPLETION_VARIANT
   (v1_multiscale + predictive_mask + pose_model_input="all"), its kernel
   calls held and every kernel launched;
9. the stage-1 training variants (ResNet-18, 640x192, fp32, `VARIANTS`):
   A (v1_multiscale + use_stereo + posecnn, automask on) and B (shared
   + use_stereo + predictive_mask + disable_automasking) each hold every
   kernel on the calls of a batch-2 and a batch-12 step at the
   tolerances of 5 (the backward ones also with unit-scale cotangents),
   a whole batch-2 step against all-plain and float64 as in 5, drive
   Trainer.run_epoch over 36 frames (3 steps at batch 12) with the counts
   set to 0 before and read after (every training kernel must have run),
   and time each kernel's calls of the batch-12 step and the step against
   all-plain; C (pose_model_input="all") drives the run_epoch only; then
   evaluate over the GDC drive's frames through the forward kernels with
   visualize and per_semantic (over mask PNGs written here), and with
   eval_split="benchmark", checking the files each writes;
10. bfloat16 (compute_dtype="bfloat16", `bf16_phase`): serving (ResNet-18,
   640x192, seeded weights loaded as a checkpoint) holds the bf16 forward
   kernels on the calls of a batch-1 forward, drives Infer.run_split at
   batch 1 and predict_disparities with the flip at batch 4 (counts set
   to 0 before each, every bf16 forward kernel launched, float32 files
   and disparities), holds the batch-4 forward through the kernels against
   all-plain (FORWARD_ATOL_BF16) and times it at batch 1 and 4; training
   (BASELINE config 3 in bf16) holds every bf16 kernel on the calls of a
   batch-2 step, the whole batch-2 step against all-plain and float64
   (`hold_step` with the bf16 bounds: STEP_LOSS_REL_BF16, no cap, the
   noise from `nudged_bf16` steps), drives Trainer.run_epoch (3 steps at
   batch 12; every bf16 training kernel launched, the parameters, BN
   statistics and Adam state float32), holds the calls of a batch-12
   step (also with unit cotangents), times them and the step against
   all-plain, with its peak memory; each bf16 kernel may differ from its
   plain version by one bf16 spacing (BF16_ROUND) beyond its float32
   tolerance, the pools not at all;
11. data parallelism (`ddp_phase`, BASELINE config 3 over ranks): a gloo
   world of 2 ranks on the one card (NCCL refuses two ranks on one card)
   runs one Trainer step (use_mesh) on 6 rows each of a batch-12 global
   batch through every training kernel, fp32 then bf16
   (`multichip.step_rank` in spawned processes; each rank's launches
   counted around its step, every kernel required on every rank, the
   ranks' parameters equal after it; a rank that fails fails the run),
   each held against the single-process batch-12 step through the
   kernels on the same weights and noise (the loss within STEP_LOSS_REL,
   or STEP_LOSS_REL_BF16; each gradient leaf against a float64 step
   within STEP_NOISE_X times one process's noise, capped at STEP_GRAD_CAP
   in fp32; the parameters equal to Adam's step from that gradient; the
   BN statistics within STEP_GRAD_REL, or BF16_ROUND) and
   timed with its gradient all-reduce; then an NCCL world of one brought
   up as the trainer CLI does drives Trainer(use_mesh=True).run_epoch
   (3 steps at batch 12, every kernel launched) and times a step;
12. times each kernel against its plain version (and one PyTorch call that
   computes the same function, where there is one; for the KNN, chunked
   cdist + topk, two calls) over the calls of a batch-12 train step (the
   KNN: one GDC frame; one line per call as well), the steps through the
   kernels against all-plain, and the inference forward, with CUDA events
   after warm-up, each pair in the order plain, kernel, kernel, plain;
   checks that two wgrad launches on a batch-12 layer1 call are
   bit-equal;
13. prints the card's name and power limit (nvidia-smi), then one JSON
   line {"kernels": [...]} of the 11 kernels and the 10 bf16 entry points
   (those of the bf16 train step, bound at the bf16 tensor-core rate for
   the convs, PEAK_BF16_S; the forward ones also with their serving
   launches), each with the launches of
   the path that drives it and its bound (the conv rows at the 3xTF32
   rate, see PEAK_TF32_S, with their achieved TFLOP/s), and for the ten
   of the completion step a "completion" entry with that path's launches,
   times and bound, a "refine_entire" entry with the train_entire_net
   step's, a "completion_remat" entry with the remat run's launches, and
   for the ten training kernels a "variants" entry
   (A and B: launches, times and bound; C: launches) and a "ddp" entry
   (each rank's launches in the two-rank world, and the NCCL world of
   one's; the bf16 entry points: the bf16 two-rank world's), then, last,
   {"ok": true, "device": {...}}; the three forward kernels also carry a
   "refine3d" entry (each net's train() launches, and the batch-4 step's
   calls timed). After the build it prints what ptxas
   reported for the conv kernels, the pool backward, the warp forward and
   backward, the reprojection-loss forward and backward and
   the KNN kernels (registers, spills; PTXAS_KERNELS).

Any failed check raises, so the exit code is not 0.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from fusiondepth_torch import multichip

from fusiondepth_torch.config import Config
from fusiondepth_torch.data.calibration import Calibration
from fusiondepth_torch.data.fixtures import DRIVE, build_synthetic_kitti_tree
from fusiondepth_torch.data.kitti_io import generate_depth_map
from fusiondepth_torch.data.loader import DataLoader, collate
from fusiondepth_torch.data.prefetch import prefetch_to_device
from fusiondepth_torch.data.synthetic import SyntheticDataset
from fusiondepth_torch.kernels import BF16_KERNELS, LAUNCHES, all_plain, \
    build, conv3x3, pool, reset_launches, wrappers
from fusiondepth_torch.kernels import knn as knn_kernel
from fusiondepth_torch.models.depth_decoder import ConvBlock
from fusiondepth_torch.models.fusion import FusionNets, model_dtype
from fusiondepth_torch.models.norm import BatchNorm
from fusiondepth_torch.ops.depth import disp_to_depth
from fusiondepth_torch.ops.geometry import backproject_depth
from fusiondepth_torch.training import checkpoint as ckpt
from fusiondepth_torch.training.completor import Completor, completion_loss
from fusiondepth_torch.training.eval_driver import evaluate, \
    predict_disparities
from fusiondepth_torch.training.gdc_driver import gdc_one_frame, run_inf_gdc
from fusiondepth_torch.training.infer_driver import Infer, device_batch
from fusiondepth_torch.training.refiner import refine_loss
from fusiondepth_torch.training.refiner_driver import Refiner
from fusiondepth_torch.training import refiner3d
from fusiondepth_torch.models import refine_net3d
from fusiondepth_torch.parallel import maybe_initialize_distributed
from fusiondepth_torch.training.train_state import loss_fn, make_optimizer, \
    train_step
from fusiondepth_torch.training.trainer import TRAIN_KEYS, Trainer

HEIGHT, WIDTH, FRAMES = 192, 640, 8
TRAIN_BATCH, TRAIN_FRAMES, CHECK_BATCH = 12, 36, 2
CONV_TOL = dict(atol=1e-4, rtol=1e-4)
WARP_ATOL = 1e-5
WGRAD_REL = 1e-3
FORWARD_ATOL = 1e-4
# whole batch-2 step: the loss through the kernels within 1e-5 of
# all-plain; each gradient leaf's relative L2 distance to a float64
# all-plain step within 1e-3, or within 3x the leaf's float32 noise (the
# largest distance to float64 of 1 + NOISE_STEPS all-plain float32 steps)
# but never beyond 0.1. The pose encoders' gradients are sums over every
# pixel that nearly cancel: in fp32 the plain path itself is a few percent
# off float64 there, on the CPU as on the card, and one plain step alone
# would measure that noise too low one time in five. The decoders' conv
# gradients cancel as well (a refine head's bias to a few percent of its
# summands), so their distance is taken relative to the summed magnitudes
# of the products they sum (`summand_scales`), the scale of the error a
# float32 sum of them may have.
STEP_LOSS_REL, STEP_GRAD_REL, STEP_NOISE_X = 1e-5, 1e-3, 3.0
STEP_GRAD_CAP = 0.1
NOISE_STEPS = 3
# bfloat16 (compute_dtype="bfloat16", step 10). BF16_U = 2^-8 is bf16's
# unit roundoff. A bf16 kernel and its plain version compute in float32
# from the same bf16 inputs and round once at the output, so two float32
# results a few float32 ulps apart can land on neighbouring bf16 values:
# BF16_ROUND = 2 BF16_U of the value (one bf16 spacing) is added to the
# kernel's float32 tolerance. The pools stay exact (a max is a max; the
# tie split is summed in the plain version's order).
BF16_U = 2.0 ** -8
BF16_ROUND = 2 * BF16_U
# the bf16 forward through the kernels against all-plain: the disparities
# lie in (0, 1), where one bf16 spacing is at most 2 BF16_U; kernels and
# plain versions may round apart in each of the ~20 layers before a
# disparity, so up to 4 spacings
FORWARD_ATOL_BF16 = 8 * BF16_U
# the whole batch-2 bf16 step through the kernels against all-plain: the
# loss, a mean of bf16 maps whose inputs differ by such roundings, within
# one bf16 spacing; each gradient leaf against a float64 step within
# STEP_NOISE_X times its bf16 noise (the largest distance to float64 of
# 1 + NOISE_STEPS all-plain bf16 steps: the batch and `nudged_bf16`
# batches), with no cap (STEP_GRAD_CAP_BF16 None): bf16 puts most leaves
# beyond STEP_GRAD_CAP's 0.1 even all-plain, the encoders' and the pose
# decoder's up to and past their own size (the bf16 geometry leaves the
# photometric cotangent of a disparity ~100% off float32 pixel by pixel,
# tests/test_torch_port_bf16.py, PERF.md section 6), so there the step
# cannot tell a fault from bf16 itself; the per-call checks hold the
# kernels, and the leaves near the loss (noise of a few %) hold the step.
STEP_LOSS_REL_BF16 = BF16_ROUND
STEP_GRAD_CAP_BF16 = None
# published H100 SXM peaks (NVIDIA data sheet): HBM rate, fp32 CUDA cores,
# dense TF32 and bf16 tensor cores
PEAK_BYTES_S, PEAK_FP32_S, PEAK_TF32_S = 3.35e12, 67e12, 495e12
PEAK_BF16_S = 989e12
# The conv rows' operation bound: an fp32-accurate conv on this card takes
# at least 3 TF32 products per multiply-add on the tensor cores (3xTF32:
# each operand split into two TF32 parts, the small x small product
# dropped), so 3 x operations / PEAK_TF32_S, 165 TFLOP/s of fp32-accurate
# products; that is below the CUDA cores' 1 x operations / PEAK_FP32_S and
# so the least time whatever implements it. The other rows keep the fp32
# rate. A bf16 conv's products are exact in one bf16 (or TF32) tensor-core
# pass, so its rows take operations over PEAK_BF16_S.
CONV_KERNELS = ("conv3x3_reflect", "conv3x3_zero_act", "conv3x3_dgrad",
                "conv3x3_wgrad")

PALLAS = "fusiondepth_tpu/ops/"
SRC = "fusiondepth_torch/kernels/csrc/"
# kernel -> (wrapper module, wrapper, plain version, source, TPU kernel):
# `fusiondepth_torch.kernels.wrappers` with each kernel's source and the
# TPU kernel it replaces
SOURCES = {
    "maxpool3x3s2": ("maxpool3x3s2.cu", PALLAS + "pallas_pool.py:186"),
    "maxpool3x3s2_bwd": ("maxpool3x3s2.cu", PALLAS + "pallas_pool.py:208"),
    "conv3x3_reflect": ("conv3x3.cu", PALLAS + "pallas_fold_conv.py:370"),
    "conv3x3_zero_act": ("conv3x3.cu", PALLAS + "pallas_fold_conv.py:370"),
    "conv3x3_dgrad": ("conv3x3.cu", PALLAS + "pallas_fold_conv.py:370 "
                      "(_bwd :511, _zbwd :615)"),
    "conv3x3_wgrad": ("conv3x3.cu", PALLAS + "pallas_fold_conv.py:466"),
    "warp": ("warp.cu", PALLAS + "pallas_warp.py:421"),
    "warp_bwd": ("warp.cu", PALLAS + "pallas_warp.py:443"),
    "reproj": ("reproj.cu", PALLAS + "pallas_reproj.py:219"),
    "reproj_bwd": ("reproj.cu", PALLAS + "pallas_reproj.py:240"),
    "knn": ("knn.cu", "fusiondepth_tpu/gdc/pallas_knn.py:106"),
}
KERNELS = {name: (*wrappers()[name], SRC + src, tpu)
           for name, (src, tpu) in SOURCES.items()}
# the bfloat16 entry points (kernels.BF16_KERNELS): the same wrappers and
# plain versions, counted under "<kernel>_bf16"
KERNELS.update({BF16_KERNELS[name]: KERNELS[name] for name in BF16_KERNELS})
# source -> the kernels whose registers and spills the ptxas line gives
# (mangled-name fragments: the KNN at k = 10 and the reprojection forward at
# C = 3, as GDC and the train step launch them)
PTXAS_KERNELS = {"conv3x3.cu": ("conv3x3_fwd_kernel", "conv3x3_wgrad_kernel"),
                 "maxpool3x3s2.cu": ("maxpool3x3s2_bwd_kernel",),
                 "warp.cu": ("warp_fwd_kernel", "warp_bwd_kernel"),
                 "reproj.cu": ("reproj_bwd_kernel", "reproj_fwd_kernelIfLi3E",
                               "reproj_fwd_kernelI13__nv_bfloat16Li3E"),
                 "knn.cu": ("knn_partial_kernelILi10E",
                            "knn_merge_kernelILi10E")}
FORWARD_KERNELS = ("maxpool3x3s2", "conv3x3_reflect", "conv3x3_zero_act")
# the kernels of the stage-1 train step
TRAIN_KERNELS = FORWARD_KERNELS + ("maxpool3x3s2_bwd", "conv3x3_dgrad",
                                   "conv3x3_wgrad", "warp", "warp_bwd",
                                   "reproj", "reproj_bwd")
# the refine step: the frozen stage-1 forward, the refine decoder's
# forward and backward, the warp and the fused reprojection loss; no pool
# backward (stage 1 is frozen)
REFINE_KERNELS = FORWARD_KERNELS + ("conv3x3_dgrad", "conv3x3_wgrad", "warp",
                                    "warp_bwd", "reproj", "reproj_bwd")
# the refiner with train_entire_net: stage 1 takes gradients, so the step
# runs every training kernel (the pool backward and the stage-1 dgrad and
# wgrad calls are new there)
REFINE_ENTIRE_KERNELS = TRAIN_KERNELS
# the stage-1 variant combinations the completor and the refiner are
# driven with at full width (each is one the JAX driver traces)
COMPLETION_VARIANT = dict(v1_multiscale=True, predictive_mask=True,
                          disable_automasking=True, pose_model_input="all")
REFINE_VARIANT = dict(pose_model_type="posecnn", use_stereo=True,
                      frame_ids=(0, -1, 1, "s"), predictive_mask=True,
                      disable_automasking=True)
# the bf16 train step's kernels (step 10): every training kernel's bf16
# entry point
BF16_TRAIN_KERNELS = tuple(BF16_KERNELS[k] for k in TRAIN_KERNELS)
BF16_FORWARD_KERNELS = tuple(BF16_KERNELS[k] for k in FORWARD_KERNELS)
# the kernel line's launches: the path each kernel is driven by
KERNEL_PATH = {**{k: "train" for k in TRAIN_KERNELS}, "knn": "inf_gdc",
               **{k: "train_bf16" for k in BF16_TRAIN_KERNELS}}
REPROJ_ATOL = 1e-5
REPROJ_BWD_TOL = dict(atol=1e-4, rtol=1e-4)
# sorted neighbour distances (metres) of the KNN kernel and its plain
# version; rows whose indices differ may only permute near-ties
KNN_DIST_RTOL = 1e-6
# stage 2 (BASELINE config 4): refine steps at batch 4, GDC at KITTI's
# native size with the default capacities
REFINE_BATCH, REFINE_FRAMES, GDC_FRAMES = 4, 12, 3
# the sparse-3D refiner (step 7b): each voxel net at the JAX defaults
# (voxel 0.5 m, 16384 voxels a sample) over the frozen stage 1, whose
# only kernels are the forward ones. The seeded stage 1 predicts depths
# of 0.1-0.6 m (a handful of voxels); its disparity head's bias moved by
# REFINE3D_DISP_SHIFT puts them at ~2-31 m (median ~8.7), ~10.7k unique
# voxels a frame, below the capacity. (At -5, ~3.5-42 m, a frame has
# ~25k voxels, and the overflow merges a third of its pixels into the
# last slot: REFINE3D_OVERFLOW_SHIFT.)
REFINE3D_NETS = ("refine_shallow", "refine_deep", "refineUnet")
REFINE3D_VOXEL, REFINE3D_CAPACITY = 0.5, 16384
REFINE3D_KERNELS = FORWARD_KERNELS
REFINE3D_DISP_SHIFT = -4.5
# the shift at which a frame overflows the capacity (`hold_voxel_tables`
# builds that frame's tables on the card and on the CPU)
REFINE3D_OVERFLOW_SHIFT = -5.0
# the voxel features built on the card against the CPU's from the same
# points: each voxel's sum runs over its points in the same order on both
# (`refine_net3d.segment_sum`), so they may differ only by the float32
# rounding of the back-projection, which the same points rule out
REFINE3D_FEAT_RTOL = 1e-6
NATIVE = (375, 1242)
# GDC's capacities (cap_pl, cap_l): the defaults, which the JAX package sets
# and a frame of the synthetic drive overflows (about 67.1k-67.7k
# pseudo-LiDAR points), and capacities that hold a whole frame, with which
# the KNN is also held and timed (N = 77824)
GDC_CAPS, WHOLE_FRAME_CAPS = (32768, 8192), (69632, 8192)
# completion (BASELINE config 5): R50 depth and beam encoders, R18 pose
# encoders, 352 x 1216; steps at batch 4, validation frames with depth_gt
COMPLETION_HW = (352, 1216)
COMPLETION_BATCH, COMPLETION_FRAMES, COMPLETION_VAL = 4, 12, 3
# the completion step's kernels: every stage-1 kernel (the KNN is GDC's)
COMPLETION_KERNELS = TRAIN_KERNELS
# the stage-1 training variants (ResNet-18, 640x192, fp32): A and B are
# held and timed like the train step and driven through Trainer.run_epoch,
# C is driven only (its kernel calls have the default step's shapes; its
# pose encoder's 9-channel stem is cuDNN's)
VARIANTS = {
    "A": dict(v1_multiscale=True, use_stereo=True,
              pose_model_type="posecnn", frame_ids=(0, -1, 1, "s")),
    "B": dict(pose_model_type="shared", use_stereo=True,
              predictive_mask=True, disable_automasking=True,
              frame_ids=(0, -1, 1, "s")),
    "C": dict(pose_model_input="all"),
}
HELD_VARIANTS = ("A", "B")
# data parallelism (step 11): a gloo world of 2 ranks on the one card, 6
# rows of the batch-12 global batch each; timed over 3 more steps
DDP_WORLD, DDP_TIME_STEPS = 2, 3


def emit(**kw):
    print(json.dumps(kw), flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


class SmokeFrames:
    """Synthetic frames with the parse_line of a KITTI split."""

    def __init__(self, cfg: Config, n: int):
        self.inner = SyntheticDataset(cfg, length=n, seed=0)

    def __len__(self):
        return len(self.inner)

    def __getitem__(self, i):
        return self.inner[i]

    def parse_line(self, i):
        return "2011_09_26/2011_09_26_drive_0001_sync", i, "l"


def seeded_weights(cfg: Config, seed: int = 0,
                   pose_depth: int = None) -> FusionNets:
    """The model's own seeded init, with every BatchNorm's scale, shift and
    running statistics and every conv bias drawn from the seed as well, so
    that no affine is the identity (the fused encoder conv's border
    handling is only visible with a non-zero shift)."""
    nets = FusionNets(cfg, device="cpu",
                      generator=torch.Generator().manual_seed(seed),
                      pose_depth=pose_depth)
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for m in nets.modules():
            if isinstance(m, BatchNorm):
                n = m.weight.shape[0]
                m.weight.copy_(0.5 + torch.rand(n, generator=g))
                m.bias.copy_(0.1 * torch.randn(n, generator=g))
                m.running_mean.copy_(0.1 * torch.randn(n, generator=g))
                m.running_var.copy_(0.5 + torch.rand(n, generator=g))
            elif isinstance(m, torch.nn.Conv2d) and m.bias is not None:
                m.bias.copy_(0.1 * torch.randn(m.bias.shape, generator=g))
    return nets


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call on the current stream."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def paired_ms(kernel_fn, plain_fn, **kw):
    """(kernel ms, plain ms), timed in the order plain, kernel, kernel,
    plain so that drift on the card falls on both alike."""
    p1 = cuda_ms(plain_fn, **kw)
    k1 = cuda_ms(kernel_fn, **kw)
    k2 = cuda_ms(kernel_fn, **kw)
    p2 = cuda_ms(plain_fn, **kw)
    return (k1 + k2) / 2, (p1 + p2) / 2


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def edge_calls(dev):
    """Inputs the main path does not give the kernels: tied, all-zero and
    NaN pool windows, odd pool sizes; convs with ragged tiles, channel
    counts that are no multiple of the kernels' channel tiles, a 2-channel
    second input (cat2end), 2x2 and 1x1 maps, and a positive BN shift,
    whose relu must not leak into the zero pad; warp coordinates exactly
    on the image border and displacements far beyond +-128 px, on a ragged
    H x W, single-row warps of W = 1, 2, 3, every coordinate on the last
    column and row, and inputs that are views at an odd float offset into
    a larger buffer (contiguous, not 8-byte aligned); and those of
    `reproj_edge_calls`."""
    g = torch.Generator(device=dev).manual_seed(1)

    def randn(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=g, device=dev)

    tied = torch.randint(0, 3, (1, 64, HEIGHT // 2, WIDTH // 2),
                         generator=g, device=dev).float()
    relu = torch.relu(randn(2, 16, 24, 40))  # all-zero windows
    nan = randn(2, 3, 10, 10)
    nan[0, 1, 4, 4] = float("nan")
    calls = [("maxpool3x3s2", [x], {}) for x in
             (tied, nan, randn(2, 3, 7, 10), randn(1, 5, 1, 3))]
    for x in (tied, relu, nan):
        y = pool.maxpool3x3s2_plain(x)
        calls.append(("maxpool3x3s2_bwd", [x, y, randn(*y.shape)], {}))
    for B, C0, C1, Co, H, W, elu in ((2, 13, 2, 5, 11, 37, True),
                                     (1, 16, 0, 1, 2, 2, False),
                                     (2, 5, 3, 4, 2, 2, True),
                                     (2, 24, 9, 20, 90, 300, True)):
        x0 = randn(B, C0, H, W)
        x1 = randn(B, C1, H, W) if C1 else None
        w = randn(Co, C0 + C1, 3, 3, scale=0.2)
        gy = randn(B, Co, H, W)
        calls += [("conv3x3_reflect", [x0, w, randn(Co, scale=0.1), x1, elu],
                   {}),
                  ("conv3x3_dgrad", [gy, w, C0], {"reflect": True}),
                  ("conv3x3_wgrad", [gy, x0, x1], {"reflect": True})]
    for B, C, Co, H, W in ((2, 13, 7, 9, 33), (1, 4, 3, 1, 1),
                           (2, 20, 24, 2, 2),
                           (1, 64, 64, HEIGHT // 4, WIDTH // 4)):
        x, w = randn(B, C, H, W), randn(Co, C, 3, 3, scale=C ** -0.5 / 3)
        s = 0.5 + torch.rand(C, generator=g, device=dev)
        t = 0.2 + torch.rand(C, generator=g, device=dev)
        gy = randn(B, Co, H, W)
        calls += [("conv3x3_zero_act", [x, w], {}),
                  ("conv3x3_zero_act", [x, w, s, t], {}),
                  ("conv3x3_dgrad", [gy, w, C], {"reflect": False}),
                  ("conv3x3_wgrad", [gy, x, None],
                   {"reflect": False}),
                  ("conv3x3_wgrad", [gy, x, None],
                   {"reflect": False, "scale": s, "shift": t})]
    n, k, B, C, H, W = 2, 2, 2, 3, 37, 53
    jj = torch.arange(W, device=dev).float()
    ii = torch.arange(H, device=dev).float()[:, None]
    ix = (jj + 300 * randn(n, k, B, H, W)).clamp(0, W - 1)
    iy = (ii + 100 * randn(n, k, B, H, W)).clamp(0, H - 1)
    ix[0, 0, 0, :, :4] = 0.0
    ix[0, 0, 0, :, -4:] = W - 1.0
    iy[1, 1, 1, :3] = 0.0
    iy[1, 1, 1, -3:] = H - 1.0
    src = torch.rand((n, B, C, H, W), generator=g, device=dev)
    warps = [(ix, iy, src)]
    for W in (1, 2, 3):  # H = 1: one row
        ix = (torch.arange(W, device=dev) + 2 * randn(n, k, B, 1, W)).clamp(
            0, W - 1)
        warps.append((ix, torch.zeros_like(ix),
                      torch.rand((n, B, C, 1, W), generator=g, device=dev)))
    H, W = 9, 26
    last = torch.ones((n, k, B, H, W), device=dev)
    warps.append((last * (W - 1), last * (H - 1),
                  torch.rand((n, B, C, H, W), generator=g, device=dev)))

    def odd_view(t):  # contiguous, one float past an aligned start
        buf = torch.empty(t.numel() + 1, device=dev)
        buf[1:] = t.flatten()
        return buf[1:].view(t.shape)

    H, W = 12, 40
    ix = (torch.arange(W, device=dev) + 3 * randn(n, k, B, H, W)).clamp(
        0, W - 1)
    iy = (torch.arange(H, device=dev)[:, None] + 3 * randn(n, k, B, H, W)
          ).clamp(0, H - 1)
    warps.append(tuple(map(odd_view, (
        ix, iy, torch.rand((n, B, C, H, W), generator=g, device=dev)))))
    for ix, iy, src in warps:
        gw = randn(*ix.shape[:3], C, *ix.shape[3:])
        if ix.data_ptr() % 8:
            gw = odd_view(gw)
        calls += [("warp", [ix, iy, src], {}),
                  ("warp_bwd", [ix, iy, src, gw], {})]
    return calls + reproj_edge_calls(dev)


def _tensors(out):
    return [t for t in (out if isinstance(out, tuple) else (out,))
            if t is not None]


def knn_error(points, got, want):
    """(max abs and max relative difference of the sorted neighbour
    distances, rows whose indices differ) of two (N, k) neighbour lists of
    `points`, over the rows of real points (the far sentinels' rows are
    arbitrary by design and masked by GDC)."""
    real = points.abs().amax(1) < 1e7
    p = points.double()

    def dists(idx):
        return torch.sort((p[:, None] - p[idx.long()]).norm(dim=-1), 1)[0]

    dg, dw = dists(got)[real], dists(want)[real]
    diff = (dg - dw).abs()
    rows = int(((got != want).any(1) & real).sum())
    return (diff.max().item(), (diff / dw.clamp_min(1e-12)).max().item(),
            rows)


def base_name(name: str) -> str:
    """The kernel of a launch-count name: "<kernel>_bf16" -> "<kernel>"."""
    return name[:-5] if name.endswith("_bf16") else name


def check_kernels(calls):
    """Each call through its kernel and its plain version; returns
    {kernel: max abs error}. The pools must agree bit for bit (NaN where
    the plain version has NaN), the warp within WARP_ATOL, the convs and
    dgrad within CONV_TOL, wgrad within WGRAD_REL of the plain result's
    largest magnitude, the reprojection loss map within REPROJ_ATOL and
    its warped cotangent within REPROJ_BWD_TOL, the KNN's sorted
    neighbour distances within KNN_DIST_RTOL (so that rows whose indices
    differ only permute near-ties). A bf16 entry's output may also be one
    bf16 spacing (BF16_ROUND of it) off: the warp's and the maps' within
    that plus their atol, the convs', dgrad's and the warped cotangent's
    with rtol + BF16_ROUND, wgrad's per element within BF16_ROUND of it
    plus WGRAD_REL of the largest; the warp's coordinate gradient is
    float32 and keeps WARP_ATOL."""
    err = {}
    for name, args, kwargs in calls:
        mod, attr, plain, _, _ = KERNELS[name]
        got = _tensors(getattr(mod, attr)(*args, **kwargs))
        want = _tensors(plain(*args, **kwargs))
        torch.cuda.synchronize()
        shapes = [tuple(a.shape) for a in args if torch.is_tensor(a)]
        require(len(got) == len(want), f"{name}: outputs differ")
        if name == "knn":
            e, rel, rows = knn_error(args[0], got[0], want[0])
            err[name] = max(err.get(name, 0.0), e)
            emit(check="knn_call", points=shapes[0][0], k=args[1],
                 max_abs_dist_err=e, max_rel_dist_err=rel,
                 rows_with_other_indices=rows, tol=KNN_DIST_RTOL)
            require(rel <= KNN_DIST_RTOL, f"knn differs at {shapes}: sorted "
                    f"distances {rel} apart, {rows} rows")
            continue
        for a, b in zip(got, want):
            require(a.dtype == b.dtype, f"{name}: {a.dtype} against "
                    f"{b.dtype}")
            e = (a - b).nan_to_num().abs().max().item()
            err[name] = max(err.get(name, 0.0), e)
            kind = base_name(name)
            if a.dtype == torch.bfloat16:
                a, b = a.float(), b.float()
                d = (a - b).abs()
                rnd = BF16_ROUND * b.abs()
                if kind.startswith("maxpool"):
                    ok = torch.equal(a.isnan(), b.isnan()) and torch.equal(
                        a.nan_to_num(), b.nan_to_num())
                elif kind == "warp":
                    ok = bool((d <= rnd + WARP_ATOL).all())
                elif kind == "conv3x3_wgrad":
                    ok = bool((d <= rnd + WGRAD_REL * b.abs().max()).all())
                elif kind == "reproj":
                    ok = bool((d <= rnd + REPROJ_ATOL).all())
                elif kind == "reproj_bwd":
                    ok = torch.allclose(a, b, rtol=REPROJ_BWD_TOL["rtol"]
                                        + BF16_ROUND,
                                        atol=REPROJ_BWD_TOL["atol"])
                else:
                    ok = torch.allclose(a, b, rtol=CONV_TOL["rtol"]
                                        + BF16_ROUND, atol=CONV_TOL["atol"])
            elif kind.startswith("maxpool"):
                ok = torch.equal(a.isnan(), b.isnan()) and torch.equal(
                    a.nan_to_num(), b.nan_to_num())
            elif kind.startswith("warp"):
                ok = e <= WARP_ATOL
            elif kind == "conv3x3_wgrad":
                ok = e <= WGRAD_REL * b.abs().max().item()
            elif kind == "reproj":
                ok = e <= REPROJ_ATOL
            elif kind == "reproj_bwd":
                ok = torch.allclose(a, b, **REPROJ_BWD_TOL)
            else:
                ok = torch.allclose(a, b, **CONV_TOL)
            require(ok, f"{name} differs at {shapes}: max abs {e}")
    return err


def wgrad_repeats(calls):
    """Two wgrad launches on the first layer1 call of a batch-12 step give
    the same bits: the split partials are summed in a fixed order, with no
    atomics."""
    layer1 = (TRAIN_BATCH, 64, HEIGHT // 4, WIDTH // 4)
    args, kwargs = next((a, k) for n, a, k in calls if n == "conv3x3_wgrad"
                        and tuple(a[1].shape) == layer1)
    first = conv3x3.conv3x3_wgrad(*args, **kwargs)
    same = torch.equal(first, conv3x3.conv3x3_wgrad(*args, **kwargs))
    emit(check="wgrad_bit_equal_repeat", shape=list(layer1),
         act=kwargs.get("scale") is not None, bit_equal=same)
    require(same, "two wgrad launches on one layer1 call differ")


def emit_checks(err, calls, edges, path):
    """One line per kernel held: its largest error, and on how many calls
    of the path and edge cases it was held."""
    for name, e in err.items():
        emit(check=name, path=path,
             calls_per_step=sum(c[0] == name for c in calls),
             edge_cases=sum(c[0] == name for c in edges), max_abs_err=e)


# operations per (pixel, channel) of a warp that the fused reprojection
# loss needs at the least (the target's products and box means are shared
# by the n * k warps and not counted). Forward, 42: the products x^2 and
# xy (2); three separable 3x3 box means, each two vertical adds, two
# horizontal adds and a scale (15); the SSIM algebra, mu_x mu_y, sigma_xy,
# mu_x^2, sigma_x, the factors 2 mu_x mu_y + C1 and 2 sigma_xy + C2 and
# their product, mu_x^2 + mu_y^2 + C1 and sigma_x + sigma_y + C2 and their
# product, the quotient (15); (1 - SSIM) / 2, the clip, the 0.85 (5); the
# L1 term, |x - y| times 0.15 added (4); the channel mean's add (1).
# Backward, 73: the forward's products, box means and SSIM algebra again
# (32); the cotangent a of SSIM, g times -0.85 / 2C inside the clip (2);
# a / d and -a SSIM / d (3); dn/dmu_x = 2 mu_y (n2 - n1) and dd/dmu_x =
# 2 mu_x (d2 - d1) (6); the three moment cotangents (6); their three box
# adjoints (15); 2 x box(G_x2) + y box(G_xy) added to box(G_mu) (5); the
# L1 term's sign times 0.15 g / C, added (4).
REPROJ_OPS, REPROJ_BWD_OPS = 42.0, 73.0


def call_flops(name, args, kwargs) -> float:
    """Operations of one call, counted from its inputs: 2 per multiply-add
    of a conv (9 taps per input channel of each output), 16 per warped
    (pixel, channel) and 26 per backward one, 9 compares per pooled output
    and 36 per backward output, REPROJ_OPS per (pixel, channel) of a warp
    in the reprojection loss and REPROJ_BWD_OPS per backward one, 9 per
    (query, point) pair of the KNN (the squared distance and the
    compare). A bf16 entry does the same operations."""
    name = base_name(name)
    if name == "reproj":
        return REPROJ_OPS * args[0].numel()
    if name == "reproj_bwd":
        return REPROJ_BWD_OPS * args[0].numel()
    if name == "knn":
        return 9.0 * args[0].shape[0] ** 2
    if name in ("conv3x3_reflect", "conv3x3_zero_act"):
        x0, w = args[0], args[1]
        B, _, H, W = x0.shape
        return 2.0 * B * H * W * w.shape[0] * w.shape[1] * 9
    if name == "conv3x3_dgrad":
        g, w = args[0], args[1]
        B, _, H, W = g.shape
        return 2.0 * B * H * W * w.shape[0] * w.shape[1] * 9
    if name == "conv3x3_wgrad":
        g, x0, x1 = args[0], args[1], args[2]
        B, Co, H, W = g.shape
        ci = x0.shape[1] + (0 if x1 is None else x1.shape[1])
        return 2.0 * B * H * W * Co * ci * 9
    if name in ("warp", "warp_bwd"):
        src = args[2]
        return (16.0 if name == "warp" else 26.0) * args[0].numel() * \
            src.shape[2]
    if name == "maxpool3x3s2":
        return 9.0 * args[0].numel() / 4
    return 36.0 * args[1].numel()


def call_bytes(args, kwargs, out) -> float:
    """Each input read once and each output written once."""
    ins = [a for a in list(args) + list(kwargs.values()) if torch.is_tensor(a)]
    return float(sum(t.numel() * t.element_size() for t in ins + out))


def library_call(name, args, kwargs):
    """One PyTorch call that computes the same function as the kernel on
    these inputs, or None where there is none: F.grid_sample (border,
    align_corners=False) and its grid gradient for the warp, F.max_pool2d
    for the pool forward, and the cuDNN convolution and its input and
    weight gradients for the zero-pad convs without the act. None for the
    reflect convs (the pad and the concat are further calls), the act
    convs, and the tie-splitting pool backward. A bf16 call's library call
    takes its bf16 tensors (the warp's coordinates stay float32, as
    F.grid_sample's grid takes the input's dtype: the grid is cast)."""
    name = base_name(name)
    if name in ("warp", "warp_bwd"):
        ix, iy, src = args[:3]
        n, k, B, H, W = ix.shape
        C = src.shape[2]
        inp = src[:, None].expand(n, k, B, C, H, W).reshape(-1, C, H, W)
        grid = torch.stack([(2 * ix + 1) / W - 1, (2 * iy + 1) / H - 1],
                           -1).reshape(-1, H, W, 2).to(src.dtype)
        if name == "warp":
            return lambda: F.grid_sample(inp, grid, padding_mode="border",
                                         align_corners=False)
        go = args[3].reshape(-1, C, H, W)
        return lambda: torch.ops.aten.grid_sampler_2d_backward(
            go, inp, grid, 0, 1, False, [False, True])
    if name == "maxpool3x3s2":
        return lambda: F.max_pool2d(args[0], 3, 2, 1)
    if name == "conv3x3_zero_act" and args[2] is None:
        return lambda: F.conv2d(args[0], args[1], padding=1)
    if name == "conv3x3_dgrad" and not kwargs["reflect"]:
        g, w, C0 = args
        shape = (g.shape[0], w.shape[1], g.shape[2], g.shape[3])
        return lambda: torch.nn.grad.conv2d_input(shape, w, g, padding=1)
    if name == "conv3x3_wgrad" and not kwargs["reflect"] and \
            kwargs.get("scale") is None:
        g, x0 = args[0], args[1]
        wshape = (g.shape[1], x0.shape[1], 3, 3)
        return lambda: torch.nn.grad.conv2d_weight(x0, wshape, g, padding=1)
    return None


def ops_ms(name, args, kwargs) -> float:
    """The least time for a call's operations: 3 TF32 products per
    multiply-add for a float32 conv (see CONV_KERNELS), one bf16 product
    at the bf16 rate for a bf16 conv, fp32 operations at the fp32 rate
    otherwise (the bf16 pool, warp and maps compute in float32 too)."""
    flops = call_flops(name, args, kwargs)
    if name in CONV_KERNELS:
        return 3 * flops / PEAK_TF32_S * 1e3
    if base_name(name) in CONV_KERNELS:
        return flops / PEAK_BF16_S * 1e3
    return flops / PEAK_FP32_S * 1e3


def time_kernels(calls, path, iters=10):
    """Per kernel, summed over its calls: kernel ms, plain ms, the library
    call's ms and the kernel's ms over the calls the library call covers,
    the bound (bytes over the HBM rate or `ops_ms`, the larger, call by
    call), and for the convs the achieved TFLOP/s (call_flops over the
    kernel's ms). Also prints one line per call: its shapes, ms, plain ms
    and bound. A timing takes `iters` launches after 2 to warm up."""
    t = {name: dict(ms=0.0, plain_ms=0.0, library_ms=0.0, library_of_ms=0.0,
                    library_calls=0, calls=0, bound_ms=0.0, bytes_ms=0.0,
                    ops_ms=0.0, flops=0.0) for name in KERNELS}
    for name, args, kwargs in calls:
        mod, attr, plain, _, _ = KERNELS[name]
        fn = getattr(mod, attr)
        k, p = paired_ms(lambda: fn(*args, **kwargs),
                         lambda: plain(*args, **kwargs), iters=iters,
                         warmup=2)
        r = t[name]
        r["ms"] += k
        r["plain_ms"] += p
        r["calls"] += 1
        out = _tensors(plain(*args, **kwargs))
        b_ms = call_bytes(args, kwargs, out) / PEAK_BYTES_S * 1e3
        o_ms = ops_ms(name, args, kwargs)
        r["flops"] += call_flops(name, args, kwargs)
        r["bytes_ms"] += b_ms
        r["ops_ms"] += o_ms
        r["bound_ms"] += max(b_ms, o_ms)
        emit(timing_call=name, path=path,
             shapes=[list(a.shape) for a in args if torch.is_tensor(a)],
             ms=k, plain_ms=p, bound_ms=max(b_ms, o_ms),
             bound_by="bytes" if b_ms >= o_ms else "operations")
        lib = library_call(name, args, kwargs)
        if lib is not None:
            lib_ms = (cuda_ms(lib, iters=iters, warmup=2)
                      + cuda_ms(lib, iters=iters, warmup=2)) / 2
            r["library_ms"] += lib_ms
            r["library_of_ms"] += k
            r["library_calls"] += 1
    for name, r in t.items():
        r["bound_by"] = "bytes" if r["bytes_ms"] >= r["ops_ms"] \
            else "operations"
        r["tflops"] = r["flops"] / r["ms"] / 1e9 \
            if base_name(name) in CONV_KERNELS and r["ms"] else None
        if not r["library_calls"]:
            r["library_ms"] = r["library_of_ms"] = None
    return t


def step_noise(cfg: Config, batch: int, dev):
    """Automask noise for one step, 1e-5 * N(0, 1) per scale, from numpy:
    the same draws for the kernel and the all-plain step. Each scale's has
    the shape of its identity maps: (sources, batch, H, W), one candidate
    under avg_reprojection, and the scale's own H, W under
    v1_multiscale."""
    rng = np.random.default_rng(5)
    n = 1 if cfg.avg_reprojection else len(cfg.frame_ids) - 1
    return [torch.as_tensor(rng.standard_normal(
        (n, batch) + ((cfg.height >> s, cfg.width >> s) if cfg.v1_multiscale
                      else (cfg.height, cfg.width))) * 1e-5,
        dtype=torch.float32, device=dev) for s in cfg.scales]


def step_grads(cfg, nets, batch, noise, loss_of=loss_fn):
    """(loss, {param: grad}) of one training-mode step of the loss
    `loss_of` (the stage-1 loss, or `completion_loss`), no update; the
    parameters the loss does not read (the beam-pose encoder of the
    posecnn and shared pose types) have no gradient and are left out."""
    nets.zero_grad(set_to_none=True)
    loss, _ = loss_of(cfg, nets, batch, noise=noise)
    loss.backward()
    return loss.item(), {n: p.grad.detach().clone()
                         for n, p in nets.named_parameters()
                         if p.grad is not None}


def nudged(batch, seed: int):
    """The batch with every image value moved one float32 step up or down
    at random: a step whose inputs differ from the given one's by float32
    rounding only."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    out = dict(batch)
    for key, v in batch.items():
        if key.startswith("color"):
            up = (torch.rand(v.shape, generator=g) < 0.5).to(v.device)
            out[key] = torch.nextafter(v, torch.where(
                up, torch.full_like(v, float("inf")),
                torch.full_like(v, float("-inf"))))
    return out


def nudged_bf16(batch, seed: int):
    """The batch with every value of the images and the 2-channel LiDAR
    moved by one bf16 step up or down at random: a bf16 step whose
    roundings differ from the given one's in every encoder."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    out = dict(batch)
    for key, v in batch.items():
        if key.startswith("color") or key == "two_channel":
            sign = torch.where(torch.rand(v.shape, generator=g) < 0.5, 1.0,
                               -1.0).to(v.device)
            out[key] = v * (1 + BF16_U * sign)
    return out


@contextlib.contextmanager
def summand_scales(model, scales):
    """For every ConvBlock of `model` (the decoders' reflect-pad convs and
    disparity heads) whose output needs a gradient, add to
    scales["<block>.conv.weight"] and scales["<block>.conv.bias"] the
    magnitudes of the products that the block's weight and bias gradients
    sum, summed the same way: the plain wgrad of |cotangent| and |input|,
    and the |cotangent| summed over the batch and the pixels. The
    cotangent is the one before the ELU, which is 1 where the output is
    positive and output + 1 elsewhere."""
    def on_output(name):
        def hook(module, inputs, out):
            x0 = inputs[0].detach().abs()
            x1 = inputs[1] if len(inputs) > 1 else None
            x1 = None if x1 is None else x1.detach().abs()
            elu = out.detach() if module.elu else None

            def add(g):
                g = g.detach()
                if elu is not None:
                    g = g * torch.where(elu > 0, 1.0, elu + 1.0)
                g = g.abs()
                for leaf, v in (("weight", conv3x3.conv3x3_wgrad_plain(
                        g, x0, x1, reflect=True)), ("bias", g.sum((0, 2, 3)))):
                    key = f"{name}.conv.{leaf}"
                    scales[key] = scales[key] + v if key in scales else v
            if out.requires_grad:
                out.register_hook(add)
        return hook

    handles = [m.register_forward_hook(on_output(n))
               for n, m in model.named_modules() if isinstance(m, ConvBlock)]
    try:
        yield
    finally:
        for h in handles:
            h.remove()


def hold_step(check, grads, batch, noise, grads64, kernels,
              loss_rel=STEP_LOSS_REL, cap=STEP_GRAD_CAP, nudge=nudged):
    """A whole batch-2 step through the kernels against all-plain and
    float64. `grads(batch, noise)` gives (loss, {leaf: gradient}) of one
    float32 step, `grads64()` (loss, {leaf: gradient}, {leaf: summand
    magnitudes}) of the float64 all-plain step on the same batch
    (`summand_scales`). The loss through the kernels must be within
    STEP_LOSS_REL of all-plain. Each gradient leaf's L2 distance to
    float64, relative to the float64 leaf's norm (for a decoder conv's
    leaf, to the norm of its summand magnitudes, which is no smaller: the
    error a float32 sum may have is a fraction of it), must be within
    STEP_GRAD_REL, or within STEP_NOISE_X times that leaf's float32 noise,
    the largest such distance among the all-plain float32 step and
    NOISE_STEPS more on `nudged` batches, but never beyond
    STEP_GRAD_CAP. A bf16 step passes its own loss_rel, cap (None: no
    cap) and nudge (STEP_LOSS_REL_BF16, STEP_GRAD_CAP_BF16,
    `nudged_bf16`)."""
    reset_launches()
    loss_k, grads_k = grads(batch, noise)
    require(all(LAUNCHES[k] for k in kernels),
            f"{check}: the kernel step launched {LAUNCHES}")
    with all_plain():
        loss_p, grads_p = grads(batch, noise)
        noisy = [grads_p] + [grads(nudge(batch, s), noise)[1]
                             for s in range(NOISE_STEPS)]
        loss_r, grads_r, scales = grads64()
    require(set(scales) <= set(grads_r), f"{check}: leaves {set(scales)}")
    loss_rel_k = abs(loss_k - loss_p) / abs(loss_p)
    rows = []
    for n, ref in grads_r.items():
        r = ref.norm()
        if n in scales:
            r = torch.maximum(r, scales[n].norm())
        r = r.clamp_min(1e-30)

        def dist(g):
            return ((g.double() - ref).norm() / r).item()

        noise_n = max(dist(g[n]) for g in noisy)
        limit = max(STEP_GRAD_REL, STEP_NOISE_X * noise_n if cap is None
                    else min(STEP_NOISE_X * noise_n, cap))
        rows.append(dict(leaf=n, kernel=dist(grads_k[n]),
                         plain=dist(grads_p[n]), noise=noise_n, limit=limit,
                         kernel_vs_plain=((grads_k[n] - grads_p[n]).norm()
                                          / grads_p[n].norm().clamp_min(
                                              1e-30)).item()))
    bad = [row for row in rows if row["kernel"] > row["limit"]]
    worst = max(rows, key=lambda row: row["kernel"] / row["limit"])
    worst_kp = max(rows, key=lambda row: row["kernel_vs_plain"])
    emit(check=check, batch=CHECK_BATCH, loss=loss_k, loss_rel_diff=loss_rel_k,
         loss_f64=loss_r, loss_rel_diff_f64=abs(loss_k - loss_r) / abs(loss_r),
         worst_grad_rel_l2=worst_kp["kernel_vs_plain"],
         worst_leaf=worst_kp["leaf"],
         leaves_over_1e3=sum(row["kernel_vs_plain"] > STEP_GRAD_REL
                             for row in rows),
         worst_kernel_vs_f64=worst["kernel"], its_plain_vs_f64=worst["plain"],
         its_noise_vs_f64=worst["noise"], its_limit=worst["limit"],
         worst_kernel_leaf=worst["leaf"], leaves=len(rows),
         summand_scaled_leaves=len(scales), noise_steps=NOISE_STEPS + 1,
         leaves_at_cap=sum(row["limit"] == cap for row in rows),
         leaves_noise_over_0_1=sum(row["noise"] > 0.1 for row in rows),
         noise_over_0_1_by_net=dict(collections.Counter(
             row["leaf"].split(".")[0] for row in rows
             if row["noise"] > 0.1)),
         tol=[loss_rel, STEP_GRAD_REL, STEP_NOISE_X, cap])
    # the leaves whose float32 noise sets their limit above STEP_GRAD_REL
    emit(check=check + "_noisy_leaves", leaves=[
        row for row in sorted(rows, key=lambda row: -row["noise"])
        if row["limit"] > STEP_GRAD_REL][:12])
    require(loss_rel_k <= loss_rel, f"{check}: loss differs by "
            f"{loss_rel_k}")
    require(not bad, f"{check}: gradient leaves off float64 beyond the "
            f"float32 noise: {bad[:5]}")


def infer_phase(dev, tmp):
    """Step 4: the inference path, as in the first slice."""
    cfg = Config(num_layers=18, height=HEIGHT, width=WIDTH,
                 weights_init="scratch", eval_batch_size=1, log_dir=tmp)
    # a weights folder, loaded by both entry points as a user's would be
    cfg = cfg.replace(load_weights_folder=ckpt.save_checkpoint(
        cfg, seeded_weights(cfg), "smoke"))
    frames = SmokeFrames(cfg, FRAMES)
    infer = Infer(cfg, device=dev)
    nets = infer.nets
    one = device_batch(collate([frames[0]]), dev)
    four = device_batch(collate([frames[i] for i in range(4)]), dev)

    calls = []
    with torch.no_grad():
        with all_plain(record=calls):
            nets.forward_depth(one)
    edges = [c for c in edge_calls(dev) if c[0] in FORWARD_KERNELS]
    err = check_kernels(calls + edges)
    for name, e in err.items():
        emit(check=name, path="infer",
             calls_per_forward=sum(c[0] == name for c in calls),
             edge_cases=sum(c[0] == name for c in edges), max_abs_err=e)

    launches = {}
    with tempfile.TemporaryDirectory() as out:
        reset_launches()
        t = time.perf_counter()
        n = infer.run_split(frames, out)
        torch.cuda.synchronize()
        launches["infer"] = dict(LAUNCHES)
        secs = time.perf_counter() - t
        require(n == FRAMES, f"run_split wrote {n} of {FRAMES} frames")
        for i in range(FRAMES):
            folder, idx, side = frames.parse_line(i)
            d = np.load(os.path.join(out, folder, infer.out_folder(),
                                     f"{idx}_{side}.npy"))
            require(d.shape == (1, 1, HEIGHT, WIDTH) and
                    d.dtype == np.float32, f"frame {i}: {d.shape} {d.dtype}")
            require(bool(np.isfinite(d).all() and (d > 0).all() and
                         (d < 1).all()), f"frame {i}: disparity not in (0, 1)")
    emit(phase="infer_run_split", frames=n, seconds=secs,
         launches=launches["infer"])

    reset_launches()
    t = time.perf_counter()
    disps, _ = predict_disparities(
        cfg.replace(eval_batch_size=4, post_process=True), frames,
        device=dev)
    torch.cuda.synchronize()
    launches["predict"] = dict(LAUNCHES)
    emit(phase="predict_disparities", frames=len(disps),
         seconds=time.perf_counter() - t, launches=launches["predict"])
    require(len(disps) == FRAMES, f"{len(disps)} disparities")
    for d in disps:
        require(d.shape == (HEIGHT, WIDTH) and bool(np.isfinite(d).all())
                and bool(((d > 0) & (d < 1)).all()),
                "predicted disparity not finite in (0, 1)")
    for path, counts in launches.items():
        for name in FORWARD_KERNELS:
            require(counts[name] > 0,
                    f"{path}: kernel {name} was never launched")

    with torch.no_grad():
        reset_launches()
        got = nets.forward_depth(four)[0]
        require(all(LAUNCHES[k] for k in FORWARD_KERNELS),
                f"kernel forward launched {LAUNCHES}")
        reset_launches()
        with all_plain():
            want = nets.forward_depth(four)[0]
        require(not any(LAUNCHES.values()),
                f"plain forward launched {LAUNCHES}")
        fwd_err = max((got[k] - want[k]).abs().max().item() for k in want)
        emit(check="forward_vs_all_plain", batch=4, max_abs_err=fwd_err,
             atol=FORWARD_ATOL)
        require(fwd_err <= FORWARD_ATOL, f"forward differs from all-plain "
                f"by {fwd_err}")

        card = card_line()
        for label, b in (("batch1", one), ("batch4", four)):
            def run_plain():
                with all_plain():
                    nets.forward_depth(b)
            k, p = paired_ms(lambda: nets.forward_depth(b), run_plain,
                             iters=10)
            emit(timing="forward_depth", batch=label, ms=k, plain_ms=p,
                 card=card)
    return err, launches


def train_phase(dev, tmp):
    """Step 5 and the step timings of step 6: the training path."""
    cfg = Config(num_layers=18, height=HEIGHT, width=WIDTH,
                 batch_size=TRAIN_BATCH, weights_init="scratch",
                 log_dir=tmp, num_workers=4, log_frequency=1,
                 model_name="smoke_train")
    data = SyntheticDataset(cfg, length=TRAIN_FRAMES, seed=2)
    nets = seeded_weights(cfg).to(dev)
    small = device_batch(collate([data[i] for i in range(CHECK_BATCH)]),
                         dev, TRAIN_KEYS)
    noise = step_noise(cfg, CHECK_BATCH, dev)

    # every kernel on the inputs a batch-2 train step gives it
    calls = []
    with all_plain(record=calls):
        loss_fn(cfg, nets, small, noise=noise)[0].backward()
    nets.zero_grad(set_to_none=True)
    edges = edge_calls(dev)
    err = check_kernels(calls + edges)
    emit_checks(err, calls, edges, "train")
    del calls, edges

    # a whole batch-2 step through the kernels against all-plain, both
    # held against an all-plain float64 step of the same weights
    def grads64():
        cfg64 = cfg.replace(compute_dtype="float64")
        ref = copy.deepcopy(nets).double()
        ref.cfg = cfg64
        scales = {}
        with summand_scales(ref, scales):
            loss, grads = step_grads(cfg64, ref, {k: v.double() for k, v in
                                                  small.items()},
                                     [n.double() for n in noise])
        return loss, grads, scales

    hold_step("train_step_vs_all_plain",
              lambda b, n: step_grads(cfg, nets, b, n), small, noise,
              grads64, TRAIN_KERNELS)
    del nets

    # the entry point: 3 steps at batch 12 through the kernels
    trainer = Trainer(cfg, train_dataset=data, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t = time.perf_counter()
    losses = [float(x) for x in trainer.run_epoch()]
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    secs = time.perf_counter() - t
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    emit(phase="trainer_run_epoch", steps=len(losses), batch=TRAIN_BATCH,
         seconds=secs, losses=losses, launches=launches,
         peak_memory_gib=peak_gib)
    require(len(losses) == TRAIN_FRAMES // TRAIN_BATCH,
            f"{len(losses)} steps")
    require(all(np.isfinite(losses)), f"non-finite losses {losses}")
    for name in TRAIN_KERNELS:
        require(launches[name] > 0, f"train: kernel {name} was never "
                "launched")

    path = trainer.save("smoke")
    infer = Infer(cfg.replace(load_weights_folder=path), device=dev)
    probe = device_batch(collate([data[i] for i in range(4)]), dev)
    with torch.no_grad():
        want = trainer.nets.forward_depth(probe, train=False)[0][("disp", 0)]
        got = infer.infer(probe)
    reload_err = (got - want).abs().max().item()
    emit(check="checkpoint_reload_in_infer", max_abs_err=reload_err)
    require(reload_err <= 1e-6, f"reloaded bundle differs by {reload_err}")

    # every kernel on the inputs of a batch-12 step, the main path's (the
    # backward ones also with unit-scale cotangents);
    # timings: each kernel over the calls of that step, and the step itself
    # through the kernels against all-plain
    big = trainer.put_batch(collate([data[i] for i in range(TRAIN_BATCH)]))
    calls = []
    with all_plain(record=calls):
        loss_fn(cfg, trainer.nets, big)[0].backward()
    trainer.nets.zero_grad(set_to_none=True)
    err_big = check_step_calls(calls, dev, "train_batch12")
    wgrad_repeats(calls)
    err = {k: max(e, err_big.get(k, 0.0)) for k, e in err.items()}
    ktimes = time_kernels(calls, "train_batch12")
    del calls

    def kernel_step():
        trainer.run_step(big, on_device=True)

    def plain_step():
        with all_plain():
            trainer.run_step(big, on_device=True)

    step_ms, plain_step_ms = paired_ms(kernel_step, plain_step, iters=3,
                                       warmup=1)
    emit(timing="train_step", batch=TRAIN_BATCH, ms=step_ms,
         plain_ms=plain_step_ms,
         samples_per_s=TRAIN_BATCH / step_ms * 1e3,
         plain_samples_per_s=TRAIN_BATCH / plain_step_ms * 1e3,
         kernels_ms=sum(r["ms"] for r in ktimes.values()),
         peak_memory_gib=peak_gib)
    return err, launches, ktimes


def reproj_edge_calls(dev):
    """Inputs the train step does not give the fused reprojection loss: H
    that is no multiple of the TPU kernel's 16-row blocks, W = 2, H = 2, a
    whole plane where warped == target exactly (the SSIM term on its clip
    bound, the L1 term at its kink) and such a patch inside random
    images. Part of `edge_calls`."""
    g = torch.Generator(device=dev).manual_seed(3)
    calls = []
    for n, k, B, H, W in ((2, 4, 2, 37, 53), (1, 2, 3, 20, 2),
                          (2, 1, 1, 2, 9), (1, 1, 2, 45, 70)):
        warped = torch.rand((n, k, B, 3, H, W), generator=g, device=dev)
        target = torch.rand((B, 3, H, W), generator=g, device=dev)
        warped[-1, -1, -1] = target[-1]
        if H >= 20 and W >= 20:
            warped[0, 0, 0, :, 3:15, 4:16] = target[0, :, 3:15, 4:16]
        gl = torch.randn((n, k, B, H, W), generator=g, device=dev)
        calls += [("reproj", [warped, target], {}),
                  ("reproj_bwd", [warped, target, gl], {})]
    return calls


def knn_edge_calls(dev):
    """A GDC-sized cloud (N = 40960, GDC's default capacities) with exact
    duplicates, a regular grid (many equidistant neighbours) and padded
    rows at the far sentinel, spread along x by index as gdc_correct
    places them; and a ragged N."""
    g = torch.Generator(device=dev).manual_seed(4)
    N = sum(GDC_CAPS)
    pts = torch.randn((N, 3), generator=g, device=dev) * 10
    pts[1000:1500] = pts[:500]
    ar = torch.arange(16, device=dev, dtype=torch.float32)
    grid = torch.stack(torch.meshgrid(ar, ar, ar, indexing="ij"),
                       -1).reshape(-1, 3) * 0.25
    pts[5000:5000 + grid.shape[0]] = grid
    pad = 3000
    pts[-pad:] = 1e8
    pts[-pad:, 0] += torch.arange(N - pad, N, device=dev,
                                  dtype=torch.float32)
    ragged = torch.randn((1037, 3), generator=g, device=dev)
    return [("knn", [pts, 10], {}), ("knn", [ragged, 10], {})]


def cdist_topk(points, k):
    """The KNN as two PyTorch calls per chunk of queries, cdist and topk
    (self excluded): the yardstick for the KNN kernel, which no single
    library call computes."""
    N, chunk = points.shape[0], knn_kernel.QUERY_CHUNK
    for lo in range(0, N, chunk):
        d = torch.cdist(points[lo:lo + chunk], points)
        rows = torch.arange(d.shape[0], device=d.device)
        d[rows, lo + rows] = float("inf")
        torch.topk(d, k, dim=1, largest=False)


class TreeFrames(SmokeFrames):
    """Synthetic frames at the network size named as the frames of the
    synthetic KITTI drive, each with the drive's LiDAR depth map at the
    native size as its ground truth (for evaluate)."""

    def __init__(self, cfg: Config, n: int, root: str):
        super().__init__(cfg, n)
        self.root = root
        date = DRIVE.split("/")[0]
        self.gt = [generate_depth_map(
            os.path.join(root, date), os.path.join(
                root, DRIVE, "velodyne_points", "data", f"{i:010d}.bin"), 2)
            for i in range(n)]

    def __getitem__(self, i):
        return {**self.inner[i], "depth_gt": self.gt[i]}

    def parse_line(self, i):
        return DRIVE, i, "l"

    def beam_folder(self):
        return "4beam"

    def frame_str(self, i):
        return f"{int(i):010d}"


def gdc_phase(dev, tmp, weights):
    """Path B, offline GDC: the inf_depth caches of Infer.run_split, then
    run_inf_gdc at KITTI's native size with the default capacities (KNN
    kernel)."""
    root = os.path.join(tmp, "kitti")
    build_synthetic_kitti_tree(root, n_frames=GDC_FRAMES, height=HEIGHT,
                               width=WIDTH, native=NATIVE)
    cfg = Config(num_layers=18, height=HEIGHT, width=WIDTH,
                 weights_init="scratch", eval_batch_size=1, log_dir=tmp,
                 data_path=root, load_weights_folder=weights)
    frames = TreeFrames(cfg, GDC_FRAMES, root)
    require(Infer(cfg, device=dev).run_split(frames, root) == GDC_FRAMES,
            "run_split wrote too few frames")
    lines = [" ".join(map(str, frames.parse_line(i)))
             for i in range(GDC_FRAMES)]
    date = DRIVE.split("/")[0]
    calib = Calibration.from_file(os.path.join(root, date,
                                               "calib_cam_to_cam.txt"))

    # the kernel on the cloud of a frame, and GDC through plain KNN
    calls = []
    with all_plain(record=calls):
        plain0 = gdc_one_frame(cfg, root, DRIVE, 0, "l", calib, device=dev)
    require([c[0] for c in calls] == ["knn"], f"GDC made {calls}")
    edges = knn_edge_calls(dev)
    err = check_kernels(calls + edges)
    emit_checks(err, calls, edges, "inf_gdc")
    pts, k = calls[0][1]
    # kernel and plain version round d^2 alike, so they give one graph
    same_graph = torch.equal(knn_kernel.knn(pts, k),
                             knn_kernel.knn_plain(pts, k))
    require(same_graph, "the KNN kernel and its plain version give frame 0 "
            "different neighbour graphs")
    ktimes = time_kernels(calls, "inf_gdc")
    lib = [cuda_ms(lambda: cdist_topk(pts, k), iters=3, warmup=1)
           for _ in range(2)]
    ktimes["knn"]["cdist_topk_ms"] = sum(lib) / 2
    del calls, edges
    err["knn"] = max(err["knn"], whole_frame_knn(cfg, root, calib, dev))

    # the entry point over every frame
    torch.cuda.synchronize()
    reset_launches()
    t = time.perf_counter()
    n = run_inf_gdc(cfg, lines, device=dev)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    launches = dict(LAUNCHES)
    require(n == GDC_FRAMES and launches["knn"] == GDC_FRAMES,
            f"run_inf_gdc wrote {n} frames, {launches['knn']} KNN launches")
    out_dir = os.path.join(root, DRIVE, "inf_gdc_4beam")
    for i in range(GDC_FRAMES):
        d = np.load(os.path.join(out_dir, f"{i}_l.npy"))
        beams = generate_depth_map(
            os.path.join(root, date),
            os.path.join(root, DRIVE, "4beam", f"{i:010d}.bin"), 2,
            vel_depth=True)
        require(d.shape == NATIVE and d.dtype == np.float32
                and bool(np.isfinite(d).all()), f"GDC frame {i}: {d.shape}")
        require(np.array_equal(d[beams > 0], beams[beams > 0]),
                f"GDC frame {i}: the LiDAR is not pasted")
    kern0 = np.load(os.path.join(out_dir, "0_l.npy"))
    diff = float(np.abs(kern0 - plain0).max())
    emit(phase="run_inf_gdc", frames=n, seconds=secs,
         ms_per_frame=secs / n * 1e3, launches=launches,
         native=list(NATIVE), caps=list(GDC_CAPS))
    emit(check="gdc_kernel_vs_plain_knn", frame=0, same_graph=same_graph,
         max_abs_diff=diff)
    # the rest of GDC is deterministic: one neighbour graph, one result
    require(diff == 0.0, f"GDC through the kernel and through plain KNN "
            f"differ by {diff} on the same neighbour graph")
    return err, launches, ktimes, frames


def whole_frame_knn(cfg, root, calib, dev) -> float:
    """The KNN on the cloud of frame 0 at capacities that hold the whole
    frame (WHOLE_FRAME_CAPS; the default ones drop about half of its
    pseudo-LiDAR points): held against its plain version (sorted neighbour
    distances within KNN_DIST_RTOL) and timed. Returns the largest
    distance error."""
    calls = []
    with all_plain(record=calls):
        gdc_one_frame(cfg, root, DRIVE, 0, "l", calib,
                      *WHOLE_FRAME_CAPS, device=dev)
    require([c[0] for c in calls] == ["knn"], f"GDC made {calls}")
    pts = calls[0][1][0]
    cap_pl = WHOLE_FRAME_CAPS[0]
    real = pts.abs().amax(1) < 1e7
    n_pl, n_l = int(real[:cap_pl].sum()), int(real[cap_pl:].sum())
    require(n_pl < cap_pl, f"frame 0 has {n_pl} pseudo-LiDAR points, more "
            f"than cap_pl = {cap_pl}")
    err = check_kernels(calls)["knn"]
    t = time_kernels(calls, "inf_gdc_whole_frame", iters=3)["knn"]
    emit(check="knn_whole_frame", points=pts.shape[0], n_pl=n_pl, n_l=n_l,
         caps=list(WHOLE_FRAME_CAPS), max_abs_dist_err=err, ms=t["ms"],
         plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
         bound_by=t["bound_by"])
    return err


class RefineFrames(SmokeFrames):
    """Synthetic frames carrying an inf_gdc target (metres)."""

    def __init__(self, cfg: Config, n: int):
        super().__init__(cfg, n)
        rng = np.random.default_rng(6)
        self.gdc = rng.uniform(5.0, 30.0, (n, cfg.height, cfg.width, 1)) \
            .astype(np.float32)

    def __getitem__(self, i):
        return {**self.inner[i], "inf_gdc": self.gdc[i]}


def refine_grads(cfg, nets, batch, noise):
    """(loss, {param: grad}) of one refine step, no update: the refine
    decoder's leaves, and with train_entire_net the stage-1 leaves the
    loss reads."""
    nets.zero_grad(set_to_none=True)
    loss, _ = refine_loss(cfg, nets, batch, noise=noise)
    loss.backward()
    return loss.item(), {n: p.grad.detach().clone()
                         for n, p in nets.named_parameters()
                         if p.grad is not None}


def hold_refine_step(check, cfg, nets, small, noise, kernels):
    """`hold_step` on a whole batch-2 refine step: the loss and every
    gradient leaf (the stage-1 ones too under train_entire_net) through
    the kernels against all-plain and an all-plain float64 step of the
    same weights."""
    def grads64():
        ref = copy.deepcopy(nets).double()
        scales = {}
        with summand_scales(ref, scales):
            loss, grads = refine_grads(
                cfg, ref, {k: v.double() for k, v in small.items()},
                [[n.double() for n in noise[0]]])
        return loss, grads, scales

    hold_step(check, lambda b, n: refine_grads(cfg, nets, b, n), small,
              noise, grads64, kernels)
    nets.zero_grad(set_to_none=True)


def refine_phase(dev, tmp, weights, tree_frames):
    """Path B, the refiner (BASELINE config 4: ResNet-18, 640x192,
    batch 4): the kernels on the calls of a batch-4 refine step (the
    backward ones also with unit-scale cotangents), a whole
    batch-2 step against all-plain and float64, Refiner.run_epoch, a
    checkpoint round trip, and evaluate with refine_2d and with
    eval_gdc."""
    cfg = Config(num_layers=18, height=HEIGHT, width=WIDTH,
                 batch_size=REFINE_BATCH, weights_init="scratch",
                 log_dir=tmp, num_workers=4, log_frequency=1,
                 model_name="smoke", eval_batch_size=1,
                 refine_load_weights_folder=weights,
                 data_path=tree_frames.root)
    data = RefineFrames(cfg, REFINE_FRAMES)
    refiner = Refiner(cfg, train_dataset=data, device=dev)
    nets = refiner.nets
    small = refiner.put_batch(collate([data[i] for i in range(CHECK_BATCH)]))
    big = refiner.put_batch(collate([data[i] for i in range(REFINE_BATCH)]))
    noise = [step_noise(cfg, CHECK_BATCH, dev)]

    # every kernel on the inputs of a batch-4 step, the main path's
    calls = []
    with all_plain(record=calls):
        refine_loss(cfg, nets, big)[0].backward()
    nets.zero_grad(set_to_none=True)
    err = check_step_calls(calls, dev, "refine")
    time_kernels([c for c in calls if c[0] in ("warp", "warp_bwd")],
                 "refine_batch4")
    del calls

    # a whole batch-2 step through the kernels against all-plain, both
    # held against an all-plain float64 step of the same weights
    hold_refine_step("refine_step_vs_all_plain", cfg, nets, small, noise,
                     REFINE_KERNELS)

    # the entry point: 3 steps at batch 4 through the kernels
    torch.cuda.synchronize()
    reset_launches()
    t = time.perf_counter()
    losses = [float(x) for x in refiner.run_epoch()]
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    emit(phase="refiner_run_epoch", steps=len(losses), batch=REFINE_BATCH,
         seconds=time.perf_counter() - t, losses=losses, launches=launches)
    require(len(losses) == REFINE_FRAMES // REFINE_BATCH,
            f"{len(losses)} refine steps")
    require(all(np.isfinite(losses)), f"non-finite refine losses {losses}")
    for name in REFINE_KERNELS:
        require(launches[name] > 0, f"refine: kernel {name} was never "
                "launched")

    path = refiner.save("smoke")
    reloaded = Refiner(cfg, device=dev)
    reloaded.load(path)
    probe = device_batch(collate([tree_frames[i] for i in range(2)]), dev,
                         ("color_aug", "two_channel", "four_beam", "K"))
    reload_err = (reloaded.infer(probe) - refiner.infer(probe)).abs().max()
    emit(check="refine_checkpoint_reload", max_abs_err=reload_err.item())
    require(reload_err.item() == 0.0, f"reloaded refiner differs by "
            f"{reload_err.item()}")

    evals = {}
    for label, flags in (("refine_2d", dict(refine_2d=True)),
                         ("refine_2d+eval_gdc", dict(refine_2d=True,
                                                      eval_gdc=True))):
        ecfg = cfg.replace(load_weights_folder=path, **flags)
        reset_launches()
        t = time.perf_counter()
        metrics = evaluate(ecfg, tree_frames, device=dev)
        torch.cuda.synchronize()
        evals[label] = dict(LAUNCHES)
        emit(phase="evaluate", mode=label, frames=len(tree_frames),
             seconds=time.perf_counter() - t, metrics=metrics,
             launches=evals[label])
        require(metrics is not None and all(
            np.isfinite(v) for v in metrics.values()),
            f"evaluate {label}: {metrics}")
    require(evals["refine_2d+eval_gdc"]["knn"] == len(tree_frames),
            "evaluate with eval_gdc ran no KNN kernel")

    def plain_step():
        with all_plain():
            refiner.run_step(big, on_device=True)

    step_ms, plain_ms = paired_ms(
        lambda: refiner.run_step(big, on_device=True), plain_step, iters=5,
        warmup=1)
    emit(timing="refine_step", batch=REFINE_BATCH, ms=step_ms,
         plain_ms=plain_ms, samples_per_s=REFINE_BATCH / step_ms * 1e3,
         plain_samples_per_s=REFINE_BATCH / plain_ms * 1e3)
    return err, launches


def refine_entire_phase(dev, tmp, weights):
    """The refiner with train_entire_net (BASELINE config 4: ResNet-18,
    640x192, batch 4): the stage-1 nets train with the refine decoder,
    their BatchNorm in eval mode, so the refine step runs every training
    kernel. Every kernel on the calls of a batch-4 step (the backward ones
    also with unit-scale cotangents), a whole batch-2 step against
    all-plain and float64, every gradient leaf (the stage-1 ones too);
    Refiner.run_epoch over 12 frames (3 steps at batch 4) with the counts
    set to 0 before and read after, the stage-1 BN running statistics
    unchanged by it; each kernel's calls of the batch-4 step and the step
    timed against all-plain."""
    t0 = time.perf_counter()
    cfg = Config(num_layers=18, height=HEIGHT, width=WIDTH,
                 batch_size=REFINE_BATCH, weights_init="scratch",
                 log_dir=tmp, num_workers=4, log_frequency=1,
                 model_name="smoke_entire", refine_load_weights_folder=weights,
                 train_entire_net=True)
    data = RefineFrames(cfg, REFINE_FRAMES)
    refiner = Refiner(cfg, train_dataset=data, device=dev)
    nets = refiner.nets
    small = refiner.put_batch(collate([data[i] for i in range(CHECK_BATCH)]))
    big = refiner.put_batch(collate([data[i] for i in range(REFINE_BATCH)]))

    calls = []
    with all_plain(record=calls):
        refine_loss(cfg, nets, big)[0].backward()
    nets.zero_grad(set_to_none=True)
    err = check_step_calls(calls, dev, "refine_entire_batch4")
    require(set(err) == set(REFINE_ENTIRE_KERNELS),
            f"the train_entire_net step called {sorted(err)}")
    hold_refine_step("refine_entire_step_vs_all_plain", cfg, nets, small,
                     [step_noise(cfg, CHECK_BATCH, dev)],
                     REFINE_ENTIRE_KERNELS)

    stats = {n: b.clone() for n, b in nets.stage1.named_buffers()}
    s1 = {n: p.detach().clone() for n, p in nets.stage1.named_parameters()}
    torch.cuda.synchronize()
    reset_launches()
    t = time.perf_counter()
    losses = [float(x) for x in refiner.run_epoch()]
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    moved = sum(not torch.equal(p, s1[n])
                for n, p in nets.stage1.named_parameters())
    still = all(torch.equal(b, stats[n])
                for n, b in nets.stage1.named_buffers())
    emit(phase="refiner_entire_run_epoch", steps=len(losses),
         batch=REFINE_BATCH, seconds=time.perf_counter() - t, losses=losses,
         launches=launches, stage1_leaves_moved=moved,
         stage1_leaves=len(s1), bn_stats_unchanged=still)
    require(len(losses) == REFINE_FRAMES // REFINE_BATCH,
            f"{len(losses)} train_entire_net steps")
    require(all(np.isfinite(losses)), f"non-finite losses {losses}")
    require(moved > 0, "train_entire_net moved no stage-1 parameter")
    require(still, "train_entire_net moved the stage-1 BN statistics")
    for name in REFINE_ENTIRE_KERNELS:
        require(launches[name] > 0, f"train_entire_net: kernel {name} was "
                "never launched")

    ktimes = time_kernels(calls, "refine_entire_batch4", iters=5)
    del calls

    def plain_step():
        with all_plain():
            refiner.run_step(big, on_device=True)

    step_ms, plain_ms = paired_ms(
        lambda: refiner.run_step(big, on_device=True), plain_step, iters=3,
        warmup=1)
    emit(timing="refine_entire_step", batch=REFINE_BATCH, ms=step_ms,
         plain_ms=plain_ms, samples_per_s=REFINE_BATCH / step_ms * 1e3,
         plain_samples_per_s=REFINE_BATCH / plain_ms * 1e3,
         kernels_ms=sum(r["ms"] for r in ktimes.values()),
         seconds=time.perf_counter() - t0)
    return err, launches, ktimes


def refine_variant_step(dev, tmp):
    """One refine step at batch 4 (ResNet-18, 640x192) with the stage-1
    variants `REFINE_VARIANT` on seeded weights: every kernel on its
    calls (the backward ones also with unit-scale cotangents), then one
    Refiner.run_step through the kernels with every refine kernel
    launched."""
    t0 = time.perf_counter()
    cfg = Config(num_layers=18, height=HEIGHT, width=WIDTH,
                 batch_size=REFINE_BATCH, weights_init="scratch",
                 log_dir=tmp, model_name="smoke_refine_variant",
                 **REFINE_VARIANT)
    refiner = Refiner(cfg, device=dev)
    refiner.nets.stage1.load_state_dict(seeded_weights(cfg).state_dict())
    data = RefineFrames(cfg, REFINE_BATCH)
    big = refiner.put_batch(collate([data[i] for i in range(REFINE_BATCH)]))
    require(big["color"].shape[1] == 4 and "stereo_T" in big,
            "the refine variant batch lacks the stereo frame")
    calls = []
    with all_plain(record=calls):
        refine_loss(refiner.cfg, refiner.nets, big)[0].backward()
    refiner.nets.zero_grad(set_to_none=True)
    err = check_step_calls(calls, dev, "refine_variant_batch4")
    require(set(err) == set(REFINE_KERNELS),
            f"the refine variant step called {sorted(err)}")
    del calls
    torch.cuda.synchronize()
    reset_launches()
    loss = float(refiner.run_step(big, on_device=True)["loss"])
    launches = dict(LAUNCHES)
    emit(phase="refiner_variant_run_step", flags=REFINE_VARIANT,
         batch=REFINE_BATCH, loss=loss, launches=launches,
         seconds=time.perf_counter() - t0)
    require(np.isfinite(loss), f"refine variant loss {loss}")
    for name in REFINE_KERNELS:
        require(launches[name] > 0, f"refine variant: kernel {name} was "
                "never launched")
    return err, launches


def voxel_tables(depth, inv_K, unet_levels):
    """Level 0's voxel list of one depth ((coords, feats, valid, p2v,
    keys) of `refine_net3d.depth_to_voxels`), its neighbour table, and the
    U-Net's pyramid over `unet_levels` levels."""
    vox = refine_net3d.depth_to_voxels(depth, inv_K, REFINE3D_VOXEL,
                                       REFINE3D_CAPACITY)
    nb = refine_net3d.neighbor_table(vox[0], vox[4], vox[2],
                                     refine_net3d._kernel_offsets(3))
    tables, c2p = refine_net3d.build_voxel_pyramid(
        vox[0], vox[4], vox[2], unet_levels, REFINE3D_CAPACITY)
    return vox, nb, tables, c2p


def stage1_depth0(r, batch):
    """Sample 0's stage-1 depth (H, W) of a Refiner3D's frozen stage 1."""
    with torch.no_grad():
        out, _ = r.stage1.forward_depth(batch)
    return disp_to_depth(out[("disp", 0)][0, ..., 0], r.cfg.min_depth,
                         r.cfg.max_depth)[1]


def hold_voxel_tables(r, batch, dev):
    """The voxel tables of sample 0's stage-1 depth built on the card and
    on the CPU, for two frames: the refine3d phase's (below capacity) and
    the same sample with the disparity head's bias at
    REFINE3D_OVERFLOW_SHIFT (more unique voxels than capacity: the
    overflow merges into the last slot, and every slot is valid). For
    each, from the same float32 points (`refine_net3d.voxelize`) and from
    the same float64 depth (level 0, its neighbour table, the U-Net's
    pyramid), each integer array equal, the features within
    REFINE3D_FEAT_RTOL; and `refine_net3d.gather_rows`' backward against
    index_add_ in float64 (1e-12 of the largest) on its neighbour table
    and its point-to-voxel map. Returns the first frame's unique-voxel
    count."""
    depths = {"frame": stage1_depth0(r, batch)}
    bias = r.stage1.depth.dispconv_0.conv.bias
    kept = bias.detach().clone()
    with torch.no_grad():
        bias += REFINE3D_OVERFLOW_SHIFT - REFINE3D_DISP_SHIFT
    try:
        depths["overflow"] = stage1_depth0(r, batch)
    finally:
        with torch.no_grad():
            bias.copy_(kept)
    inv_K = batch["inv_K"][0]
    cpu = torch.device("cpu")
    g = torch.Generator(device=dev).manual_seed(7)
    uniques = {}
    for frame, depth in depths.items():
        points = backproject_depth(depth[None], inv_K[None])[0].reshape(-1,
                                                                        3)
        vals = torch.stack([depth.reshape(-1),
                            torch.ones_like(depth).reshape(-1)], 1)
        pairs = [(refine_net3d.voxelize(points, vals, REFINE3D_VOXEL,
                                        REFINE3D_CAPACITY),
                  refine_net3d.voxelize(points.to(cpu), vals.to(cpu),
                                        REFINE3D_VOXEL, REFINE3D_CAPACITY))]
        # the Refiner3D U-Net's widths (16, 32, 64, 64): 3 levels
        d64, k64 = depth.double(), inv_K.double()
        card = voxel_tables(d64, k64, 3)
        host = voxel_tables(d64.to(cpu), k64.to(cpu), 3)
        pairs += [(card[0], host[0]), ([card[1]], [host[1]])]
        pairs += [(list(a.values()), list(b.values()))
                  for a, b in zip(card[2], host[2])]
        pairs.append((card[3], host[3]))
        arrays = feat_err = 0
        for got, want in pairs:
            for a, b in zip(got, want):
                a = a.cpu()
                if a.is_floating_point():
                    e = ((a - b).abs() / b.abs().clamp_min(1e-30)).max(
                    ).item()
                    feat_err = max(feat_err, e)
                    require(e <= REFINE3D_FEAT_RTOL, f"{frame}: voxel "
                            f"features on the card off the CPU's by {e} "
                            "relative")
                else:
                    require(a.dtype == b.dtype and torch.equal(a, b),
                            f"{frame}: a voxel table ({tuple(a.shape)}, "
                            f"{a.dtype}) differs between the card and the "
                            "CPU")
                arrays += 1
        # gather_rows' backward (a segment sum in a fixed order) against
        # index_add_ in float64 on the frame's neighbour table (each row
        # repeated up to 27 times, the missing neighbours dropped) and its
        # point-to-voxel map (a voxel's points, thousands near the camera;
        # on the overflow frame the last slot's, a third of the frame's)
        gather_err = 0.0
        for idx in (card[1], card[0][3]):
            x = torch.randn((REFINE3D_CAPACITY, 16), dtype=torch.float64,
                            device=dev, generator=g, requires_grad=True)
            cot = torch.randn(idx.shape + (16,), dtype=torch.float64,
                              device=dev, generator=g)
            refine_net3d.gather_rows(x, idx).backward(cot)
            hit = idx >= 0
            want = torch.zeros_like(x).index_add_(0, idx[hit].long(),
                                                  cot[hit])
            e = ((x.grad - want).abs().max() / want.abs().max()).item()
            gather_err = max(gather_err, e)
            require(e <= 1e-12, f"{frame}: gather_rows' backward off "
                    f"index_add_ by {e}")
        uniques[frame] = int(refine_net3d.depth_to_voxels(
            d64, k64, REFINE3D_VOXEL, depth.numel())[2].sum())
        valid = int(card[0][2].sum())
        last_slot = int((card[0][3] == REFINE3D_CAPACITY - 1).sum())
        emit(check="refine3d_voxel_tables_card_vs_cpu", frame=frame,
             arrays=arrays, integer_equal=True, max_feat_rel_err=feat_err,
             feat_tol=REFINE3D_FEAT_RTOL,
             gather_rows_bwd_rel_err=gather_err, gather_rows_bwd_tol=1e-12,
             unique_voxels=uniques[frame], capacity=REFINE3D_CAPACITY,
             valid_slots=valid, points_in_last_slot=last_slot,
             unet_valid_slots=[int(tb["valid"].sum()) for tb in card[2]])
        if frame == "overflow":
            require(uniques[frame] > REFINE3D_CAPACITY
                    and valid == REFINE3D_CAPACITY,
                    f"the overflow frame has {uniques[frame]} unique "
                    f"voxels and {valid} valid slots of "
                    f"{REFINE3D_CAPACITY}")
    return uniques["frame"]


@contextlib.contextmanager
def fixed_voxel_tables(batch: int):
    """Within the block every Refiner3D step voxelizes sample i with the
    tables (coords, valid, point-to-voxel map, keys) that the block's
    first step built for its sample i, each voxel's features the mean of
    the step's own points ([depth, 1]) over that map, in the same order
    as `refine_net3d.voxelize` sums them (so the first step's features
    are its own bit for bit). The tables are discontinuous in the points
    (a depth a float32 rounding apart moves a point into another voxel,
    and one voxel more or less moves the step's gradient by up to ~90% at
    640x192: ROADMAP section 3), so steps through the kernels, all-plain,
    on nudged images and in float64 are held against each other on the
    same tables; `hold_voxel_tables` holds the tables themselves."""
    tables, calls = [], [0]
    build = refiner3d.depth_to_voxels

    def fixed(depth, inv_K, voxel_size, capacity):
        i = calls[0] % batch
        calls[0] += 1
        if len(tables) < batch:
            tables.append(build(depth, inv_K, voxel_size, capacity))
        coords, _, valid, p2v, keys = tables[i]
        vals = torch.stack([depth.reshape(-1),
                            torch.ones_like(depth).reshape(-1)], 1)
        sums = refine_net3d.segment_sum(vals, p2v, capacity)
        cnts = refine_net3d.segment_sum(vals[:, 1:], p2v, capacity)
        return coords, sums / torch.clamp(cnts, min=1.0), valid, p2v, keys

    refiner3d.depth_to_voxels = fixed
    try:
        yield
    finally:
        refiner3d.depth_to_voxels = build


def refine3d_grads(r, batch, noise=None):
    """(loss, {param: grad}) of one Refiner3D step, no update: every
    voxel-net leaf, the BN running statistics included."""
    r.net.zero_grad(set_to_none=True)
    loss = r.loss(batch)
    loss.backward()
    return loss.item(), {n: p.grad.detach().clone()
                         for n, p in r.net.named_parameters()
                         if p.grad is not None}


def refine3d_setup(tmp, frames):
    """The refine3d phase's config (BASELINE config 4's stage 1 at batch 4,
    its seeded weights with the disparity head's bias moved by
    REFINE3D_DISP_SHIFT, saved under `tmp` as refine_load_weights_folder)
    and `frames` synthetic frames carrying a GDC target."""
    cfg = Config(num_layers=18, height=HEIGHT, width=WIDTH,
                 batch_size=REFINE_BATCH, weights_init="scratch",
                 log_dir=tmp, num_workers=4, log_frequency=1, num_epochs=1,
                 model_name="smoke_refine3d")
    nets = seeded_weights(cfg)
    with torch.no_grad():
        nets.depth.dispconv_0.conv.bias += REFINE3D_DISP_SHIFT
    cfg = cfg.replace(refine_load_weights_folder=ckpt.save_checkpoint(
        cfg, nets, "stage1_refine3d"))
    return cfg, RefineFrames(cfg, frames)


def refine3d_refiner(cfg, flag, data, dev):
    """The Refiner3D of the selector `flag` on `refine3d_setup`'s config,
    at REFINE3D_VOXEL and REFINE3D_CAPACITY, training on `data`."""
    return refiner3d.Refiner3D(
        cfg.replace(**{flag: True}), train_dataset=data,
        voxel_size=REFINE3D_VOXEL, capacity=REFINE3D_CAPACITY, device=dev)


def refine3d_phase(dev, tmp):
    """Step 7b, the sparse-3D refiner (BASELINE config 4's stage 1:
    ResNet-18, 640x192, batch 4, frozen; the voxel nets at 0.5 m and 16384
    voxels a sample): the forward kernels on the calls of a batch-4 step
    (through the Shallow net's Refiner3D), then for each net the voxel
    tables built on the card against the CPU's, a whole batch-2 step
    through the kernels against all-plain and float64 (`hold_step`: the
    loss and every voxel-net leaf, on the kernel step's voxel tables,
    `fixed_voxel_tables`), and Refiner3D.train() over 12 frames
    (3 steps at batch 4) with the counts set to 0 before and read after,
    every forward kernel launched, stage 1 unchanged; the U-Net's step
    timed against all-plain, with its peak memory."""
    t0 = time.perf_counter()
    cfg, data = refine3d_setup(tmp, REFINE_FRAMES)
    err, launches, ktimes, unique = {}, {}, None, None
    for flag in REFINE3D_NETS:
        r = refine3d_refiner(cfg, flag, data, dev)
        small = r.put_batch(collate([data[i] for i in range(CHECK_BATCH)]))
        big = r.put_batch(collate([data[i] for i in range(REFINE_BATCH)]))
        if ktimes is None:
            calls = []
            with all_plain(record=calls):
                r.loss(big).backward()
            r.net.zero_grad(set_to_none=True)
            err = check_kernels(calls)
            require(set(err) == set(REFINE3D_KERNELS),
                    f"the refine3d step called {sorted(err)}")
            emit_checks(err, calls, [], "refine3d_batch4")
            ktimes = time_kernels(calls, "refine3d_batch4")
            del calls
            unique = hold_voxel_tables(r, big, dev)

        def grads64():
            r64 = copy.copy(r)
            r64.cfg = r.cfg.replace(compute_dtype="float64")
            r64.stage1 = float64_copy(r.stage1, r64.cfg)
            r64.net = copy.deepcopy(r.net).double()
            loss, grads = refine3d_grads(r64, {k: v.double() for k, v in
                                               small.items()})
            return loss, grads, {}

        with fixed_voxel_tables(CHECK_BATCH):
            hold_step(f"refine3d_{flag}_step_vs_all_plain",
                      lambda b, n: refine3d_grads(r, b), small, None,
                      grads64, REFINE3D_KERNELS)
        r.net.zero_grad(set_to_none=True)

        s1 = {n: v.clone() for n, v in r.stage1.state_dict().items()}
        before = {n: p.detach().clone() for n, p in r.net.named_parameters()}
        torch.cuda.synchronize()
        reset_launches()
        t = time.perf_counter()
        r.train()
        torch.cuda.synchronize()
        launches[flag] = dict(LAUNCHES)
        moved = sum(not torch.equal(p, before[n])
                    for n, p in r.net.named_parameters())
        emit(phase="refiner3d_train", net=flag, steps=r.step,
             batch=REFINE_BATCH, seconds=time.perf_counter() - t,
             launches=launches[flag], leaves_moved=moved,
             leaves=len(before))
        require(r.step == REFINE_FRAMES // REFINE_BATCH,
                f"{flag}: {r.step} Refiner3D steps")
        require(moved == len(before), f"{flag}: {len(before) - moved} "
                "voxel-net leaves did not move")
        require(all(torch.equal(v, s1[n])
                    for n, v in r.stage1.state_dict().items()),
                f"{flag}: the frozen stage 1 moved")
        for name in REFINE3D_KERNELS:
            require(launches[flag][name] > 0, f"refine3d {flag}: kernel "
                    f"{name} was never launched")
        loss = float(r.run_step(big, on_device=True))
        require(np.isfinite(loss), f"{flag}: loss {loss}")
        disp = r.infer(big)
        require(tuple(disp.shape) == (REFINE_BATCH, HEIGHT, WIDTH) and bool(
            ((disp >= 1e-4) & (disp <= 1.0)).all()),
            f"{flag}: refined disparity {tuple(disp.shape)} outside "
            "[1e-4, 1]")
        if flag == "refineUnet":
            torch.cuda.reset_peak_memory_stats()

            def plain_step():
                with all_plain():
                    r.run_step(big, on_device=True)

            step_ms, plain_ms = paired_ms(
                lambda: r.run_step(big, on_device=True), plain_step, iters=3,
                warmup=1)
            emit(timing="refine3d_unet_step", batch=REFINE_BATCH, ms=step_ms,
                 plain_ms=plain_ms,
                 samples_per_s=REFINE_BATCH / step_ms * 1e3,
                 peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30,
                 unique_voxels_frame0=unique, capacity=REFINE3D_CAPACITY,
                 card=card_line())
    emit(phase="refine3d", seconds=time.perf_counter() - t0)
    return err, launches, ktimes


class CompletionFrames(SmokeFrames):
    """Synthetic completion frames at 352 x 1216, each with a dense
    ground-truth depth map in metres (for validate)."""

    def __init__(self, cfg: Config, n: int):
        super().__init__(cfg, n)
        rng = np.random.default_rng(8)
        self.gt = rng.uniform(2.0, 60.0, (n, cfg.height, cfg.width)).astype(
            np.float32)

    def __getitem__(self, i):
        return {**self.inner[i], "depth_gt": self.gt[i]}


# the cotangent argument of each backward kernel's wrapper
COTANGENT_ARG = {"maxpool3x3s2_bwd": 2, "conv3x3_dgrad": 0,
                 "conv3x3_wgrad": 0, "warp_bwd": 3, "reproj_bwd": 2}


def unit_cotangents(calls, dev):
    """The backward calls of `calls` with each cotangent replaced by
    N(0, 1) draws of its shape. A step's own cotangents are of the order
    of 1 / (pixels x batch), ~1e-9 at 352 x 1216, where the absolute
    terms of CONV_TOL and REPROJ_BWD_TOL would see no error; at unit
    scale the same tolerances hold the kernels to fp32 accuracy."""
    g = torch.Generator(device=dev).manual_seed(9)
    out = []
    for name, args, kwargs in calls:
        if base_name(name) in COTANGENT_ARG:
            args = list(args)
            i = COTANGENT_ARG[base_name(name)]
            args[i] = torch.randn(args[i].shape, generator=g,
                                  device=dev).to(args[i].dtype)
            out.append((name, args, kwargs))
    return out


def check_step_calls(calls, dev, path):
    """`check_kernels` on the calls of one main-path step, then on its
    backward calls again with `unit_cotangents`; returns the larger error
    of the two per kernel."""
    err = check_kernels(calls)
    emit_checks(err, calls, [], path)
    unit = unit_cotangents(calls, dev)
    err_unit = check_kernels(unit)
    emit_checks(err_unit, unit, [], path + "_unit_cotangents")
    return {k: max(e, err_unit.get(k, 0.0)) for k, e in err.items()}


def completion_phase(dev, tmp):
    """Completion (BASELINE config 5: ResNet-50 depth and beam encoders,
    ResNet-18 pose encoders, 352 x 1216, fp32, weights from a seed): every
    kernel on the calls of a batch-4 completion step (the backward ones
    also with unit-scale cotangents), a whole batch-2 step
    against all-plain and float64 (`hold_step`), Completor.run_step over 3
    steps at batch 4 with every kernel launched, validate with the
    best_completion checkpoint saved and reloaded, and the kernels and the
    step timed."""
    H, W = COMPLETION_HW
    cfg = Config(num_layers=50, completion_num_layers=50,
                 completion_pose_num_layers=18, height=H, width=W,
                 batch_size=COMPLETION_BATCH, weights_init="scratch",
                 log_dir=tmp, num_workers=4, log_frequency=1,
                 model_name="smoke_completion", eval_batch_size=1)
    data = SyntheticDataset(cfg, length=COMPLETION_FRAMES, seed=7)
    val = CompletionFrames(cfg, COMPLETION_VAL)
    comp = Completor(cfg, train_dataset=data, val_dataset=val, device=dev)
    cfg = comp.cfg
    require((cfg.height, cfg.width, cfg.num_layers, comp.nets.pose_depth)
            == (H, W, 50, 18), f"completion config {cfg.height}x{cfg.width}"
            f" R{cfg.num_layers}/R{comp.nets.pose_depth}")
    comp.nets.load_state_dict(seeded_weights(cfg, pose_depth=18).state_dict())
    nets = comp.nets
    small = comp.put_batch(collate([data[i] for i in range(CHECK_BATCH)]))
    big = comp.put_batch(collate([data[i] for i in range(COMPLETION_BATCH)]))

    # every kernel on the inputs of a batch-4 step, the main path's
    calls = []
    with all_plain(record=calls):
        completion_loss(cfg, nets, big,
                        noise=step_noise(cfg, COMPLETION_BATCH, dev)
                        )[0].backward()
    nets.zero_grad(set_to_none=True)
    err = check_step_calls(calls, dev, "completion_batch4")
    require(set(err) == set(COMPLETION_KERNELS),
            f"the completion step called {sorted(err)}")
    ktimes = time_kernels(calls, "completion_batch4", iters=5)
    del calls

    # a whole batch-2 step through the kernels against all-plain, both
    # held against an all-plain float64 step of the same weights
    noise = step_noise(cfg, CHECK_BATCH, dev)

    def grads64():
        cfg64 = cfg.replace(compute_dtype="float64")
        ref = copy.deepcopy(nets).double()
        ref.cfg = cfg64
        scales = {}
        with summand_scales(ref, scales):
            loss, grads = step_grads(
                cfg64, ref, {k: v.double() for k, v in small.items()},
                [n.double() for n in noise], completion_loss)
        return loss, grads, scales

    hold_step("completion_step_vs_all_plain",
              lambda b, n: step_grads(cfg, nets, b, n, completion_loss),
              small, noise, grads64, COMPLETION_KERNELS)
    nets.zero_grad(set_to_none=True)
    torch.cuda.empty_cache()

    # the entry point: 3 steps at batch 4 through the kernels
    loader = DataLoader(data, COMPLETION_BATCH, shuffle=True, drop_last=True,
                        num_workers=cfg.num_workers)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t = time.perf_counter()
    losses = [float(comp.run_step(db, on_device=True)["loss"])
              for db in prefetch_to_device(loader, comp.put_batch, size=2)]
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    secs = time.perf_counter() - t
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    emit(phase="completor_run_step", steps=len(losses),
         batch=COMPLETION_BATCH, seconds=secs, losses=losses,
         launches=launches, peak_memory_gib=peak_gib)
    require(len(losses) == COMPLETION_FRAMES // COMPLETION_BATCH,
            f"{len(losses)} completion steps")
    require(all(np.isfinite(losses)), f"non-finite losses {losses}")
    for name in COMPLETION_KERNELS:
        require(launches[name] > 0, f"completion: kernel {name} was never "
                "launched")

    # validate: metrics, the best checkpoint, and its reload
    t = time.perf_counter()
    metrics = comp.validate()
    emit(phase="completor_validate", frames=COMPLETION_VAL,
         seconds=time.perf_counter() - t, metrics=metrics)
    require(metrics is not None and set(metrics) == {
        "rmse", "mae", "irmse", "imae"} and all(
        np.isfinite(v) for v in metrics.values()),
        f"completion metrics {metrics}")
    best = os.path.join(tmp, cfg.model_name, "models",
                        "weights_best_completion")
    require(os.path.exists(os.path.join(best, ckpt.MODEL_FILE)),
            f"no best_completion checkpoint at {best}")
    reloaded = Completor(cfg, device=dev)
    reloaded.load(best)
    probe = collate([val[i] for i in range(2)])
    reload_err = float(np.abs(reloaded.predict_depth(probe)
                              - comp.predict_depth(probe)).max())
    emit(check="completion_checkpoint_reload", max_abs_err=reload_err)
    require(reload_err <= 1e-6, f"reloaded completor differs by "
            f"{reload_err}")
    del reloaded

    def plain_step():
        with all_plain():
            comp.run_step(big, on_device=True)

    step_ms, plain_ms = paired_ms(lambda: comp.run_step(big, on_device=True),
                                  plain_step, iters=3, warmup=1)
    emit(timing="completion_step", batch=COMPLETION_BATCH, ms=step_ms,
         plain_ms=plain_ms, samples_per_s=COMPLETION_BATCH / step_ms * 1e3,
         plain_samples_per_s=COMPLETION_BATCH / plain_ms * 1e3,
         kernels_ms=sum(r["ms"] for r in ktimes.values()),
         peak_memory_gib=peak_gib, card=card_line())
    launches_remat = completion_remat(comp, data, big, dev)
    return err, launches, ktimes, launches_remat


def completion_remat(comp, data, big, dev):
    """remat on the completion step (BASELINE config 5, batch 4): one step
    of the loss with remat against one without, from the same weights and
    noise, through the kernels: the loss equal within STEP_LOSS_REL, each
    gradient leaf's relative L2 distance within STEP_GRAD_REL, the BN
    running statistics after the step equal. Then Completor.run_step with
    remat over 12 frames (3 steps at batch 4) with the counts set to 0
    before and read after (every kernel must have run), and the peak
    memory and time of one Completor.run_step with and without remat.
    Also prints the memory held between the loss and its backward with and
    without remat, and how far a second step without remat moves the
    gradient leaves (the card's own run-to-run spread). Restores the
    Completor's config and weights."""
    t0 = time.perf_counter()
    nets, base = comp.nets, comp.cfg
    weights = copy.deepcopy(nets.state_dict())
    noise = step_noise(base, COMPLETION_BATCH, dev)

    def one_step(remat):
        """(loss, grads, BN buffers, GiB held between the loss and its
        backward) of one step from `weights`."""
        nets.load_state_dict(weights)
        nets.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        loss, _ = completion_loss(base.replace(remat=remat), nets, big,
                                  noise=noise)
        held = torch.cuda.memory_allocated() / 2**30
        loss.backward()
        return (loss.item(), {n: p.grad.detach().clone()
                              for n, p in nets.named_parameters()},
                {n: b.clone() for n, b in nets.named_buffers()}, held)

    def rel_l2(ga, gb):
        return {n: ((ga[n] - gb[n]).norm() / gb[n].norm().clamp_min(1e-30))
                .item() for n in gb}

    # two steps without remat: how far the card's own summation order
    # (cuDNN's backward) moves a leaf from one run to the next
    l0, g0, b0, held0 = one_step(False)
    floor = max(rel_l2(one_step(False)[1], g0).values())
    l1, g1, b1, held1 = one_step(True)
    require(g0.keys() == g1.keys(), "remat changed the gradient leaves")
    dist = rel_l2(g1, g0)
    worst = max(dist, key=dist.get)
    loss_rel = abs(l1 - l0) / abs(l0)
    stats_equal = all(torch.equal(b1[n], b) for n, b in b0.items())
    emit(check="completion_remat_vs_no_remat", batch=COMPLETION_BATCH,
         loss=l1, loss_rel_diff=loss_rel, leaves=len(dist),
         worst_grad_rel_l2=dist[worst], worst_leaf=worst,
         no_remat_rerun_worst_grad_rel_l2=floor,
         bit_equal_leaves=sum(torch.equal(g1[n], g0[n]) for n in g0),
         bn_stats_equal=stats_equal, held_after_loss_gib=held1,
         held_after_loss_gib_no_remat=held0,
         tol=[STEP_LOSS_REL, STEP_GRAD_REL])
    require(loss_rel <= STEP_LOSS_REL, f"remat loss differs by {loss_rel}")
    require(dist[worst] <= STEP_GRAD_REL,
            f"remat gradient {worst} differs by {dist[worst]}")
    require(stats_equal, "remat moved the BN statistics otherwise")
    del g0, g1
    nets.zero_grad(set_to_none=True)

    # the entry point with remat: 3 steps at batch 4
    nets.load_state_dict(weights)
    comp.cfg = base.replace(remat=True)
    loader = DataLoader(data, COMPLETION_BATCH, shuffle=True, drop_last=True,
                        num_workers=base.num_workers)
    torch.cuda.synchronize()
    reset_launches()
    losses = [float(comp.run_step(db, on_device=True)["loss"])
              for db in prefetch_to_device(loader, comp.put_batch, size=2)]
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    require(len(losses) == COMPLETION_FRAMES // COMPLETION_BATCH
            and all(np.isfinite(losses)), f"remat losses {losses}")
    for name in COMPLETION_KERNELS:
        require(launches[name] > 0, f"completion remat: kernel {name} was "
                "never launched")

    peak, ms = {}, {}
    for remat in (False, True):
        comp.cfg = base.replace(remat=remat)
        nets.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        comp.run_step(big, on_device=True)
        torch.cuda.synchronize()
        peak[remat] = torch.cuda.max_memory_allocated() / 2**30

    def step(remat):
        def run():
            comp.cfg = base.replace(remat=remat)
            comp.run_step(big, on_device=True)
        return run

    ms[True], ms[False] = paired_ms(step(True), step(False), iters=3,
                                    warmup=1)
    comp.cfg = base
    nets.load_state_dict(weights)
    emit(phase="completor_remat_run_step", steps=len(losses),
         batch=COMPLETION_BATCH, losses=losses, launches=launches,
         peak_memory_gib=peak[True], peak_memory_gib_no_remat=peak[False],
         ms=ms[True], ms_no_remat=ms[False],
         seconds=time.perf_counter() - t0, card=card_line())
    return launches


def completion_variant_step(dev, tmp):
    """One completion step (BASELINE config 5's widths: ResNet-50 depth
    and beam encoders, ResNet-18 pose nets, 352 x 1216) with the stage-1
    variants `COMPLETION_VARIANT` on seeded weights, at batch 2: every
    kernel on its calls (the backward ones also with unit-scale
    cotangents), then one Completor.run_step through the kernels with
    every kernel launched."""
    t0 = time.perf_counter()
    H, W = COMPLETION_HW
    cfg = Config(num_layers=50, completion_num_layers=50,
                 completion_pose_num_layers=18, height=H, width=W,
                 batch_size=CHECK_BATCH, weights_init="scratch",
                 log_dir=tmp, model_name="smoke_completion_variant",
                 **COMPLETION_VARIANT)
    comp = Completor(cfg, device=dev)
    comp.nets.load_state_dict(seeded_weights(comp.cfg,
                                             pose_depth=18).state_dict())
    data = SyntheticDataset(comp.cfg, length=CHECK_BATCH, seed=11)
    batch = comp.put_batch(collate([data[i] for i in range(CHECK_BATCH)]))
    calls = []
    with all_plain(record=calls):
        completion_loss(comp.cfg, comp.nets, batch)[0].backward()
    comp.nets.zero_grad(set_to_none=True)
    err = check_step_calls(calls, dev, "completion_variant_batch2")
    require(set(err) == set(COMPLETION_KERNELS),
            f"the completion variant step called {sorted(err)}")
    del calls
    torch.cuda.synchronize()
    reset_launches()
    loss = float(comp.run_step(batch, on_device=True)["loss"])
    launches = dict(LAUNCHES)
    emit(phase="completor_variant_run_step", flags=COMPLETION_VARIANT,
         batch=CHECK_BATCH, loss=loss, launches=launches,
         seconds=time.perf_counter() - t0)
    require(np.isfinite(loss), f"completion variant loss {loss}")
    for name in COMPLETION_KERNELS:
        require(launches[name] > 0, f"completion variant: kernel {name} "
                "was never launched")
    return err, launches


def variant_checks(name, cfg, trainer, data, dev):
    """Configuration `name` held like the train step: every kernel on the
    calls of a batch-2 and a batch-12 step (the backward ones also with
    unit-scale cotangents), a whole batch-2 step against all-plain and
    float64 (`hold_step`), on seeded weights. Returns the errors and the
    batch-12 step's calls."""
    trainer.nets.load_state_dict(seeded_weights(cfg).state_dict())
    nets = trainer.nets
    small = trainer.put_batch(collate([data[i] for i in range(CHECK_BATCH)]))
    big = trainer.put_batch(collate([data[i] for i in range(TRAIN_BATCH)]))
    noise = step_noise(cfg, CHECK_BATCH, dev)
    calls, calls_big = [], []
    with all_plain(record=calls):
        loss_fn(cfg, nets, small, noise=noise)[0].backward()
    with all_plain(record=calls_big):
        loss_fn(cfg, nets, big)[0].backward()
    nets.zero_grad(set_to_none=True)
    err = check_step_calls(calls + calls_big, dev, f"variant_{name}")
    require(set(err) == set(TRAIN_KERNELS),
            f"variant {name}: the step called {sorted(err)}")
    del calls

    def grads64():
        cfg64 = cfg.replace(compute_dtype="float64")
        ref = copy.deepcopy(nets).double()
        ref.cfg = cfg64
        scales = {}
        with summand_scales(ref, scales):
            loss, grads = step_grads(cfg64, ref, {k: v.double() for k, v in
                                                  small.items()},
                                     [n.double() for n in noise])
        return loss, grads, scales

    hold_step(f"variant_{name}_step_vs_all_plain",
              lambda b, n: step_grads(cfg, nets, b, n), small, noise,
              grads64, TRAIN_KERNELS)
    nets.zero_grad(set_to_none=True)
    return err, calls_big, big


def variant_evaluate(dev, tmp, weights, tree_frames):
    """evaluate over the GDC drive's frames through the forward kernels
    with visualize and per_semantic (over mask PNGs written here), then
    with eval_split="benchmark"; checks the files each writes and the
    per-class table."""
    import cv2

    from fusiondepth_torch.training import eval_driver

    n = len(tree_frames)
    masks = os.path.join(tmp, "semantic_masks")
    os.makedirs(masks, exist_ok=True)
    rng = np.random.default_rng(12)
    for i in range(n):
        cv2.imwrite(os.path.join(masks, f"pred_mask{i}.png"), rng.integers(
            0, eval_driver.SEMANTIC_CLASSES, NATIVE).astype(np.uint8))
    log = os.path.join(tmp, "variants_eval")
    cfg = Config(num_layers=18, height=HEIGHT, width=WIDTH,
                 weights_init="scratch", eval_batch_size=1, log_dir=log,
                 data_path=tree_frames.root, load_weights_folder=weights,
                 visualize=True, per_semantic=True,
                 semantic_mask_path=masks)
    tables = []
    per_semantic = eval_driver.evaluate_per_semantic
    eval_driver.evaluate_per_semantic = \
        lambda *a: tables.append(per_semantic(*a)) or tables[-1]
    try:
        reset_launches()
        t = time.perf_counter()
        metrics = evaluate(cfg, tree_frames, device=dev)
        secs = time.perf_counter() - t
        launches = dict(LAUNCHES)
    finally:
        eval_driver.evaluate_per_semantic = per_semantic
    vis = [cv2.imread(os.path.join(log, "visualization", f"{i}depth.png"))
           for i in range(n)]
    require(all(v is not None and v.shape == (HEIGHT, WIDTH, 3)
                for v in vis), "evaluate wrote no visualization")
    require(len(tables) == 1 and tables[0].shape == (
        eval_driver.SEMANTIC_CLASSES, 7) and bool(np.isfinite(
            tables[0]).all()) and np.count_nonzero(tables[0][:, 0]) > 0,
        "evaluate made no per-semantic table")
    require(metrics is not None and all(np.isfinite(v)
                                        for v in metrics.values()),
            f"evaluate: {metrics}")
    for k in FORWARD_KERNELS:
        require(launches[k] > 0, f"evaluate launched no {k}")
    reset_launches()
    bench = evaluate(cfg.replace(eval_split="benchmark", visualize=False,
                                 per_semantic=False), tree_frames,
                     device=dev)
    bench_launches = dict(LAUNCHES)
    pngs = [cv2.imread(os.path.join(log, "benchmark_predictions",
                                    f"{i:010d}.png"), cv2.IMREAD_UNCHANGED)
            for i in range(n)]
    require(bench is None and all(
        p is not None and p.dtype == np.uint16 and p.shape == (352, 1216)
        for p in pngs), "evaluate wrote no benchmark PNGs")
    require(bench_launches["conv3x3_reflect"] > 0,
            "the benchmark export ran no kernel")
    emit(phase="evaluate", mode="visualize+per_semantic", frames=n,
         seconds=secs, metrics=metrics, launches=launches,
         classes_with_pixels=int(np.count_nonzero(tables[0][:, 0])))
    emit(phase="evaluate", mode="benchmark", frames=n,
         pngs=[list(p.shape) for p in pngs],
         max_depth_m=float(max(p.max() for p in pngs)) / 256.0,
         launches=bench_launches)


def variants_phase(dev, tmp, weights, tree_frames):
    """The stage-1 training variants (`VARIANTS`: ResNet-18, 640x192,
    fp32). A and B: `variant_checks` on seeded weights, then
    Trainer.run_epoch over 36 frames (3 steps at batch 12) with the counts
    set to 0 before and read after (every training kernel must have run,
    the losses be finite), then each kernel's calls of the batch-12 step
    and the step timed against all-plain. C: the run_epoch only. Then
    `variant_evaluate`. Returns the errors, launches and timings of A and
    B and the launches of C."""
    errs, launches, times = [], {}, {}
    for name, flags in VARIANTS.items():
        cfg = Config(num_layers=18, height=HEIGHT, width=WIDTH,
                     batch_size=TRAIN_BATCH, weights_init="scratch",
                     log_dir=tmp, num_workers=4, log_frequency=1,
                     model_name=f"smoke_variant_{name}", **flags)
        data = SyntheticDataset(cfg, length=TRAIN_FRAMES, seed=10)
        trainer = Trainer(cfg, train_dataset=data, device=dev)
        require(trainer.cfg.frame_ids == cfg.frame_ids,
                f"variant {name}: frames {trainer.cfg.frame_ids}")
        if name in HELD_VARIANTS:
            err, calls, big = variant_checks(name, cfg, trainer, data, dev)
            errs.append(err)
        torch.cuda.synchronize()
        reset_launches()
        t = time.perf_counter()
        losses = [float(x) for x in trainer.run_epoch()]
        torch.cuda.synchronize()
        launches[name] = dict(LAUNCHES)
        emit(phase="variant_run_epoch", variant=name, flags=flags,
             steps=len(losses), batch=TRAIN_BATCH,
             seconds=time.perf_counter() - t, losses=losses,
             launches=launches[name])
        require(len(losses) == TRAIN_FRAMES // TRAIN_BATCH,
                f"variant {name}: {len(losses)} steps")
        require(all(np.isfinite(losses)),
                f"variant {name}: non-finite losses {losses}")
        for k in TRAIN_KERNELS:
            require(launches[name][k] > 0,
                    f"variant {name}: kernel {k} was never launched")
        if name not in HELD_VARIANTS:
            continue
        times[name] = time_kernels(calls, f"variant_{name}_batch12",
                                   iters=5)
        del calls

        def plain_step():
            with all_plain():
                trainer.run_step(big, on_device=True)

        step_ms, plain_ms = paired_ms(
            lambda: trainer.run_step(big, on_device=True), plain_step,
            iters=3, warmup=1)
        emit(timing="variant_step", variant=name, batch=TRAIN_BATCH,
             ms=step_ms, plain_ms=plain_ms,
             samples_per_s=TRAIN_BATCH / step_ms * 1e3,
             plain_samples_per_s=TRAIN_BATCH / plain_ms * 1e3,
             kernels_ms=sum(r["ms"] for r in times[name].values()))
        del trainer, big
    variant_evaluate(dev, tmp, weights, tree_frames)
    return errs, launches, times


def float64_copy(nets: FusionNets, cfg64: Config) -> FusionNets:
    """A float64 copy of `nets` that also computes in float64 (a bf16
    bundle's modules carry their compute dtype; the copy drops it)."""
    ref = copy.deepcopy(nets).double()
    ref.cfg = cfg64
    for m in ref.modules():
        if hasattr(m, "compute_dtype"):
            m.compute_dtype = None
    return ref


def bf16_phase(dev, tmp):
    """Step 10: compute_dtype="bfloat16". Serving (ResNet-18, 640x192,
    seeded weights loaded as a checkpoint): the bf16 forward kernels on the
    calls of a batch-1 forward, Infer.run_split at batch 1 and
    predict_disparities with the flip at batch 4 (counts set to 0 before
    each, every bf16 forward kernel launched), the batch-4 forward through
    the kernels against all-plain (FORWARD_ATOL_BF16) and its fps at batch
    1 and 4. Training (BASELINE config 3 in bf16): every bf16 kernel on
    the calls of a batch-2 step; the whole batch-2 step against all-plain
    and float64 (`hold_step` with the bf16 bounds); Trainer.run_epoch over
    36 frames (3 steps at batch 12, every bf16 training kernel launched,
    finite losses, the parameters, BN statistics and Adam state float32);
    the calls of a batch-12 step held (also with unit cotangents) and
    timed; the step through the kernels against all-plain, and its peak
    memory. Returns (errors, launches, bf16 kernel timings)."""
    errs, launches = [], {}
    cfg = Config(num_layers=18, height=HEIGHT, width=WIDTH,
                 weights_init="scratch", eval_batch_size=1, log_dir=tmp,
                 compute_dtype="bfloat16")
    cfg = cfg.replace(load_weights_folder=ckpt.save_checkpoint(
        cfg, seeded_weights(cfg), "smoke_bf16"))
    frames = SmokeFrames(cfg, FRAMES)
    infer = Infer(cfg, device=dev)
    nets = infer.nets
    one = device_batch(collate([frames[0]]), dev)
    four = device_batch(collate([frames[i] for i in range(4)]), dev)
    calls = []
    with torch.no_grad():
        with all_plain(record=calls):
            nets.forward_depth(one)
    require({c[0] for c in calls} == set(BF16_FORWARD_KERNELS),
            f"bf16 forward recorded {sorted({c[0] for c in calls})}")
    err = check_kernels(calls)
    errs.append(err)
    emit_checks(err, calls, [], "infer_bf16")

    with tempfile.TemporaryDirectory() as out:
        reset_launches()
        t = time.perf_counter()
        n = infer.run_split(frames, out)
        torch.cuda.synchronize()
        launches["infer_bf16"] = dict(LAUNCHES)
        emit(phase="infer_run_split_bf16", frames=n,
             seconds=time.perf_counter() - t, launches=launches["infer_bf16"])
        for i in range(FRAMES):
            folder, idx, side = frames.parse_line(i)
            d = np.load(os.path.join(out, folder, infer.out_folder(),
                                     f"{idx}_{side}.npy"))
            require(d.shape == (1, 1, HEIGHT, WIDTH) and
                    d.dtype == np.float32 and bool(np.isfinite(d).all())
                    and bool(((d > 0) & (d < 1)).all()),
                    f"bf16 frame {i}: {d.shape} {d.dtype}")
    reset_launches()
    t = time.perf_counter()
    disps, _ = predict_disparities(
        cfg.replace(eval_batch_size=4, post_process=True), frames,
        device=dev)
    torch.cuda.synchronize()
    launches["predict_bf16"] = dict(LAUNCHES)
    emit(phase="predict_disparities_bf16", frames=len(disps),
         seconds=time.perf_counter() - t, launches=launches["predict_bf16"])
    require(len(disps) == FRAMES and all(
        d.dtype == np.float32 and bool(np.isfinite(d).all()) for d in disps),
        "bf16 predicted disparities")
    for path in ("infer_bf16", "predict_bf16"):
        for name in BF16_FORWARD_KERNELS:
            require(launches[path][name] > 0,
                    f"{path}: kernel {name} was never launched")
    with torch.no_grad():
        got = nets.forward_depth(four)[0]
        with all_plain():
            want = nets.forward_depth(four)[0]
        fwd_err = max((got[k].float() - want[k].float()).abs().max().item()
                      for k in want)
        emit(check="forward_vs_all_plain_bf16", batch=4,
             max_abs_err=fwd_err, atol=FORWARD_ATOL_BF16)
        require(fwd_err <= FORWARD_ATOL_BF16, f"bf16 forward differs from "
                f"all-plain by {fwd_err}")
        card = card_line()
        for label, b, bs in (("batch1", one, 1), ("batch4", four, 4)):
            def run_plain():
                with all_plain():
                    nets.forward_depth(b)
            k, p = paired_ms(lambda: nets.forward_depth(b), run_plain,
                             iters=10)
            emit(timing="forward_depth_bf16", batch=label, ms=k, plain_ms=p,
                 fps=bs / k * 1e3, plain_fps=bs / p * 1e3, card=card)
    del infer, nets

    cfg = Config(num_layers=18, height=HEIGHT, width=WIDTH,
                 batch_size=TRAIN_BATCH, weights_init="scratch",
                 log_dir=tmp, num_workers=4, log_frequency=1,
                 model_name="smoke_train_bf16", compute_dtype="bfloat16")
    data = SyntheticDataset(cfg, length=TRAIN_FRAMES, seed=2)
    nets = seeded_weights(cfg).to(dev)
    small = device_batch(collate([data[i] for i in range(CHECK_BATCH)]),
                         dev, TRAIN_KEYS)
    noise = step_noise(cfg, CHECK_BATCH, dev)
    calls = []
    with all_plain(record=calls):
        loss_fn(cfg, nets, small, noise=noise)[0].backward()
    nets.zero_grad(set_to_none=True)
    require({c[0] for c in calls} == set(BF16_TRAIN_KERNELS),
            f"bf16 step recorded {sorted({c[0] for c in calls})}")
    err = check_kernels(calls)
    errs.append(err)
    emit_checks(err, calls, [], "train_bf16")
    del calls

    def grads64():
        cfg64 = cfg.replace(compute_dtype="float64")
        ref = float64_copy(nets, cfg64)
        scales = {}
        with summand_scales(ref, scales):
            loss, grads = step_grads(cfg64, ref, {k: v.double() for k, v in
                                                  small.items()},
                                     [n.double() for n in noise])
        return loss, grads, scales

    hold_step("train_step_bf16_vs_all_plain",
              lambda b, n: step_grads(cfg, nets, b, n), small, noise,
              grads64, BF16_TRAIN_KERNELS, loss_rel=STEP_LOSS_REL_BF16,
              cap=STEP_GRAD_CAP_BF16, nudge=nudged_bf16)
    del nets

    trainer = Trainer(cfg, train_dataset=data, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t = time.perf_counter()
    losses = [float(x) for x in trainer.run_epoch()]
    torch.cuda.synchronize()
    launches["train_bf16"] = dict(LAUNCHES)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    emit(phase="trainer_run_epoch_bf16", steps=len(losses),
         batch=TRAIN_BATCH, seconds=time.perf_counter() - t, losses=losses,
         launches=launches["train_bf16"], peak_memory_gib=peak_gib)
    require(len(losses) == TRAIN_FRAMES // TRAIN_BATCH and
            all(np.isfinite(losses)), f"bf16 losses {losses}")
    for name in BF16_TRAIN_KERNELS:
        require(launches["train_bf16"][name] > 0,
                f"train_bf16: kernel {name} was never launched")
    state = [s for st in trainer.optimizer.state.values()
             for s in st.values() if torch.is_tensor(s) and
             s.is_floating_point()]
    require(all(p.dtype == torch.float32 for p in trainer.nets.parameters())
            and all(b.dtype == torch.float32 for b in trainer.nets.buffers())
            and all(s.dtype == torch.float32 for s in state),
            "bf16 training: parameters, BN statistics or Adam state not "
            "float32")

    big = trainer.put_batch(collate([data[i] for i in range(TRAIN_BATCH)]))
    calls = []
    with all_plain(record=calls):
        loss_fn(cfg, trainer.nets, big)[0].backward()
    trainer.nets.zero_grad(set_to_none=True)
    errs.append(check_step_calls(calls, dev, "train_bf16_batch12"))
    ktimes = time_kernels(calls, "train_bf16_batch12")
    del calls

    def kernel_step():
        trainer.run_step(big, on_device=True)

    def plain_step():
        with all_plain():
            trainer.run_step(big, on_device=True)

    step_ms, plain_step_ms = paired_ms(kernel_step, plain_step, iters=3,
                                       warmup=1)
    emit(timing="train_step_bf16", batch=TRAIN_BATCH, ms=step_ms,
         plain_ms=plain_step_ms, samples_per_s=TRAIN_BATCH / step_ms * 1e3,
         plain_samples_per_s=TRAIN_BATCH / plain_step_ms * 1e3,
         kernels_ms=sum(ktimes[k]["ms"] for k in BF16_TRAIN_KERNELS),
         peak_memory_gib=peak_gib, card=card)
    return errs, launches, {k: ktimes[k] for k in BF16_TRAIN_KERNELS}


def free_port() -> int:
    """A free TCP port on localhost, for a process group's coordinator."""
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def ddp_phase(dev, tmp):
    """Step 11: data parallelism (BASELINE config 3 over ranks). A gloo
    world of DDP_WORLD ranks, all on `dev` (NCCL refuses two ranks on one
    card), runs one Trainer step (use_mesh) each on its TRAIN_BATCH /
    DDP_WORLD rows of a batch-12 global batch through every training
    kernel (`multichip.step_rank`), in fp32 and then in bf16; each rank's
    launches counted around its step, every kernel required on every rank,
    the ranks' parameters and statistics equal after it. Each world is
    held against the single-process batch-12 step through the kernels on
    the same weights and noise: the loss within STEP_LOSS_REL
    (STEP_LOSS_REL_BF16), each all-reduced gradient leaf against a float64
    step as `hold_step` holds it (the noise of 1 + NOISE_STEPS
    single-process steps, STEP_GRAD_CAP, in bf16 no cap), the parameters
    after the step equal to Adam's step from that gradient (torch's Adam
    in this process, bit for bit), and the BN running statistics after the
    step within STEP_GRAD_REL (BF16_ROUND) of the single process's. Each world then times
    DDP_TIME_STEPS more steps and gradient all-reduces. Last, an NCCL
    world of one, brought up as the trainer CLI does
    (`maybe_initialize_distributed` with a coordinator on localhost),
    drives Trainer(use_mesh=True).run_epoch over 36 frames (3 steps at
    batch 12, counts set to 0 before and read after, every kernel
    required) and times a step. Returns (launches by path, readings)."""
    launches, readings = {}, {}
    card = card_line()
    for dtype, tag in (("float32", "fp32"), ("bfloat16", "bf16")):
        kw = dict(num_layers=18, height=HEIGHT, width=WIDTH,
                  batch_size=TRAIN_BATCH, weights_init="scratch",
                  log_dir=tmp, model_name=f"smoke_ddp_{tag}",
                  compute_dtype=dtype)
        cfg = Config(**kw)
        bf16 = dtype == "bfloat16"
        kernels = BF16_TRAIN_KERNELS if bf16 else TRAIN_KERNELS
        data = SyntheticDataset(cfg, length=TRAIN_BATCH, seed=2)
        host = collate([data[i] for i in range(TRAIN_BATCH)])
        nets = seeded_weights(cfg)
        noise = step_noise(cfg, TRAIN_BATCH, "cpu")
        spec = os.path.join(tmp, f"ddp_{tag}.pt")
        torch.save(dict(cfg=kw, weights=nets.state_dict(), batch=host,
                        noise=noise, time_steps=DDP_TIME_STEPS), spec)
        t = time.perf_counter()
        ranks = multichip.spawn(DDP_WORLD, multichip.step_rank, (spec,),
                                device=str(dev), backend="gloo")
        world_s = time.perf_counter() - t
        launches[f"ddp_{tag}"] = [r["launches"] for r in ranks]
        for i, r in enumerate(ranks):
            missed = [k for k in kernels if not r["launches"][k]]
            require(not missed, f"ddp {tag}: rank {i} launched no {missed}")
        for k, v in ranks[0]["state"].items():
            require(torch.equal(v, ranks[1]["state"][k]),
                    f"ddp {tag}: the ranks' {k} differ after the step")

        # the single-process step on the same weights, batch and noise
        nets = nets.to(dev)
        big = device_batch(host, dev, TRAIN_KEYS, model_dtype(cfg))
        noise = [n.to(dev) for n in noise]
        ref = copy.deepcopy(nets)
        opt, sched = make_optimizer(cfg, ref, 1000)
        loss_s = float(train_step(cfg, ref, opt, sched, big,
                                  noise=noise)["loss"])
        grads_s = {n: p.grad.detach().clone()
                   for n, p in ref.named_parameters() if p.grad is not None}
        nudge = nudged_bf16 if bf16 else nudged
        noisy = [grads_s] + [step_grads(cfg, nets, nudge(big, s), noise)[1]
                             for s in range(NOISE_STEPS)]
        cfg64 = cfg.replace(compute_dtype="float64")
        ref64, scales = float64_copy(nets, cfg64), {}
        with all_plain(), summand_scales(ref64, scales):
            loss_r, grads_r = step_grads(
                cfg64, ref64, {k: v.double() for k, v in big.items()},
                [n.double() for n in noise])
        del ref64

        got = ranks[0]
        loss_rel = abs(got["loss"] - loss_s) / abs(loss_s)
        cap = STEP_GRAD_CAP_BF16 if bf16 else STEP_GRAD_CAP
        grad_rows = []
        for n, g64 in grads_r.items():
            r = g64.norm()
            if n in scales:
                r = torch.maximum(r, scales[n].norm())
            r = r.clamp_min(1e-30)

            def to_f64(g):
                return ((g.to(dev).double() - g64).norm() / r).item()

            noise_n = max(to_f64(g[n]) for g in noisy)
            limit = max(STEP_GRAD_REL, STEP_NOISE_X * noise_n if cap is None
                        else min(STEP_NOISE_X * noise_n, cap))
            grad_rows.append(dict(leaf=n, ddp=to_f64(got["grads"][n]),
                                  single=to_f64(grads_s[n]), noise=noise_n,
                                  limit=limit))
        # Adam's step from the all-reduced gradient, in this process
        adam = copy.deepcopy(nets)
        for n, p in adam.named_parameters():
            p.grad = got["grads"][n].to(dev) if n in got["grads"] else None
        opt, sched = make_optimizer(cfg, adam, 1000)
        opt.step()
        adam_diff = max((p.detach().cpu() - got["state"][n]).abs().max()
                        .item() for n, p in adam.named_parameters())
        del adam
        stats_tol = BF16_ROUND if bf16 else STEP_GRAD_REL
        state_s = ref.state_dict()
        stats_rel = max(
            ((got["state"][k].to(dev) - state_s[k]).norm()
             / state_s[k].norm().clamp_min(1e-30)).item()
            for k in state_s if "running_" in k)
        bad_g = [row for row in grad_rows if row["ddp"] > row["limit"]]
        worst_g = max(grad_rows, key=lambda row: row["ddp"] / row["limit"])
        emit(check=f"ddp_step_{tag}_vs_single_process", world=DDP_WORLD,
             backend="gloo", batch=TRAIN_BATCH, loss=got["loss"],
             loss_single=loss_s, loss_rel_diff=loss_rel,
             loss_f64=loss_r, leaves=len(grad_rows),
             worst_grad_leaf=worst_g["leaf"], its_ddp_vs_f64=worst_g["ddp"],
             its_single_vs_f64=worst_g["single"], its_limit=worst_g["limit"],
             params_vs_adam_of_its_gradient=adam_diff,
             bn_stats_max_rel_diff=stats_rel,
             tol=[STEP_LOSS_REL_BF16 if bf16 else STEP_LOSS_REL,
                  STEP_GRAD_REL, STEP_NOISE_X, cap, stats_tol])
        require(loss_rel <= (STEP_LOSS_REL_BF16 if bf16 else STEP_LOSS_REL),
                f"ddp {tag}: loss differs from one process by {loss_rel}")
        require(not bad_g, f"ddp {tag}: gradient leaves off float64 beyond "
                f"one process's noise: {bad_g[:5]}")
        require(adam_diff == 0.0, f"ddp {tag}: the parameters after the "
                f"step are {adam_diff} off Adam's step from its gradient")
        require(stats_rel <= stats_tol, f"ddp {tag}: BN statistics differ "
                f"from one process's by {stats_rel}")
        step_ms = float(np.mean([r["step_ms"] for r in ranks]))
        ar_ms = float(np.mean([r["grad_all_reduce_ms"] for r in ranks]))
        readings[f"world2_{tag}"] = dict(step_ms=step_ms,
                                         grad_all_reduce_ms=ar_ms)
        emit(timing=f"ddp_step_{tag}", world=DDP_WORLD, backend="gloo",
             device=str(dev), global_batch=TRAIN_BATCH,
             ms=step_ms, rank_ms=[r["step_ms"] for r in ranks],
             grad_all_reduce_ms=ar_ms, all_reduce_share=ar_ms / step_ms,
             spawn_seconds=world_s, steps=DDP_TIME_STEPS, card=card)
        del nets, ref, noisy, grads_r, grads_s

    # an NCCL world of one through the trainer CLI's bring-up
    cfg = Config(num_layers=18, height=HEIGHT, width=WIDTH,
                 batch_size=TRAIN_BATCH, weights_init="scratch",
                 log_dir=tmp, num_workers=4, log_frequency=1,
                 model_name="smoke_ddp_nccl", use_mesh=True,
                 coordinator_address=f"localhost:{free_port()}",
                 num_processes=1, process_id=0)
    require(maybe_initialize_distributed(cfg), "no process group")
    try:
        require(dist.get_backend() == "nccl", dist.get_backend())
        data = SyntheticDataset(cfg, length=TRAIN_FRAMES, seed=2)
        trainer = Trainer(cfg, train_dataset=data)
        require(trainer.mesh is not None and trainer.mesh.world == 1
                and trainer.device == dev, f"mesh {trainer.mesh}")
        torch.cuda.synchronize()
        reset_launches()
        t = time.perf_counter()
        losses = [float(x) for x in trainer.run_epoch()]
        torch.cuda.synchronize()
        launches["ddp_nccl"] = dict(LAUNCHES)
        emit(phase="trainer_run_epoch_nccl_world_of_one", steps=len(losses),
             batch=TRAIN_BATCH, seconds=time.perf_counter() - t,
             losses=losses, launches=launches["ddp_nccl"])
        require(len(losses) == TRAIN_FRAMES // TRAIN_BATCH
                and all(np.isfinite(losses)), f"nccl losses {losses}")
        for name in TRAIN_KERNELS:
            require(launches["ddp_nccl"][name] > 0,
                    f"ddp_nccl: kernel {name} was never launched")
        big = trainer.put_batch(collate([data[i]
                                         for i in range(TRAIN_BATCH)]))
        ms = cuda_ms(lambda: trainer.run_step(big, on_device=True), iters=3,
                     warmup=1)
        readings["world1_nccl_fp32"] = dict(step_ms=ms)
        emit(timing="ddp_step_fp32", world=1, backend="nccl",
             device=str(dev), global_batch=TRAIN_BATCH, ms=ms, card=card)
    finally:
        dist.destroy_process_group()
    return launches, readings


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU only",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    t0 = time.perf_counter()
    lib = build.build()
    build.load()
    build_s = time.perf_counter() - t0
    emit(phase="build", seconds=build_s, library=lib.name)
    # what ptxas reported for the kernels of PTXAS_KERNELS
    emit(phase="ptxas", kernels=[
        dict(source=SRC + src, **r) for src, names in PTXAS_KERNELS.items()
        for r in build.ptxas_report(src)
        if any(n in r["kernel"] for n in names)])

    errs, launches, times, seconds = [], {}, {}, {}
    clock = [time.perf_counter()]

    def lap(phase):
        now = time.perf_counter()
        seconds[phase] = now - clock[0]
        clock[0] = now

    with tempfile.TemporaryDirectory() as tmp:
        err, launches_infer = infer_phase(dev, tmp)
        errs.append(err)
        lap("infer")
        err, launches["train"], ktimes = train_phase(dev, tmp)
        errs.append(err)
        times.update({k: ktimes[k] for k in TRAIN_KERNELS})
        lap("train")
        # one stage-1 checkpoint of seeded weights for stage 2
        cfg = Config(num_layers=18, height=HEIGHT, width=WIDTH,
                     weights_init="scratch", log_dir=tmp)
        weights = ckpt.save_checkpoint(cfg, seeded_weights(cfg), "stage1")
        err, launches["inf_gdc"], ktimes, frames = gdc_phase(dev, tmp,
                                                             weights)
        errs.append(err)
        times["knn"] = ktimes["knn"]
        lap("inf_gdc")
        err, launches["refiner"] = refine_phase(dev, tmp, weights, frames)
        errs.append(err)
        lap("refiner")
        err, launches["refine_entire"], etimes = refine_entire_phase(
            dev, tmp, weights)
        errs.append(err)
        lap("refine_entire")
        err, launches["refine_variant"] = refine_variant_step(dev, tmp)
        errs.append(err)
        lap("refine_variant")
        err, launches3d, times3d = refine3d_phase(dev, tmp)
        errs.append(err)
        lap("refine3d")
        err, launches["completion"], ctimes, launches["completion_remat"] = \
            completion_phase(dev, tmp)
        errs.append(err)
        lap("completion")
        err, launches["completion_variant"] = completion_variant_step(dev,
                                                                      tmp)
        errs.append(err)
        lap("completion_variant")
        verrs, vlaunches, vtimes = variants_phase(dev, tmp, weights, frames)
        errs.extend(verrs)
        lap("variants")
        berrs, blaunches, btimes = bf16_phase(dev, tmp)
        errs.extend(berrs)
        launches.update(blaunches)
        times.update(btimes)
        lap("bf16")
        dlaunches, _ = ddp_phase(dev, tmp)
        lap("ddp")
    emit(phase_seconds=seconds, build_seconds=build_s,
         total_seconds=time.perf_counter() - t0)
    launches.update(launches_infer)
    card = card_line()
    for name, r in times.items():
        emit(timing=name, per=f"all calls of one {KERNEL_PATH[name]} step "
             "or frame", card=card, **r)
    for name in COMPLETION_KERNELS:
        emit(timing=name, per="all calls of one completion step",
             card=card, **ctimes[name])
    for name in REFINE_ENTIRE_KERNELS:
        emit(timing=name, per="all calls of one train_entire_net refine "
             "step", card=card, **etimes[name])
    for v, vt in vtimes.items():
        for name in TRAIN_KERNELS:
            emit(timing=name, per=f"all calls of one variant {v} step",
                 card=card, **vt[name])

    print(card)
    kernels = []
    for name, (_, _, _, src, tpu) in KERNELS.items():
        r = times[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": tpu,
            "launches": launches[KERNEL_PATH[name]][name],
            "max_abs_err": max(e.get(name, 0.0) for e in errs),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            "library_of_ms": r["library_of_ms"], "tflops": r["tflops"],
            "calls_per_step": r["calls"], "path": KERNEL_PATH[name],
            "launches_by_path": {p: c[name] for p, c in launches.items()}})
        if name in COMPLETION_KERNELS:
            c = ctimes[name]
            kernels[-1]["completion"] = {
                "launches": launches["completion"][name],
                "calls_per_step": c["calls"], "ms": c["ms"],
                "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
                "bound_by": c["bound_by"], "library_ms": c["library_ms"],
                "library_of_ms": c["library_of_ms"], "tflops": c["tflops"]}
        if name in REFINE_ENTIRE_KERNELS:
            c = etimes[name]
            kernels[-1]["refine_entire"] = {
                "launches": launches["refine_entire"][name],
                "calls_per_step": c["calls"], "ms": c["ms"],
                "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
                "bound_by": c["bound_by"], "library_ms": c["library_ms"],
                "library_of_ms": c["library_of_ms"], "tflops": c["tflops"]}
        if name in REFINE3D_KERNELS:
            c = times3d[name]
            kernels[-1]["refine3d"] = {
                "launches": {f: launches3d[f][name] for f in REFINE3D_NETS},
                "calls_per_step": c["calls"], "ms": c["ms"],
                "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
                "bound_by": c["bound_by"], "library_ms": c["library_ms"],
                "library_of_ms": c["library_of_ms"], "tflops": c["tflops"]}
        if name in COMPLETION_KERNELS:
            kernels[-1]["completion_remat"] = {
                "launches": launches["completion_remat"][name]}
        if name in TRAIN_KERNELS:
            kernels[-1]["ddp"] = {
                "world2_gloo_launches": [r[name]
                                         for r in dlaunches["ddp_fp32"]],
                "world1_nccl_launches": dlaunches["ddp_nccl"][name]}
        if name in BF16_TRAIN_KERNELS:
            kernels[-1]["ddp"] = {"world2_gloo_launches": [
                r[name] for r in dlaunches["ddp_bf16"]]}
        if name in BF16_FORWARD_KERNELS:
            kernels[-1]["serving_launches"] = {
                p: launches[p][name] for p in ("infer_bf16", "predict_bf16")}
        if name in TRAIN_KERNELS:
            kernels[-1]["variants"] = {v: {"launches": vlaunches[v][name]}
                                       for v in VARIANTS}
            for v, vt in vtimes.items():
                c = vt[name]
                kernels[-1]["variants"][v].update(
                    calls_per_step=c["calls"], ms=c["ms"],
                    plain_ms=c["plain_ms"], bound_ms=c["bound_ms"],
                    bound_by=c["bound_by"], library_ms=c["library_ms"],
                    library_of_ms=c["library_of_ms"], tflops=c["tflops"])
    next(k for k in kernels if k["name"] == "knn")["cdist_topk_ms"] = \
        times["knn"]["cdist_topk_ms"]
    emit(kernels=kernels)
    emit(ok=True, device={"platform": "gpu",
                          "kind": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
