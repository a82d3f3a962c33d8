"""Typed configuration for all entry points of the port: a copy of the JAX
package's `config.py`, so that the port runs where JAX is not installed.
The TPU layout knobs are accepted and change nothing in the port.

Mirrors the reference's argparse schema (reference options.py:9-480) with the
same flag names and *effective* defaults, but honest booleans: the reference
marks several "enable" flags `action="store_false"` so they default ON
(need_4beam, need_2_channel, beam_encoder, trainer_siloss_all_scale,
gdc_loss_only_on_scale_0, completion_siloss) and uses "true"/"false" strings
for others — here they are all plain bools with the same effective value.

`parse_args` builds the CLI (same flag names; booleans accept
--flag/--no-flag and the legacy true/false string forms).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple


@dataclass
class Config:
    # PATHS
    data_path: str = "kitti_data"
    log_dir: str = "log"

    # TRAINING
    model_name: str = "mdp"
    split: str = "eigen_zhou"
    num_layers: int = 50
    dataset: str = "kitti"
    png: bool = False
    height: int = 192
    width: int = 640
    disparity_smoothness: float = 1e-3
    scales: Tuple[int, ...] = (0, 1, 2, 3)
    min_depth: float = 0.1
    max_depth: float = 100.0
    use_stereo: bool = False
    frame_ids: Tuple[int, ...] = (0, -1, 1)

    # OPTIMIZATION
    batch_size: int = 5
    learning_rate: float = 1e-4
    num_epochs: int = 20
    scheduler_step_size: int = 10

    # ABLATION
    v1_multiscale: bool = False
    avg_reprojection: bool = False
    disable_automasking: bool = False
    predictive_mask: bool = False
    no_ssim: bool = False
    weights_init: str = "pretrained"  # or "scratch"
    # torchvision-format resnet{depth}.pth file or directory; None = torch
    # hub cache (the reference downloads from the model zoo instead,
    # reference networks/resnet_encoder.py:46-49)
    pretrained_weights_path: Optional[str] = None
    pose_model_input: str = "pairs"  # or "all"
    pose_model_type: str = "separate_resnet"  # posecnn|separate_resnet|shared

    # SYSTEM
    num_workers: int = 4
    seed: int = 1

    # LOADING
    load_weights_folder: Optional[str] = None
    train_load_weights_folder: Optional[str] = None
    refine_load_weights_folder: Optional[str] = None
    models_to_load: Tuple[str, ...] = ("encoder", "depth", "pose_encoder", "pose")

    # LOGGING
    log_frequency: int = 250
    save_frequency: int = 1

    # EVALUATION
    eval_stereo: bool = False
    eval_mono: bool = False
    disable_median_scaling: bool = False
    pred_depth_scale_factor: float = 1.0
    ext_disp_to_eval: Optional[str] = None
    eval_split: str = "eigen"
    save_pred_disps: bool = False
    no_eval: bool = False
    post_process: bool = False
    eval_gdc: bool = False
    eval_batch_size: int = 1

    # 4-BEAM / 2-CHANNEL LIDAR
    nbeams: int = 4
    need_4beam: bool = True
    need_full_res_4beam: bool = False
    need_path: bool = False
    cat_4beam_to_color: bool = False
    need_2_channel: bool = True
    cat2start: bool = False
    cat2end: bool = False
    beam_encoder: bool = True
    trainer_siloss: bool = True
    trainer_siloss_all_scale: bool = True
    random_sample: int = -1

    # REFINEMENT (stage 2)
    train_entire_net: bool = False
    refine_shallow: bool = False
    refineUnet: bool = False
    refine_deep: bool = False
    refine_2d: bool = False  # forced True by the refiner (refiner.py:30)
    refine_iter: int = 1
    refine_iter_gama: float = 0.8
    refine_offset: bool = False
    refine_depthnet_with_beam: bool = False
    clone_gdc: bool = False  # forced True by the refiner (refiner.py:29)
    clone_path: Optional[str] = None
    need_inf_gdc: bool = False
    catxy: bool = True
    refine2d_deep: bool = True
    refine_a0: bool = True
    gdc_loss_threshold: float = 2.0
    gdc_loss_weight: float = 0.008
    gdc_loss_only_on_scale_0: bool = True
    gdc_abs_loss: float = 0.0
    si_var: float = 0.3

    # COMPLETION
    completion_val: str = "select"
    completion_siloss_weight: float = 0.1
    completion_siloss_all_scale: bool = False
    completion_eigen_crop: bool = False
    completion_num_epochs: int = 3
    completion_scheduler_step_size: int = 25
    completion_not_full_res: bool = False
    completion_amp: bool = False
    completion_pose_num_layers: int = 18
    completion_siloss: bool = True
    completion_l1loss: bool = False
    completion_clip: float = 0.01
    completion_num_layers: int = 50
    completion_need2channel: bool = False
    completion_test: bool = False

    # DEBUG / VIS
    debug: bool = False
    visualize: bool = False
    vis_name: str = ""
    save_sample: bool = False
    per_semantic: bool = False
    demo: bool = False
    semantic_mask_path: str = "../semantic-segmentation/kitti/results"

    # TPU-NATIVE KNOBS (new; no reference equivalent)
    compute_dtype: str = "float32"  # "bfloat16" for MXU speed
    use_mesh: bool = False  # shard batches over the device mesh (data parallel)
    mesh_shape: Tuple[int, ...] = ()  # () = all devices on one data axis
    grad_accum_steps: int = 1  # lax.scan microbatching
    remat: bool = False  # jax.checkpoint the forward (memory for 352x1216)
    # Pallas banded-window warp kernel for the reprojection warps (MXU
    # one-hot contractions instead of hardware gathers; exact horizontally,
    # vertical window WH rows per RT-row block — see ops/pallas_warp.py
    # for the exactness domain). TPU only; gradients flow to coordinates.
    pallas_warp: bool = False
    # Which Pallas warp kernel: "banded" (one-hot MXU matmuls,
    # ops/pallas_warp.py) or "gather" (tpu.dynamic_gather crossbars,
    # ops/pallas_warp_gather.py — ~5x less arithmetic, VPU-bound). Same
    # windowing contract and numerics either way (tests/test_pallas_warp).
    pallas_warp_backend: str = "banded"
    # Source-band spec for the banded warp kernel ("dyn256", "dyn384",
    # "384", ...; see ops/pallas_warp._band_bw). "" defers to the
    # FUSIONDEPTH_WARP_BW env gate, EXCEPT under use_stereo, where
    # photometric.warp_band_for auto-selects "dyn384": stereo disparity
    # fields at depth discontinuities can exceed dyn256's ~128 px
    # in-strip spread domain (the clamp is silent — ops/pallas_warp.py
    # band_clamp_fraction is the telemetry).
    warp_band: str = ""
    # Run the depth+beam (and pose+beam-pose) encoder pairs as single
    # grouped-conv passes with block-grouped kernels (models/paired.py):
    # every C=64 conv fills all 128 lanes and the pass count halves.
    # Exact math (groups never mix channels; both consumers use the
    # additive fusion of the pair). Applies when beam_encoder is on,
    # depth<=34, separate_resnet pose, no s2d stem/predictive_mask.
    paired_encoders: bool = False
    # Fused SSIM+L1 reprojection-loss Pallas kernel of the JAX package
    # (TPU only). Accepted for parity of the two packages' flags and read
    # by nothing here: the port always takes its fused CUDA kernel when
    # SSIM is on (training/photometric.py::reprojection_maps).
    pallas_reproj: bool = False
    # W-folded decoder layout: view (B,H,W,C) as (B,H,W/F,F*C) so the
    # 16-64 channel decoder stages fill all 128 TPU lanes instead of
    # 12.5-50% of each tile (ops/folded.py). Exact math reassociation —
    # outputs match the generic path to dtype tolerance (tests/test_folded.py).
    folded_decoder: bool = True
    # conv1 as a space-to-depth 4x4/1 conv (exact 7x7/2 rewrite; see
    # models/resnet._S2DStemConv) — avoids the strided-stem wgrad im2col
    # chain XLA emits on TPU. Param shapes unchanged.
    s2d_stem: bool = False
    # Batch-pair packing of every encoder's C=64 region (bn1/relu/pool/
    # layer1): two samples side by side in the lanes, layer1 convs as
    # feature_group_count=2 — dense 128-lane tiles, exact same math
    # (models/resnet.pack2; exactness pinned at f64 by tests/test_pack2).
    # Default OFF: 1.8x faster on the isolated layer1 conv grad
    # (scripts/exp_convnet.py convg2_64_grad vs conv64_grad, v5e) but the
    # pack/unpack lane-regroup relayouts cost more than that win in the
    # full encoder (enc3_grad 6.95 -> 8.60 ms measured) — kept as a
    # probe-able lever for wider-batch / deeper-pack studies.
    pack2_encoder: bool = False
    # W-fold every encoder's C=64 region (bn1/relu/pool/layer1, plus the
    # layer2 downsample entry via bridge convs) at F=2: dense 128-lane
    # tiles with ZERO transposes (the fold is a free reshape, unlike
    # pack2's batch<->lane regroups — models/resnet.py fold64). Exact math
    # reassociation; BN stats tied across fold slots equal the unfolded
    # stats exactly (tests/test_folded_encoder.py). Measured v5e b12:
    # enc3_grad 7.01 -> 5.99 ms, full step 82.5 -> 78.3 ms. Basic-block
    # depths (18/34) only; ignored for bottlenecks.
    fold64_encoder: bool = True
    # Emit each encoder's stem-conv output DIRECTLY in the F=2 folded
    # layout (models/resnet._FoldStemConv: (7,9,C,128) stride-(2,4) band
    # kernel, exact 7x7/2 rewrite) instead of reshaping after — removes
    # the conv-output {3,0,2,1} layout boundary under the fold reshape
    # (PERF.md HLO byte anatomy). Only active with fold64_encoder.
    # Default ON since round 4: measured v5e b12 net_grad 45.8 -> 38.9 ms,
    # step 76.1 -> 68.8 ms (PERF.md round-4 anatomy); exactness pinned by
    # tests/test_folded_encoder.py::test_fold_stem_grads_match_f64.
    fold_stem: bool = True
    # Keep the encoder's C=64 pyramid levels (stem relu + layer1) in the
    # F=2 folded layout ACROSS the encoder->decoder seam: the folded
    # decoder consumes them directly (models/fusion.py wires
    # ResnetEncoder.folded_features + DepthDecoder.skip_fold), eliding the
    # unfold-at-encoder-exit / fold-at-decoder-entry reshape pair that the
    # {3,0,2,1} conv output layout turns into real HBM round trips
    # (PERF.md HLO byte anatomy). Exact: pure reshape elision, identical
    # param tree (tests/test_folded_seam.py). Auto-disabled unless the
    # folded decoder + fold64 encoder are both active and shapes allow.
    folded_seam: bool = True
    # Multi-process bring-up (torch.distributed.init_process_group +
    # per-process input sharding; parallel/multihost.py). batch_size stays
    # GLOBAL — each process loads batch_size / num_processes samples of ITS
    # split slice.
    coordinator_address: Optional[str] = None  # "host:port" of process 0
    num_processes: int = 1
    process_id: int = -1  # -1 = torchrun's RANK from the environment

    # ---- derived helpers ----
    @property
    def num_scales(self) -> int:
        return len(self.scales)

    @property
    def num_input_frames(self) -> int:
        return len(self.frame_ids)

    @property
    def num_pose_frames(self) -> int:
        return 2 if self.pose_model_input == "pairs" else self.num_input_frames

    @property
    def use_pose_net(self) -> bool:
        return not (self.use_stereo and tuple(self.frame_ids) == (0,))

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, default=str)

    @staticmethod
    def from_json(s: str) -> "Config":
        d = json.loads(s)
        d = {k: v for k, v in d.items() if k in _FIELD_NAMES}
        for k in ("scales", "frame_ids", "models_to_load", "mesh_shape"):
            if k in d and isinstance(d[k], list):
                d[k] = tuple(d[k])
        return Config(**d)


_FIELD_NAMES = {f.name for f in dataclasses.fields(Config)}

# Flags the REFERENCE declares but never reads — kept only for CLI
# compatibility; setting them is a no-op there too. parse_args warns when a
# user sets one so the no-op is never silent.
DEAD_REFERENCE_FLAGS = {
    "clone_path": "declared reference options.py:290, never read",
    "gdc_abs_loss": "declared reference options.py:323, never read",
    "completion_amp": ("declared reference options.py:362; only a "
                       "commented-out site (completor.py:230) — use "
                       "--compute_dtype bfloat16 for mixed precision here"),
    "completion_clip": "declared reference options.py:375, never read",
    "debug": ("declared reference options.py:394; only a commented-out "
              "site (completor.py:644)"),
}


def warn_dead_flags(cfg: Config) -> None:
    defaults = Config()
    for name, why in DEAD_REFERENCE_FLAGS.items():
        if getattr(cfg, name) != getattr(defaults, name):
            print(f"WARNING: --{name} has no effect ({why})", flush=True)


def _str2bool(v: str) -> bool:
    if isinstance(v, bool):
        return v
    if v.lower() in ("true", "1", "yes", "on"):
        return True
    if v.lower() in ("false", "0", "no", "off"):
        return False
    raise argparse.ArgumentTypeError(f"boolean value expected, got {v!r}")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="FusionDepth-TPU options")
    for f in dataclasses.fields(Config):
        name = "--" + f.name
        default = f.default if f.default is not dataclasses.MISSING else None
        if f.type in ("bool", bool):
            # accept --flag, --flag true/false, and --no-flag
            p.add_argument(name, nargs="?", const=True, default=default,
                           type=_str2bool)
            p.add_argument("--no-" + f.name, dest=f.name,
                           action="store_false")
        elif f.type in ("Tuple[int, ...]",) or "Tuple" in str(f.type):
            if f.name in ("models_to_load",):
                p.add_argument(name, nargs="+", type=str, default=default)
            else:
                p.add_argument(name, nargs="+", type=int, default=default)
        elif f.type in ("int", int):
            p.add_argument(name, type=int, default=default)
        elif f.type in ("float", float):
            p.add_argument(name, type=float, default=default)
        else:
            p.add_argument(name, type=str, default=default)
    return p


def parse_args(argv: Optional[Sequence[str]] = None) -> Config:
    ns = build_parser().parse_args(argv)
    d = {k: v for k, v in vars(ns).items() if k in _FIELD_NAMES}
    for k in ("scales", "frame_ids", "models_to_load", "mesh_shape"):
        if isinstance(d.get(k), list):
            d[k] = tuple(d[k])
    cfg = Config(**d)
    warn_dead_flags(cfg)
    return cfg
