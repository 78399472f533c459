"""Typed configuration (copy of opengaussian_tpu/config.py).

Replaces the reference's reflection-based argparse ParamGroups
(reference arguments/__init__.py:19-147) with frozen dataclasses. Defaults
reproduce the reference values exactly (arguments/__init__.py:47-125); the
per-scene recipes from scripts/train_lerf.sh / train_scannet.sh live in
PRESETS.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    sh_degree: int = 3
    source_path: str = ""
    model_path: str = ""
    images: str = "images"
    resolution: int = -1
    white_background: bool = False
    eval: bool = False
    ins_feat_dim: int = 6


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    # reference PipelineParams: convert_SHs_python / compute_cov3D_python are
    # toggles between the reference's CUDA rasterizer and its Python code,
    # which do not exist here; debug maps to extra assertions.
    debug: bool = False


@dataclasses.dataclass(frozen=True)
class OptimizationConfig:
    iterations: int = 70_000
    # learning rates (reference arguments/__init__.py:75-86)
    position_lr_init: float = 0.00016
    position_lr_final: float = 0.0000016
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30_000
    feature_lr: float = 0.0025
    ins_feat_lr: float = 0.001
    opacity_lr: float = 0.05
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001
    # densification
    percent_dense: float = 0.01
    lambda_dssim: float = 0.2
    densification_interval: int = 100
    opacity_reset_interval: int = 3000
    densify_from_iter: int = 500
    densify_until_iter: int = 15_000
    densify_grad_threshold: float = 0.0002
    random_background: bool = False
    # OpenGaussian stage machine (arguments/__init__.py:88-108)
    leaf_update_fr: int = 300
    root_node_num: int = 64  # k1
    leaf_node_num: int = 5  # k2
    pos_weight: float = 1.0
    loss_weight: float = 0.1  # cohesion loss weight
    start_ins_feat_iter: int = 30_000
    start_root_cb_iter: int = 40_000
    start_leaf_cb_iter: int = 50_000
    frozen_init_pts: bool = False
    sam_level: int = 3
    save_memory: bool = False
    # fork extension: one-shot cross-view SAM mask refinement at stage-1
    # entry (reference train.py:393-426)
    enable_multiview_sam_refinement: bool = False


@dataclasses.dataclass(frozen=True)
class Config:
    model: ModelConfig = ModelConfig()
    opt: OptimizationConfig = OptimizationConfig()
    pipe: PipelineConfig = PipelineConfig()

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @staticmethod
    def from_json(s: str) -> "Config":
        d = json.loads(s)
        return Config(
            model=ModelConfig(**d.get("model", {})),
            opt=OptimizationConfig(**d.get("opt", {})),
            pipe=PipelineConfig(**d.get("pipe", {})),
        )


def _lerf(scene: str, **opt) -> Config:
    base = dict(
        iterations=70_000,
        start_ins_feat_iter=30_000,
        start_root_cb_iter=40_000,
        start_leaf_cb_iter=50_000,
        sam_level=3,
    )
    base.update(opt)
    return Config(model=ModelConfig(), opt=OptimizationConfig(**base))


def _scannet(**opt) -> Config:
    # scripts/train_scannet.sh: 90k iters, frozen init points, no densify,
    # stage boundaries 30/50/70k, sam_level 0, r=2
    base = dict(
        iterations=90_000,
        start_ins_feat_iter=30_000,
        start_root_cb_iter=50_000,
        start_leaf_cb_iter=70_000,
        frozen_init_pts=True,
        sam_level=0,
    )
    base.update(opt)
    return Config(model=ModelConfig(resolution=2), opt=OptimizationConfig(**base))


# Per-scene recipes transcribed from the reference's shell scripts
# (scripts/train_lerf.sh, scripts/train_scannet.sh).
PRESETS: dict[str, Config] = {
    "lerf/figurines": _lerf(
        "figurines", root_node_num=64, leaf_node_num=10, pos_weight=0.5, save_memory=True
    ),
    # teatime: k1=32, pos_weight=0.1 (scripts/train_lerf.sh:81-83)
    "lerf/teatime": _lerf(
        "teatime", root_node_num=32, leaf_node_num=10, pos_weight=0.1, save_memory=True
    ),
    # ramen: cohesion loss weight 0.01 instead of 0.1 (scripts/train_lerf.sh:108-111)
    "lerf/ramen": _lerf(
        "ramen", root_node_num=64, leaf_node_num=10, pos_weight=0.5, loss_weight=0.01
    ),
    "lerf/waldo_kitchen": _lerf(
        "waldo_kitchen", root_node_num=64, leaf_node_num=10, pos_weight=0.5
    ),
    # scannet2: the scripted recipe also enables the fork's multi-view SAM
    # refinement (scripts/train_scannet.sh:38-47)
    "scannet/default": _scannet(
        root_node_num=64, leaf_node_num=5, pos_weight=1.0,
        enable_multiview_sam_refinement=True,
    ),
}
