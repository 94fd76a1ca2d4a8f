"""OcOccNet configuration (a copy of the JAX package's
``configs/ococcnet_config.py``, which mirrors the reference's
``configs/ococc/ococcnet.py``; hyperparameters value for value).

The port keeps its own copy so that it imports nothing of the JAX package.
``tests/test_torch_ococcnet.py`` holds every field equal to the original.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class OcOccNetConfig:
    # model family: "ococc" = full OcOccNet (occupancy AE + temporal
    # transformer + implicit decoder); "ctrl" = the CTRL baseline (RoI SIR
    # encoder + cls/reg heads only)
    variant: str = "ococc"

    # compute dtype of the MLP / attention stacks ("float32" or
    # "bfloat16"); parameters, softmax and norm statistics stay float32
    compute_dtype: str = "float32"

    # LayerNorm statistics dtype of the JAX package's two-pass LayerNorm;
    # the one-pass LayerNorm that both packages run keeps float32
    # statistics whatever this says
    ln_dtype: str = "auto"

    # rematerialise the SIR encoders in training (not ported: raises)
    remat_sir: bool = False

    # static shapes
    batch_size: int = 4                 # tracklets per device
    reg_len: int = 32                   # frames per tracklet at train
    max_points_per_frame: int = 1024
    num_occ_samples: int = 512
    max_frame_ind: int = 200

    # RoI pooling
    extra_wlh: Tuple[float, float, float] = (0.5, 0.5, 0.5)
    # per-RoI pooled-point cap of the dense layout: valid points compact
    # to the front and the SIR encoders run at this smaller static budget
    roi_point_budget: int | None = 640

    # packed-point budget per tracklet at reg_len frames (the reference's
    # max_all_pts); takes precedence over roi_point_budget. None = dense
    packed_point_budget: int | None = 8192

    # block alignment quantum of the packed layout; 0 = tight packing
    packed_quantum: int = 128

    # SIR RoI encoder
    num_blocks: int = 6
    feat_channels: Tuple[int, int] = (128, 128)
    rel_mlp_hidden: Tuple[int, int] = (16, 32)
    xyz_normalizer: Tuple[float, float, float] = (20.0, 20.0, 4.0)

    # occupancy auto-encoder
    ae_voxel_size: float = 0.2
    ae_xyz_normalizer: Tuple[float, float, float] = (1.0, 1.0, 1.0)

    # occupancy decoder
    occ_mlp: Tuple[int, int, int] = (512, 1024, 1024)
    pos_encode_freqs: int = 10
    occ_dropout: float = 0.1
    occ_pos_thresh: float = 0.5

    # temporal transformer; test_attn_window -1 = full causal attention
    test_attn_window: int = -1
    d_model: int = 1536
    attn_num_heads: int = 4
    attn_ffn_dim: int = 512
    attn_dropout: float = 0.1
    num_enc_layers: int = 3
    roi_pos_enc_mlp: Tuple[int, int] = (512, 512)

    # fusion + heads
    latent_mlp: Tuple[int, int] = (2048, 2048)
    fusion_mlp: Tuple[int, int] = (2048, 2048)
    cls_mlp: Tuple[int, int] = (512, 512)
    reg_mlp: Tuple[int, int] = (512, 512)
    cls_dropout: float = 0.1
    reg_dropout: float = 0.1
    latent_dropout: float = 0.1
    fusion_dropout: float = 0.1
    fused_mode: str = "concat"
    rcnn_trans: bool = False            # conv_fused reads cluster feats
    act: str = "gelu"

    # losses / targets
    cls_pos_thr: float = 0.8
    cls_neg_thr: float = 0.2
    occ_label_thresh: float = 0.4
    rcnn_code_weights: Sequence[float] = (2.0, 2.0, 1.0, 1.0, 1.0, 1.0, 1.0)
    loss_bbox_weight: float = 2.0
    loss_cls_weight: float = 1.0
    loss_occ_weight: float = 1.0
    corner_loss_weight: float = 0.0

    # freeze the occupancy auto-encoder during training
    fixed_ae: bool = False

    class_names: Tuple[str, ...] = ("Car",)

    # whole-tracklet sparse-UNet point features (not ported: raises)
    use_segmentor: str | None = None

    # optimisation
    base_lr: float = 1e-6
    lr_mult: float = 100.0
    weight_decay: float = 0.05
    grad_clip_norm: float = 10.0
    max_epochs: int = 24

    # point feature layout: [x y z | intensity elong yaw/pi w/10 l/10 h/10
    #                        det_score] + roi_score appended in the head
    num_point_feats: int = 7

    @property
    def points_dim(self) -> int:
        return 3 + self.num_point_feats


def ctrl_veh_config() -> OcOccNetConfig:
    """CTRL vehicle baseline (``configs/ctrl/ctrl_veh_24e.py``)."""
    return OcOccNetConfig(variant="ctrl", class_names=("Car",),
                          corner_loss_weight=1.0)


def ctrl_ped_config() -> OcOccNetConfig:
    """CTRL pedestrian (``configs/ctrl/ctrl_ped_24e.py``)."""
    return OcOccNetConfig(variant="ctrl", class_names=("Pedestrian",),
                          cls_pos_thr=0.65, cls_neg_thr=0.15,
                          corner_loss_weight=0.0, max_epochs=24)


def ctrl_cyc_config() -> OcOccNetConfig:
    """CTRL cyclist (``configs/ctrl/ctrl_cyc_12e.py``)."""
    return OcOccNetConfig(variant="ctrl", class_names=("Cyclist",),
                          cls_pos_thr=0.65, cls_neg_thr=0.15,
                          corner_loss_weight=0.0, max_epochs=12)


def tiny_config() -> OcOccNetConfig:
    """Small shapes for tests, in the dense point layout."""
    return OcOccNetConfig(
        batch_size=2, reg_len=8, max_points_per_frame=64, num_occ_samples=32,
        num_blocks=2, feat_channels=(32, 32), rel_mlp_hidden=(8, 16),
        occ_mlp=(32, 32, 32), d_model=2 * 2 * 32, attn_ffn_dim=64,
        latent_mlp=(64,), fusion_mlp=(64,), cls_mlp=(32,), reg_mlp=(32,),
        roi_pos_enc_mlp=(32,), num_enc_layers=1,
        packed_point_budget=None,
    )
