"""The yardstick's arithmetic against hand counts at tiny shapes, and the
attention bound's copy against ``chip_smoke.py``'s."""
from __future__ import annotations

import sys
from pathlib import Path

import torch

from portbench import counts

REPO = Path(__file__).resolve().parents[2]


def test_mlp_flops():
    assert counts.mlp_flops([3, 4, 5]) == 2 * (3 * 4 + 4 * 5)


def test_sir_flops_per_point():
    cfg = dict(num_blocks=1, feat_channels=[4, 4], rel_mlp_hidden=[2])
    # in 3 + 2 = 5; gate 3 -> 2 -> 5; VFE 5 -> 4, then 8 -> 4
    assert counts.sir_flops_per_point(2, 3, cfg, False) == \
        2 * (3 * 2 + 2 * 5) + 2 * 5 * 4 + 2 * 8 * 4
    # with the 3 relative channels in the input too
    assert counts.sir_flops_per_point(2, 3, cfg, True) == \
        2 * (3 * 2 + 2 * 8) + 2 * 8 * 4 + 2 * 8 * 4


def test_ococcnet_flops():
    cfg = dict(d_model=4, num_blocks=1, feat_channels=[2, 2],
               rel_mlp_hidden=[2], num_point_feats=1, roi_pos_enc_mlp=[2],
               num_enc_layers=1, attn_ffn_dim=2, latent_mlp=[2],
               fusion_mlp=[2], cls_mlp=[2], reg_mlp=[2], occ_mlp=[2, 2, 2],
               pos_encode_freqs=1)
    per_point = (2 * (13 * 2 + 2 * 18) + 2 * 18 * 2 + 2 * 4 * 2
                 + 2 * (3 * 2 + 2 * 15) + 2 * 15 * 2 + 2 * 4 * 2)
    per_frame = (2 * (7 * 2 + 2 * 4) + (8 * 16 + 2 * (4 * 2 + 2 * 4))
                 + 2 * (8 * 2 + 2 * 4) * 2 + 2 * (4 * 2 + 2 * 1)
                 + 2 * (4 * 2 + 2 * 7) + 2 * 4 * 2)
    per_query = 2 * 6 * 2 + 2 * (2 * 2 + 2 * 2 + 2 * 1)
    attn = 4 * 4 * (3 * 4 // 2)           # 6 causal pairs of 3 frames
    assert counts.ococcnet_flops(cfg, 10, [3], 5) == \
        10 * per_point + 3 * per_frame + attn + 3 * 5 * per_query
    assert per_point == 360 and per_frame == 380 and per_query == 44


def test_sst_flops():
    cfg = dict(sst=dict(d_model=4, point_dim=2, vfe_channels=[2, 3],
                        ffn_dim=2),
               neck_channels=2, num_classes=1,
               anchors=dict(sizes=[[1, 1, 1]], rotations=[0.0, 1.0]))
    vfe = 5 * (2 * 8 * 2 + 2 * 4 * 3)
    proj = 3 * 2 * 3 * 4
    layer = 3 * (8 * 16 + 2 * (4 * 2 + 2 * 4)) + 4 * 4 * (4 + 1)
    neck = 2 * 9 * (4 * 2 + 2 * 2 + 2 * 2) * 6
    head = 2 * 2 * 2 * 10 * 6
    assert counts.sst_flops(cfg, 5, 3, [[2, 1]], (2, 3)) == \
        vfe + proj + layer + neck + head


def test_attention_bound_matches_chip_smoke():
    sys.path.insert(0, str(REPO))
    import chip_smoke
    g = torch.Generator().manual_seed(0)
    for W, T in ((3200, 32), (800, 144), (64, 20)):
        mask = torch.rand((W, T), generator=g) < 0.3
        mask[:W // 3] = False
        for dtype in (torch.float32, torch.bfloat16):
            for backward in (False, True):
                assert counts.attention_bound_ms(mask, 128, dtype, backward) \
                    == chip_smoke.attention_bound_ms(mask, 128, dtype,
                                                     backward)
    assert counts.PEAK_FLOPS == chip_smoke.PEAK_FLOPS
    assert counts.PEAK_BYTES == chip_smoke.PEAK_BYTES
