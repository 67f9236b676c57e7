"""The FLOP counts against counts worked by hand at small shapes."""

from __future__ import annotations

import pytest

from portbench.counts import flops

DENSE = {"n_layers": 2, "d_model": 8, "n_heads": 2, "n_kv": 1, "d_head": 4, "d_ff": 16,
         "vocab": 10, "mlp_kind": "swiglu", "attn_period": 1, "ssm_state": 0}
SSM = {"n_layers": 3, "d_model": 4, "vocab": 6, "d_ff": 0, "attn_period": 0, "ssm_state": 2,
       "ssm_expand": 2, "ssm_headdim": 4, "ssm_conv": 4, "ssm_groups": 1, "ssd_chunk": 2}


def test_dense_prefill_by_hand():
    # a layer: wq 8x8, wk and wv 8x4, wo 8x8 = 192; the MLP 3 x 8 x 16 = 384
    assert flops.layer_weights(DENSE, "attn") == 576
    B, L = 3, 5
    matmuls = 2 * B * L * 576 * 2
    # causal pairs 5 * 6 / 2 = 15 a row; 4 * dh(4) * H(2) a pair, B rows, 2 layers
    attention = 4 * 4 * 2 * 15 * B * 2
    head = 2 * B * 8 * 10
    assert flops.prefill_flops(DENSE, B, L) == matmuls + attention + head
    assert flops.attention_flops(DENSE, B, L) == attention


def test_dense_train_is_three_forwards_with_the_head_on_every_position():
    B, L = 2, 4
    fwd = 2 * B * L * 576 * 2 + 4 * 4 * 2 * 10 * B * 2 + 2 * B * L * 8 * 10
    assert flops.train_flops(DENSE, B, L) == 3 * fwd


def test_ssd_layer_by_hand():
    # d_inner 8, 2 heads of 4, state 2: in_proj 4 x (16 + 4 + 2) = 88, out 8 x 4 = 32
    assert flops.layer_weights(SSM, "ssd") == 120
    B, L = 1, 4
    # 2 chunks of 2: 3 causal pairs a chunk, 2 (N + P) = 12 a pair and head
    intra = 2 * 3 * 12
    inter = 4 * 4 * 2 * 4  # L * 4 N P
    conv = 2 * 4 * (8 + 4) * 4
    mixer = B * (2 * (intra + inter) + conv)
    assert flops.mixer_flops(SSM, "ssd", B, L) == mixer
    assert flops.prefill_flops(SSM, B, L) == 3 * (2 * B * L * 120 + mixer) + 2 * B * 4 * 6
    assert flops.attention_flops(SSM, B, L) == 0


def test_row_10s_count():
    cfg = dict(DENSE, n_layers=1, n_heads=32, n_kv=8, d_head=128)
    assert flops.attention_flops(cfg, 4, 2048) == pytest.approx(1.37506e11, rel=1e-5)
