"""The yardstick's FLOP counts, held to counts worked out by hand."""

import pytest

from gpubench import flops

SMOKE_MOE = {
    "num_hidden_layers": 2, "hidden_size": 128, "num_attention_heads": 8, "num_key_value_heads": 4,
    "head_dim": 16, "intermediate_size": 64, "num_local_experts": 4, "num_experts_per_tok": 2,
    "vocab_size": 500, "vocab_pad_multiple": 64, "hidden_act": "silu",
}

GRANITE = {
    "num_hidden_layers": 24, "hidden_size": 1024, "num_attention_heads": 16, "num_key_value_heads": 8,
    "head_dim": 64, "intermediate_size": 512, "num_local_experts": 32, "num_experts_per_tok": 8,
    "vocab_size": 49155, "vocab_pad_multiple": 1024, "hidden_act": "silu",
}


def test_smoke_moe_active_params_by_hand():
    # attention: q 128*8*16 + k, v 2 * 128*4*16 + o 8*16*128 = 16384 + 16384 + 16384 = 49152
    # experts: 3 matrices of 128 x 64 for each of the 2 active experts = 49152; router 128 * 4 = 512
    # head: 128 * 512 (500 padded to a multiple of 64)
    per_layer = 49152 + 49152 + 512
    assert flops.active_matmul_params(SMOKE_MOE) == 2 * per_layer + 128 * 512


def test_smoke_moe_step_and_prefill_by_hand():
    n = 2 * (49152 + 49152 + 512) + 128 * 512
    seq = 32
    attn = 4 * 2 * 8 * 16 * seq  # 4 L H hd T a token and a forward
    assert flops.train_flops_per_token(SMOKE_MOE, seq) == 8 * n + 4 * attn
    # prefill of 3 x 32: every token through the layers, the head once a row,
    # causal pairs 32*33/2 a head and layer, 2 hd FLOPs each for QK^T and for PV
    layers = 2 * (49152 + 49152 + 512)
    causal = 2 * (3 * 8 * (2 * 2 * 16) * 32 * 33 / 2)
    assert flops.prefill_flops(SMOKE_MOE, 3, 32) == 2 * 96 * layers + 2 * 3 * 128 * 512 + causal


def test_granite_counts_active_experts_only():
    n = flops.active_matmul_params(GRANITE)
    assert n == pytest.approx(4.297e8, rel=1e-3)
    every_expert = n + 24 * 3 * (32 - 8) * 1024 * 512
    assert every_expert == pytest.approx(1.33e9, rel=1e-2)
    assert flops.train_flops_per_token(GRANITE, 1024) == pytest.approx(3.84e9, rel=5e-3)


def test_flash_bound_matches_the_kernel_table():
    # the llama prefill shape of the kernel table: 0.0261 ms, operation-bound
    w = flops.flash_attention_work(4, 1024, 24, 8, 128)
    assert flops.bound_seconds(w["flops"], w["bytes"]) * 1e3 == pytest.approx(0.0261, abs=5e-5)
    assert w["bytes"] == 4 * 1024 * (24 + 8 + 8 + 24) * 128 * 2
