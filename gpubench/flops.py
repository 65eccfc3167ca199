"""The yardstick's arithmetic: peaks of the card, model FLOPs from a
configuration's sizes, and a kernel's operations and bytes from its shapes.

Work is counted from shapes, never from what the program launches, so a
change that adds or removes work cannot move its own denominator.

Model FLOPs count two FLOPs a multiply-add of the matmul parameters a
token actually uses: in a mixture of experts only ``experts_per_tok /
num_experts`` of each expert leaf, since a token passes through its top-k
experts alone.  The embedding lookup and the norms are not counted.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates (no sparsity), at the 700 W limit.
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def head_dim(cfg: dict) -> int:
    return cfg.get("head_dim") or cfg["hidden_size"] // cfg["num_attention_heads"]


def padded_vocab(cfg: dict) -> int:
    m = cfg.get("vocab_pad_multiple", 1)
    return -(-cfg["vocab_size"] // m) * m


def layer_matmul_params(cfg: dict) -> dict:
    """One decoder layer's matmul parameters by part, the experts counted
    at their active share."""
    d, h, kv, hd = cfg["hidden_size"], cfg["num_attention_heads"], cfg["num_key_value_heads"], head_dim(cfg)
    attn = d * h * hd + 2 * d * kv * hd + h * hd * d
    f = cfg["intermediate_size"]
    n_ffn_mats = 3 if cfg.get("hidden_act", "silu") == "silu" else 2
    e = cfg.get("num_local_experts", 0)
    if e:
        experts = n_ffn_mats * e * d * f * cfg["num_experts_per_tok"] / e
        return {"attention": attn, "experts": experts, "router": d * e}
    return {"attention": attn, "mlp": n_ffn_mats * d * f}


def active_matmul_params(cfg: dict) -> float:
    """Matmul parameters a token uses: every layer's, and the output head
    over the padded vocabulary."""
    per_layer = sum(layer_matmul_params(cfg).values())
    return cfg["num_hidden_layers"] * per_layer + cfg["hidden_size"] * padded_vocab(cfg)


def train_flops_per_token(cfg: dict, seq: int) -> float:
    """A fastest-k train step a token: the forward and backward of the
    loss (6 N) and the eval forward after the update (2 N), with attention
    over the whole T x T score matrix each time (4 L H hd T a forward), as
    the plain path that the gradients take computes it.  Recomputation under
    remat is not counted."""
    n = active_matmul_params(cfg)
    attn = 4 * cfg["num_hidden_layers"] * cfg["num_attention_heads"] * head_dim(cfg) * seq
    return 6 * n + 2 * n + 3 * attn + attn


def prefill_flops(cfg: dict, batch: int, seq: int) -> float:
    """A prefill of ``batch`` prompts of ``seq`` tokens: every token through
    the layers, the output head at the last position only, and causal
    attention over the query-key pairs it needs."""
    d, l_ = cfg["hidden_size"], cfg["num_hidden_layers"]
    layers = l_ * sum(layer_matmul_params(cfg).values())
    head = d * padded_vocab(cfg)
    attn = l_ * flash_attention_work(batch, seq, cfg["num_attention_heads"], cfg["num_key_value_heads"],
                                     head_dim(cfg))["flops"]
    return 2 * batch * seq * layers + 2 * batch * head + attn


def flash_attention_work(batch: int, seq: int, heads: int, kv_heads: int, hd: int, elem_bytes: int = 2) -> dict:
    """One causal flash-attention call on (B, T, H, hd) q and (B, T, KV,
    hd) k, v: the FLOPs of the (t + 1) visible keys of each query, QK^T and
    PV, and each input byte read once and the output written once."""
    flops = 2.0 * batch * heads * 2 * hd * seq * (seq + 1) / 2
    nbytes = float(batch * seq * (2 * heads + 2 * kv_heads) * hd * elem_bytes)
    return {"flops": flops, "bytes": nbytes}


def bound_seconds(flops: float, nbytes: float, peak_flops: float = PEAK_BF16_FLOPS) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(flops / peak_flops, nbytes / PEAK_HBM_BYTES)
