"""The port's language model, built from a configuration file's sizes.

The file names the port's architecture (``program_arch``; ``program_smoke``
for its reduced test variant) and states every size; the port's own
configuration has to agree with each, so the file holds the configuration
as it is run.
"""

from __future__ import annotations

from gpubench import flops
from gpubench.bench import BenchError

# the configuration file's keys, and the port's ModelConfig field or property for each
FIELDS = {
    "num_hidden_layers": "n_layers",
    "hidden_size": "d_model",
    "num_attention_heads": "n_heads",
    "num_key_value_heads": "n_kv_heads",
    "head_dim": "resolved_head_dim",
    "intermediate_size": "d_ff",
    "vocab_size": "vocab_size",
    "vocab_pad_multiple": "vocab_pad_multiple",
    "num_local_experts": "n_experts",
    "num_experts_per_tok": "moe_top_k",
    "capacity_factor": "capacity_factor",
    "router_aux_weight": "router_aux_weight",
    "rope_theta": "rope_theta",
    "param_dtype": "param_dtype",
    "compute_dtype": "compute_dtype",
    "tie_word_embeddings": "tie_embeddings",
    "moe_dispatch": "moe_dispatch",
}


def program_config(cfg: dict):
    from repro_torch.configs import get_config, get_smoke_config

    pcfg = (get_smoke_config if cfg.get("program_smoke") else get_config)(cfg["program_arch"])
    for key, attr in FIELDS.items():
        if key in cfg and getattr(pcfg, attr) != cfg[key]:
            raise BenchError(f"configuration file says {key}={cfg[key]!r}, the port runs {getattr(pcfg, attr)!r}")
    if flops.padded_vocab(cfg) != pcfg.padded_vocab:
        raise BenchError("the padded vocabulary differs from the port's")
    return pcfg


def program_model(cfg: dict, dev):
    from repro_torch.models import build_model

    return build_model(program_config(cfg), dev)
