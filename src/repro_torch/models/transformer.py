"""Layer stacks: the training forward, prefill, and decode against a cache.

A port of `repro/models/transformer.py`:

  dense / moe / vlm : [RMSNorm -> GQA attention] + [RMSNorm -> MLP | MoE],
                      KV-cache decode
  encdec (decoder)  : adds [RMSNorm -> cross-attention] over the encoder's
                      memory between the two (the encoder is a dense stack
                      run with causal=False)
  ssm               : [RMSNorm -> time-mix] + [RMSNorm -> channel-mix]
                      (RWKV-6), decode against the recurrent state
  hybrid            : [RMSNorm -> parallel attention + SSM mix] + [RMSNorm
                      -> MLP] (Hymba), decode against the KV cache and the
                      SSM state

Layer parameters stay stacked over a leading L axis, as in the JAX package,
and the layers run as a Python loop (there is no scan): over views `a[i]`
when serving, over `unbind` when training, whose backward writes each
stacked gradient once.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict

import torch
import torch.utils.checkpoint
from torch.utils._pytree import tree_flatten, tree_unflatten

from repro_torch.configs.base import ModelConfig
from repro_torch.models import hybrid, layers, moe, rwkv
from repro_torch.shardctx import constrain, recompute_context

PORTED_FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")


def check_family(cfg: ModelConfig) -> None:
    """Raise for a family that is none of the JAX package's six."""
    if cfg.family not in PORTED_FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}; options {PORTED_FAMILIES}")


def layer_params(stacked: dict, i: int) -> dict:
    """Parameters of layer i: the [i] view of every stacked leaf."""
    return {k: layer_params(v, i) if isinstance(v, dict) else v[i] for k, v in stacked.items()}


def init_layer_stack(gen: torch.Generator, cfg: ModelConfig, n_layers: int, device, cross: bool = False) -> dict:
    """Stacked (L, ...) parameters of n_layers blocks; with ``cross`` each
    block also has a cross-attention (``ln_x``, ``xattn``), as encdec's
    decoder does."""
    check_family(cfg)
    lead = (n_layers,)
    if cfg.family == "ssm":
        return {
            "ln1": layers.rmsnorm_init(cfg, device, lead),
            "tmix": rwkv.time_mix_init(gen, cfg, device, lead),
            "ln2": layers.rmsnorm_init(cfg, device, lead),
            "cmix": rwkv.channel_mix_init(gen, cfg, device, lead),
        }
    if cfg.family == "hybrid":
        return {
            "ln1": layers.rmsnorm_init(cfg, device, lead),
            "mix": hybrid.hymba_mix_init(gen, cfg, device, lead),
            "ln2": layers.rmsnorm_init(cfg, device, lead),
            "mlp": layers.mlp_init(gen, cfg, device, lead),
        }
    p = {
        "ln1": layers.rmsnorm_init(cfg, device, lead),
        "attn": layers.attention_init(gen, cfg, device, lead),
        "ln2": layers.rmsnorm_init(cfg, device, lead),
    }
    if cfg.family == "moe":
        p["moe"] = moe.moe_init(gen, cfg, device, lead)
    else:
        p["mlp"] = layers.mlp_init(gen, cfg, device, lead)
    if cross:
        p["ln_x"] = layers.rmsnorm_init(cfg, device, lead)
        p["xattn"] = layers.attention_init(gen, cfg, device, lead)
    return p


def _kv_to_ring_cache(k: torch.Tensor, window: int) -> torch.Tensor:
    """Pack full-sequence kv (B,T,KV,hd) into a ring cache of length `window`
    such that slot = t % window holds the latest token with that residue."""
    t = k.shape[1]
    if window <= 0 or t <= window:
        return k
    base = t - window
    # position base + i goes to slot (base + i) % window: a roll of the last
    # window positions, written as slices and a cat, which DTensor takes in
    # both torch versions (an index_put_ into a plain buffer it refuses, and
    # torch 2.11 has no sharding rule for roll)
    last, shift = k[:, base:], base % window
    return torch.cat([last[:, window - shift:], last[:, :window - shift]], dim=1) if shift else last


def attention_input(p: dict, cfg: ModelConfig, x: torch.Tensor):
    """One dense, moe or hybrid layer's attention parameters and the input
    its block gives `layers.attention_full`: RMSNorm ln1 of the residual x
    (hybrid's SSM branch reads the same input)."""
    return (p["mix"]["attn"] if cfg.family == "hybrid" else p["attn"]), layers.rmsnorm(p["ln1"], x)


def ffn_input(p: dict, x: torch.Tensor) -> torch.Tensor:
    """The input a dense, moe or hybrid block gives its MLP or MoE: RMSNorm
    ln2 of the residual x after the attention (or mix) sub-block."""
    return layers.rmsnorm(p["ln2"], x)


def _state_to_cache(s: torch.Tensor) -> torch.Tensor:
    """A scan's final state (B, H, K or N, V or P) in its decode cache's
    layout (`launch.sharding.CACHE_RULES`' "s" and "ssm"): the heads on
    the model axis where they divide it, else replicated there.  A scan run
    on V pieces (`shardctx.on_local_shards`) leaves its state sharded on
    V; this gathers it, once a layer of a prefill.  No-op without a mesh."""
    return constrain(s, "batch", "tp", "none", "none")


def block_full(p: dict, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor, *, window: int,
               causal: bool = True, enc_out: torch.Tensor | None = None, capture_cache: bool = False):
    """One layer over the whole sequence.  Returns (x_out, aux, cache_l):
    aux the MoE load-balance loss (f32), None for other families; cache_l
    with ``capture_cache`` the per-layer decode cache, whose leaves are
    init_cache's without the L axis, else None (the training forward).
    ``causal=False`` is the encoder's bidirectional attention; with
    ``enc_out`` a block that has ``xattn`` attends to that memory after its
    self-attention."""
    if cfg.seq_parallel and x.shape[1] > 1:
        x = constrain(x, "batch", "tp", "none")
    else:
        x = constrain(x, "batch", "none", "none")
    if cfg.family == "ssm":
        h = layers.rmsnorm(p["ln1"], x)
        y, x_att, s = rwkv.time_mix(p["tmix"], cfg, h)
        x = x + y
        h = layers.rmsnorm(p["ln2"], x)
        y, x_ffn = rwkv.channel_mix(p["cmix"], cfg, h)
        if not capture_cache:
            return x + y, None, None
        return x + y, None, {"x_att": x_att, "x_ffn": x_ffn, "s": _state_to_cache(s)}
    attn, h = attention_input(p, cfg, x)
    aux, cache_l = None, {}
    if cfg.family == "hybrid":
        y, s, (k, v) = hybrid.hymba_mix_full(p["mix"], cfg, h, positions, window=window, return_kv=True)
        if capture_cache:
            cache_l["ssm"] = _state_to_cache(s)
    else:
        y, (k, v) = layers.attention_full(attn, cfg, h, positions, causal=causal, window=window, return_kv=True)
    x = x + y
    if enc_out is not None and "xattn" in p:
        x = x + layers.attention_full(p["xattn"], cfg, layers.rmsnorm(p["ln_x"], x), positions, causal=False,
                                      kv_x=enc_out)
    h = ffn_input(p, x)
    if cfg.family == "moe":
        y, aux = moe.moe_layer(p["moe"], cfg, h)
    else:
        y = layers.mlp(p["mlp"], cfg, h)
    x = x + y
    if not capture_cache:
        return x, aux, None
    return x, aux, {"k": _kv_to_ring_cache(k, window), "v": _kv_to_ring_cache(v, window), **cache_l}


# The products `jax.checkpoint_policies.dots_with_no_batch_dims_saveable`
# keeps: matmuls without batch dims.  A (B, T, D) @ (D, F) product reaches
# the dispatcher as one `mm` over B*T rows, and an einsum such as
# "btd,dhk->bthk" as a `bmm` over a batch of 1; the attention's products
# over (batch, heads) are `bmm`s with a real batch and are recomputed, with
# everything else.
SAVED_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy

    no_batch = op in SAVED_PRODUCTS or (op is torch.ops.aten.bmm.default and args[0].shape[0] == 1)
    return CheckpointPolicy.MUST_SAVE if no_batch else CheckpointPolicy.PREFER_RECOMPUTE


def checkpointed(fn: Callable, *args, policy: str = "full"):
    """``fn(*args)`` through `torch.utils.checkpoint` (recomputed in the
    backward pass, as `jax.checkpoint`).  ``policy="dots"`` keeps the
    outputs of the products without batch dims (`_dots_policy`) from the
    forward pass and recomputes the rest (selective checkpointing, as the reference's
    `dots_with_no_batch_dims_saveable`); "full" recomputes everything.  It
    is not reliable under a `torch.func` transform, so there it raises
    rather than run unchecked: set ``remat=False`` for a mapped loss (the
    smoke configs do)."""
    if torch._C._functorch.maybe_current_level() is not None:
        raise RuntimeError("remat (torch.utils.checkpoint) under a torch.func transform: build the mapped loss "
                           "from a config with remat=False")
    sharded = recompute_context()
    if policy != "dots" and sharded is None:
        return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)

    def contexts():
        from torch.utils.checkpoint import create_selective_checkpoint_contexts

        fwd, rec = (create_selective_checkpoint_contexts(_dots_policy) if policy == "dots"
                    else (contextlib.nullcontext(), contextlib.nullcontext()))
        return fwd, rec if sharded is None else _entered_together(rec, sharded())

    return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False, context_fn=contexts)


@contextlib.contextmanager
def _entered_together(*contexts):
    with contextlib.ExitStack() as stack:
        for c in contexts:
            stack.enter_context(c)
        yield


def run_stack_full(stacked: dict, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor, *,
                   window: int = 0, causal: bool = True, enc_out: torch.Tensor | None = None,
                   n_layers: int | None = None):
    """The forward through the layer stack with no decode cache: training,
    and the encoder (``causal=False``, ``n_layers=cfg.encoder_layers``).
    Returns (x, aux_sum): the layers' MoE load-balance losses summed in f32
    (zero for other families).  With ``cfg.remat`` and grad mode on, each
    block is recomputed in the backward pass (`checkpointed`; with
    ``remat_policy="dots"`` the products without batch dims are kept)."""
    check_family(cfg)
    remat = cfg.remat and torch.is_grad_enabled()

    def body(x, p):
        return block_full(p, cfg, x, positions, window=window, causal=causal, enc_out=enc_out)[:2]

    n_layers = cfg.n_layers if n_layers is None else n_layers
    leaves, spec = tree_flatten(stacked)
    unbound = [a.unbind(0) for a in leaves]
    per_layer = [tree_unflatten([u[i] for u in unbound], spec) for i in range(n_layers)]
    aux_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    for p in per_layer:
        x, aux = checkpointed(body, x, p, policy=cfg.remat_policy) if remat else body(x, p)
        if aux is not None:
            aux_sum = aux_sum + aux
    return x, aux_sum


def run_stack_prefill(stacked: dict, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor,
                      *, window: int = 0, enc_out: torch.Tensor | None = None):
    """Prefill: full-sequence forward that also captures the decode cache.
    Returns (x, cache) with cache leaves stacked over layers: k, v (L, B, S,
    KV, hd) for dense and moe, and for hybrid with ssm (L, B, H, N, hd) f32;
    x_att, x_ffn (L, B, D) and s (L, B, H, hd, hd) f32 for ssm.  Each
    layer's leaves are written straight into the preallocated stack."""
    check_family(cfg)
    cache = None
    for i in range(cfg.n_layers):
        x, _, cache_l = block_full(layer_params(stacked, i), cfg, x, positions, window=window, enc_out=enc_out,
                                    capture_cache=True)
        if cache is None:
            cache = {kk: a.new_empty((cfg.n_layers,) + tuple(a.shape)) for kk, a in cache_l.items()}
        for kk, a in cache_l.items():
            cache[kk][i] = a
    return x, cache


def _block_decode(p: dict, cache_l: Dict[str, torch.Tensor], cfg: ModelConfig, x: torch.Tensor,
                  pos: int, *, window: int, enc_out: torch.Tensor | None = None):
    """One layer of single-token decode; updates cache_l's leaves in place
    (views of the stacked cache), where the JAX package returns new ones.
    With ``enc_out`` a block that has ``xattn`` attends to that memory."""
    if cfg.family == "ssm":
        y, xp, s = rwkv.time_mix(
            p["tmix"], cfg, layers.rmsnorm(p["ln1"], x), cache_l["x_att"], cache_l["s"]
        )
        x = x + y
        cache_l["x_att"].copy_(xp)
        cache_l["s"].copy_(s)
        y, xp = rwkv.channel_mix(p["cmix"], cfg, layers.rmsnorm(p["ln2"], x), cache_l["x_ffn"])
        cache_l["x_ffn"].copy_(xp)
        return x + y
    if cfg.family == "hybrid":
        y, _, _, s = hybrid.hymba_mix_decode(
            p["mix"], cfg, layers.rmsnorm(p["ln1"], x), cache_l["k"], cache_l["v"], cache_l["ssm"], pos,
            window=window,
        )
        cache_l["ssm"].copy_(s)
        x = x + y
        return x + layers.mlp(p["mlp"], cfg, layers.rmsnorm(p["ln2"], x))
    h = layers.rmsnorm(p["ln1"], x)
    y, _, _ = layers.attention_decode(
        p["attn"], cfg, h, cache_l["k"], cache_l["v"], pos, window=window
    )
    x = x + y
    if enc_out is not None and "xattn" in p:
        x = x + layers.attention_decode(p["xattn"], cfg, layers.rmsnorm(p["ln_x"], x), cache_l["k"], cache_l["v"],
                                        pos, kv_x=enc_out)[0]
    h = layers.rmsnorm(p["ln2"], x)
    if cfg.family == "moe":
        return x + moe.moe_layer(p["moe"], cfg, h)[0]
    return x + layers.mlp(p["mlp"], cfg, h)


def run_stack_decode(stacked: dict, cache: Dict[str, torch.Tensor], cfg: ModelConfig,
                     x: torch.Tensor, pos: int, *, window: int = 0, enc_out: torch.Tensor | None = None):
    """Single-token decode through the stack.  Returns (x, cache): the
    stacked cache (KV for dense and moe, KV and SSM state for hybrid,
    token-shift carries and wkv state for ssm) is updated in place and
    returned."""
    check_family(cfg)
    for i in range(cfg.n_layers):
        cache_l = {kk: a[i] for kk, a in cache.items()}
        x = _block_decode(layer_params(stacked, i), cache_l, cfg, x, pos, window=window, enc_out=enc_out)
    return x, cache


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, window: int = 0, *, device) -> dict:
    """Zero decode cache (stacked over layers).  For windowed attention the
    kv cache length is min(cache_len, window); the ssm cache (token-shift
    carries and wkv state) and hybrid's SSM state have no length, so
    cache_len and window do not change them."""
    check_family(cfg)
    l, kv, hd = cfg.n_layers, cfg.n_kv_heads, cfg.resolved_head_dim
    h, d, n = cfg.n_heads, cfg.d_model, max(cfg.ssm_state, 1)
    dt = layers._dtype(cfg.compute_dtype)
    s = min(cache_len, window) if window else cache_len
    if cfg.family == "ssm":
        return {
            "x_att": torch.zeros((l, batch, d), dtype=dt, device=device),
            "x_ffn": torch.zeros((l, batch, d), dtype=dt, device=device),
            "s": torch.zeros((l, batch, h, hd, hd), dtype=torch.float32, device=device),
        }
    cache = {
        "k": torch.zeros((l, batch, s, kv, hd), dtype=dt, device=device),
        "v": torch.zeros((l, batch, s, kv, hd), dtype=dt, device=device),
    }
    if cfg.family == "hybrid":
        cache["ssm"] = torch.zeros((l, batch, h, n, hd), dtype=torch.float32, device=device)
    return cache
