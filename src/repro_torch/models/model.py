"""Top-level model API of the port: build_model(cfg, device) ->
Model(init, loss_fn, prefill, decode_step, init_cache, encode).

A port of `repro/models/model.py::build_model` for every family
(`transformer.PORTED_FAMILIES`).  Parameters come from `init` (random, on
the card) or `repro_torch.checkpoint.params_from_jax`.

Batch contract, as in the JAX package (`launch/specs.py` gives the shapes):
  train:   {tokens (B,T) int, targets (B,T) int}
           + vlm:    patches (B,P,D): stub frontend embeddings, put before
                     the tokens; the loss is over the token positions
           + encdec: frames (B,F,D): stub frontend embeddings, encoded into
                     the memory the decoder's cross-attention reads
  prefill: {tokens (B,T) int} (+ patches / frames)
  decode:  token (B,1) int, cache, pos (int) = number of positions already
           cached (for vlm the P patches count); for encdec the memory as
           enc_out (`encode(params, frames)`, once per request) or frames

`loss_fn` returns per-batch-row losses (B,): the fastest-k aggregation
turns them into the masked weighted mean of eq. (2), so the model never
needs to know about stragglers.  It runs where its inputs lie, under
autograd and under `torch.func` transforms (with ``cfg.remat`` off there).
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers, transformer
from repro_torch.models.transformer import checkpointed
from repro_torch.shardctx import all_reduce, constrain, is_dtensor, on_local_shards

# The chunked cross-entropy's sequence chunk: (B, 512, Vpad) f32 logits at a time.
CE_CHUNK = 512


class Model(NamedTuple):
    cfg: ModelConfig
    device: torch.device
    init: Callable
    loss_fn: Callable
    prefill: Callable
    decode_step: Callable
    init_cache: Callable
    encode: Callable


def _masked_logits(logits: torch.Tensor, vocab: int) -> torch.Tensor:
    """Padded vocab entries set to the f32 minimum, out of the softmax."""
    vpad = logits.shape[-1]
    if vpad <= vocab:
        return logits
    pad = torch.arange(vpad, device=logits.device) >= vocab
    return torch.where(pad, torch.finfo(logits.dtype).min, logits)


class _VocabParallelNll(torch.autograd.Function):
    """`_nll` on one rank's (B, T, V_local) f32 logits, columns [lo, lo +
    V_local) of the padded vocab, the rest on the ranks of ``groups``: the
    max, the sum of exp(l - max) and the gold logit are all-reduced, three
    (B, T) f32 vectors, and nll = log(sum) + max - gold.  The backward is
    (softmax - onehot) g on the local shard, with no collective."""

    @staticmethod
    def forward(ctx, logits, targets, lo: int, vocab: int, groups):
        vl = logits.shape[-1]
        pad = torch.arange(lo, lo + vl, device=logits.device) >= vocab
        logits = torch.where(pad, torch.finfo(logits.dtype).min, logits)
        m = all_reduce(torch.amax(logits, dim=-1), "max", groups)
        s = all_reduce(torch.exp(logits - m[..., None]).sum(dim=-1), "sum", groups)
        col = targets.to(torch.int64) - lo
        mine = (col >= 0) & (col < vl)
        col = col.clamp(0, vl - 1)[..., None]
        gold = all_reduce(torch.where(mine, torch.gather(logits, -1, col)[..., 0], 0.0), "sum", groups)
        lse = torch.log(s) + m
        ctx.save_for_backward(logits, lse, col, mine)
        return lse - gold

    @staticmethod
    def backward(ctx, g):
        logits, lse, col, mine = ctx.saved_tensors
        grad = torch.exp(logits - lse[..., None]) * g[..., None]
        grad = grad.scatter_add(-1, col, torch.where(mine, -g, 0.0)[..., None])
        return grad, None, None, None, None


def _nll_vocab_parallel(logits: torch.Tensor, targets: torch.Tensor, vocab: int) -> torch.Tensor:
    """`_nll` of DTensor logits whose vocab is sharded, on each rank's
    (batch, vocab) shard (`_VocabParallelNll`); another sharding (of the
    sequence, or a partial sum) is gathered first.  Returns the (B, T) nll
    sharded as the batch."""
    from torch.distributed.tensor import DTensor, Replicate, distribute_tensor

    mesh, vdim = logits.device_mesh, logits.ndim - 1
    layout = tuple(p if p.is_shard(0) or p.is_shard(vdim) else Replicate() for p in logits.placements)
    if layout != tuple(logits.placements):
        logits = logits.redistribute(mesh, layout)
    rows = tuple(p if p.is_shard(0) else Replicate() for p in layout)
    if is_dtensor(targets):
        targets = (targets if tuple(targets.placements) == rows else targets.redistribute(mesh, rows)).to_local()
    else:
        targets = distribute_tensor(targets, mesh, rows, src_data_rank=None).to_local()
    # this rank's first column: each mesh dim that shards the vocab splits
    # the previous one's block in DTensor's chunks, mesh dims in order
    groups = [(mesh, i) for i, p in enumerate(layout) if p.is_shard(vdim)]
    lo, size, coord = 0, logits.shape[vdim], mesh.get_coordinate()
    for _, i in groups:
        block = -(-size // mesh.size(i))
        lo += coord[i] * block
        size = max(0, min(block, size - coord[i] * block))
    nll = _VocabParallelNll.apply(logits.to_local(), targets, lo, vocab, groups)
    shape = logits.shape[:-1]
    return DTensor.from_local(nll, mesh, rows, run_check=False, shape=shape,
                              stride=torch.empty(shape, device="meta").stride())


def _nll(logits: torch.Tensor, targets: torch.Tensor, vocab: int) -> torch.Tensor:
    """Next-token negative log-likelihood (B, T) from (B, T, Vpad) f32 logits.
    DTensor logits with the vocab sharded are taken vocab-parallel
    (`_nll_vocab_parallel`), others on each rank's batch shard with the
    vocab gathered (`shardctx.on_local_shards`)."""
    if is_dtensor(logits):
        if any(p.is_shard(logits.ndim - 1) for p in logits.placements):
            return _nll_vocab_parallel(logits, targets, vocab)
        return on_local_shards(lambda lg, tg: _nll(lg, tg, vocab), (logits, targets), [(0, None), (0, None)], (),
                               [(0, None)])
    logits = _masked_logits(logits, vocab)
    gold = torch.gather(logits, -1, targets[..., None].to(torch.int64))[..., 0]
    return torch.logsumexp(logits, dim=-1) - gold


def _ce_per_row(logits: torch.Tensor, targets: torch.Tensor, vocab: int) -> torch.Tensor:
    """Mean next-token cross-entropy per batch row.  logits (B, T, Vpad) f32."""
    return _nll(logits, targets, vocab).mean(dim=-1)


def _ce_per_row_chunked(params, cfg: ModelConfig, x: torch.Tensor, targets: torch.Tensor,
                        chunk: int = CE_CHUNK) -> torch.Tensor:
    """The cross-entropy over sequence chunks when T is a multiple of
    ``chunk`` above it, so the (B, T, Vpad) f32 logits never exist at once.
    Under ``cfg.scan_layers`` with grad mode on, each chunk is recomputed in
    the backward pass, as the reference wraps each in `jax.checkpoint`, so
    no chunk's logits stay alive for it."""
    b, t, _ = x.shape
    if t % chunk or t <= chunk:
        lg = constrain(layers.logits(params, cfg, x), "batch", "none", "tp")
        return _ce_per_row(lg, targets, cfg.vocab_size)

    def chunk_sum(xc, tc):
        lg = constrain(layers.logits(params, cfg, xc), "batch", "none", "tp")
        return _nll(lg, tc, cfg.vocab_size).sum(dim=-1)

    remat = cfg.scan_layers and torch.is_grad_enabled()
    total = torch.zeros((b,), dtype=torch.float32, device=x.device)
    for i in range(t // chunk):
        sl = slice(i * chunk, (i + 1) * chunk)
        total = total + (checkpointed(chunk_sum, x[:, sl], targets[:, sl]) if remat
                         else chunk_sum(x[:, sl], targets[:, sl]))
    return total / t


def _serving(fn: Callable) -> Callable:
    """Run ``fn(params, ...)`` under `torch.inference_mode`, or under
    `torch.no_grad` when the parameters are DTensors, which inference mode
    does not take."""

    @functools.wraps(fn)
    def wrapped(params, *args, **kwargs):
        with torch.no_grad() if is_dtensor(params["embed"]) else torch.inference_mode():
            return fn(params, *args, **kwargs)

    return wrapped


def build_model(cfg: ModelConfig, device="cuda") -> Model:
    """Raises if `device` names CUDA and there is no card, or the family is
    unknown.  `device` is where `init`, `prefill` and `init_cache` put
    their tensors; `loss_fn` runs on its inputs' device."""
    dev = resolve_device(device)
    transformer.check_family(cfg)
    is_encdec, is_vlm = cfg.family == "encdec", cfg.family == "vlm"
    enc_cfg = cfg.replace(family="dense")

    def init(generator: torch.Generator):
        """Random parameters on the model's device (`convert.init`)."""
        from repro_torch.checkpoint import convert  # convert imports this package

        return convert.init(cfg, generator, dev)

    def encode(params, frames: torch.Tensor) -> torch.Tensor:
        """The bidirectional encoder over stub frame embeddings (B, F, D):
        a dense stack of `cfg.encoder_layers`, then `enc_norm`.  Runs where
        ``frames`` lie."""
        x = frames.to(layers._dtype(cfg.compute_dtype))
        pos = torch.arange(x.shape[1], device=x.device)
        x, _ = transformer.run_stack_full(params["encoder"], enc_cfg, x, pos, causal=False,
                                          n_layers=cfg.encoder_layers)
        return layers.rmsnorm(params["enc_norm"], x)

    def prefix_embed(params, batch, device, enc_out=None):
        """Embed the tokens, put vlm's patches before them, and encode
        encdec's frames unless ``enc_out`` is given.  Returns (x, enc_out or
        None, number of patches)."""
        x = layers.embed(params, cfg, batch["tokens"].to(device))
        n_prefix = 0
        if is_vlm and "patches" in batch:
            patches = batch["patches"].to(device=device, dtype=x.dtype)
            x = torch.cat([patches, x], dim=1)
            n_prefix = patches.shape[1]
        if is_encdec and enc_out is None and "frames" in batch:
            enc_out = encode(params, batch["frames"].to(device))
        return x, enc_out, n_prefix

    def loss_fn(params, batch):
        """(per-row losses (B,) f32, {"ce": the mean CE, "moe_aux": the
        layers' summed load-balance loss}).  For moe every row also carries
        router_aux_weight * aux / B, as in the JAX package."""
        x, enc_out, n_prefix = prefix_embed(params, batch, batch["tokens"].device)
        x = constrain(x, "batch", "none", "none")
        pos = torch.arange(x.shape[1], device=x.device)
        x, aux = transformer.run_stack_full(params["layers"], cfg, x, pos, window=cfg.sliding_window,
                                            enc_out=enc_out)
        x = layers.rmsnorm(params["final_norm"], x)
        if n_prefix:
            x = x[:, n_prefix:]
        per_row = _ce_per_row_chunked(params, cfg, x, batch["targets"])
        per_row = constrain(per_row, "batch")
        metrics = {"ce": per_row.mean(), "moe_aux": aux}
        if cfg.family == "moe":
            per_row = per_row + cfg.router_aux_weight * aux / per_row.shape[0]
        return per_row, metrics

    @_serving
    def prefill(params, batch, *, window: Optional[int] = None, enc_out: Optional[torch.Tensor] = None):
        """Returns (last-position logits (B, Vpad) f32, cache).  vlm's
        cache holds the patches' positions before the tokens'.  encdec reads
        its memory from ``enc_out`` when the caller has encoded the frames
        (as serving does, once for prefill and every decode step), else
        from ``batch["frames"]``."""
        w = cfg.sliding_window if window is None else window
        x, enc_out, _ = prefix_embed(params, batch, dev, enc_out)
        pos = torch.arange(x.shape[1], device=dev)
        x, cache = transformer.run_stack_prefill(params["layers"], cfg, x, pos, window=w, enc_out=enc_out)
        x = layers.rmsnorm(params["final_norm"], x)
        lg = layers.logits(params, cfg, x[:, -1:])
        return lg[:, 0], cache

    @_serving
    def decode_step(params, token, cache, pos: int, *, window: int = 0, enc_out: Optional[torch.Tensor] = None,
                    frames: Optional[torch.Tensor] = None):
        """One token: token (B,1) int.  Returns (logits (B, Vpad) f32, cache),
        the cache updated in place.  encdec reads its memory from
        ``enc_out``, or encodes ``frames`` when ``enc_out`` is not given."""
        if is_encdec and enc_out is None and frames is not None:
            enc_out = encode(params, frames.to(dev))
        x = layers.embed(params, cfg, token.to(dev))
        x, cache = transformer.run_stack_decode(params["layers"], cache, cfg, x, pos, window=window, enc_out=enc_out)
        x = layers.rmsnorm(params["final_norm"], x)
        lg = layers.logits(params, cfg, x)
        return lg[:, 0], cache

    def init_cache(batch: int, cache_len: int, window: int = 0):
        return transformer.init_cache(cfg, batch, cache_len, window, device=dev)

    return Model(cfg=cfg, device=dev, init=init, loss_fn=loss_fn, prefill=prefill, decode_step=decode_step,
                 init_cache=init_cache, encode=encode)
