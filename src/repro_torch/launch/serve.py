"""Serve a batch of prompts: prefill, then greedy decode against the cache.

The port of `examples/serve_decode.py`, on the card by default:

    PYTHONPATH=src python -m repro_torch.launch.serve --batch 4 --prompt-len 1024 --new-tokens 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-3b --batch 4 --prompt-len 1024 --new-tokens 32
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-3b --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-moe-30b-a3b --batch 4 --prompt-len 1024
    PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b --batch 4 --prompt-len 2048 --window 1024
    PYTHONPATH=src python -m repro_torch.launch.serve --arch paligemma-3b --smoke --device cpu --prompt-len 112

Weights are random, drawn on the device from `--seed`; prompts from
`--seed + 1`.  vlm's patches and encdec's frames are the frontend stubs,
zeros as the JAX package's example feeds them (`specs.stub_inputs`).  For
the attention families, every prefill layer's causal self-attention over a
multiple of 128 positions (vlm: patches and prompt) runs through the
flash-attention kernel; encdec's encoder and cross-attention take the plain
path, as in the JAX package.  For rwkv6-3b every prefill layer of more than
one token runs its wkv scan through the wkv6 kernel, and decode steps the
recurrent state.
"""

from __future__ import annotations

import argparse
import time
from typing import NamedTuple

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import convert
from repro_torch.configs import ModelConfig, get_config, get_smoke_config, list_archs
from repro_torch.launch import sharding
from repro_torch.launch.mesh import is_device_mesh
from repro_torch.launch.specs import stub_inputs
from repro_torch.models import Model, build_model


class ServeResult(NamedTuple):
    tokens: torch.Tensor  # (B, new_tokens) greedy tokens, the first from the prefill
    prefill_logits: torch.Tensor  # (B, Vpad) f32, last prompt position
    prefill_s: float
    decode_s: float  # the new_tokens - 1 decode steps


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _generator(seed: int, dev: torch.device) -> torch.Generator:
    return torch.Generator(device=dev).manual_seed(seed)


def random_prompts(cfg: ModelConfig, batch: int, prompt_len: int, seed: int, device="cuda") -> torch.Tensor:
    dev = resolve_device(device)
    return torch.randint(0, cfg.vocab_size, (batch, prompt_len), generator=_generator(seed, dev), device=dev)


def _grow_kv_cache(model: Model, cache: dict, batch: int, total: int, window: int, mesh=None) -> dict:
    """The prefill KV cache copied into one of `total` positions (or the
    ring of `window` slots); the prefill cache itself when that is no longer.
    Only k and v grow: hybrid's SSM state goes through as it is.  Under a
    mesh the grown cache is the prefill cache and zeros joined along the
    sequence, placed by `sharding.batch_shardings`."""
    s = cache["k"].shape[2]
    full = model.init_cache(batch, total, window)
    if full["k"].shape[2] <= s:
        return cache
    if mesh is not None:
        full = sharding.place_batch(full, mesh)
        grown = {kk: torch.cat([cache[kk], full[kk][:, :, s:]], dim=2) for kk in ("k", "v")}
        return sharding.place_batch({**cache, **grown}, mesh)
    for kk in ("k", "v"):
        full[kk][:, :, :s] = cache[kk]
    return {**cache, "k": full["k"], "v": full["v"]}


def generate(model: Model, params: dict, prompts: torch.Tensor, new_tokens: int,
             *, window: int = 0, patches: torch.Tensor | None = None,
             frames: torch.Tensor | None = None, mesh=None) -> ServeResult:
    """`_generate` under `torch.inference_mode`; under a DeviceMesh
    ``mesh``, with the parameters placed by `sharding.place_state` (every
    rank passes the same whole ``params`` and prompts, or the placed
    DTensors), the prompts, stubs and caches by `sharding.batch_shardings`,
    all under `sharding.mesh_context` and `torch.no_grad`; the tokens and
    logits come back whole on every rank."""
    if not is_device_mesh(mesh):
        with torch.inference_mode():
            return _generate(model, params, prompts, new_tokens, window=window, patches=patches, frames=frames)
    with torch.no_grad(), sharding.mesh_context(mesh):
        placed = sharding.place_batch({"tokens": prompts, "patches": patches, "frames": frames}, mesh)
        res = _generate(model, sharding.place_state(params, mesh), placed["tokens"], new_tokens, window=window,
                        patches=placed["patches"], frames=placed["frames"], mesh=mesh)
        return res._replace(tokens=sharding.gathered(res.tokens),
                            prefill_logits=sharding.gathered(res.prefill_logits))


def _generate(model: Model, params: dict, prompts: torch.Tensor, new_tokens: int,
              *, window: int = 0, patches: torch.Tensor | None = None,
              frames: torch.Tensor | None = None, mesh=None) -> ServeResult:
    """Prefill `prompts` (B, T), then take new_tokens - 1 greedy decode steps.

    A KV cache (dense, moe, hybrid, vlm, encdec) is copied into a cache
    preallocated for all P + T + new_tokens positions (P the vlm patches
    put before the prompt, else 0; or the ring of `window` slots), which
    the decode steps then update in place, step i at position P + T + i;
    hybrid's SSM state goes through as it is.  encdec's frames are encoded
    once, and that memory serves the prefill and every decode step.  The
    ssm family's prefill state is its decode cache as it is, and `window`
    has no effect on it, as in the JAX package.  argmax takes the first of
    equal maxima, as jnp.argmax does."""
    dev = model.device
    b, t = prompts.shape
    batch = {"tokens": prompts}
    if patches is not None:
        batch["patches"] = patches
    n_prefix = patches.shape[1] if patches is not None and model.cfg.family == "vlm" else 0

    t0 = time.perf_counter()
    enc_out = model.encode(params, frames.to(dev)) if frames is not None and model.cfg.family == "encdec" else None
    logits, cache = model.prefill(params, batch, window=window, enc_out=enc_out)
    if mesh is not None:
        cache = sharding.place_batch(cache, mesh)
    if model.cfg.family != "ssm":
        cache = _grow_kv_cache(model, cache, b, n_prefix + t + new_tokens, window, mesh)
    _sync(dev)
    prefill_s = time.perf_counter() - t0

    token = torch.argmax(logits, dim=-1)[:, None]
    generated = [token]
    t0 = time.perf_counter()
    for i in range(new_tokens - 1):
        step_logits, cache = model.decode_step(params, token, cache, n_prefix + t + i, window=window,
                                               enc_out=enc_out)
        token = torch.argmax(step_logits, dim=-1)[:, None]
        generated.append(token)
    _sync(dev)
    decode_s = time.perf_counter() - t0
    return ServeResult(torch.cat(generated, dim=1), logits, prefill_s, decode_s)


def serve(cfg: ModelConfig, *, batch: int, prompt_len: int, new_tokens: int, window: int = 0,
          seed: int = 0, device="cuda", patches: torch.Tensor | None = None,
          frames: torch.Tensor | None = None) -> ServeResult:
    """Build the model, draw weights from `seed` and prompts from `seed + 1`,
    and generate (with vlm's `patches` or encdec's `frames`, if given)."""
    model = build_model(cfg, device)
    params = convert.init(cfg, _generator(seed, model.device), model.device)
    prompts = random_prompts(cfg, batch, prompt_len, seed + 1, model.device)
    return generate(model, params, prompts, new_tokens, window=window, patches=patches, frames=frames)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="llama3.2-3b", choices=list_archs())
    ap.add_argument("--smoke", action="store_true", help="use the reduced smoke config (CPU-runnable)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--window", type=int, default=0,
                    help="sliding-window prefill and decode (0 = full attention; no effect on rwkv6-3b)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    res = serve(cfg, batch=args.batch, prompt_len=args.prompt_len, new_tokens=args.new_tokens,
                window=args.window, seed=args.seed, device=args.device,
                **stub_inputs(cfg, args.batch, resolve_device(args.device)))
    b, steps = args.batch, args.new_tokens - 1
    print(f"prefill {b}x{args.prompt_len}: {res.prefill_s:.2f}s")
    print(f"decoded {steps} steps x batch {b} in {res.decode_s:.2f}s "
          f"({steps * b / max(res.decode_s, 1e-9):.1f} tok/s)")
    print("sample token ids:", res.tokens[0, :16].tolist())


if __name__ == "__main__":
    main()
