"""LMSource: a registered LM architecture's loss as the engines' gradient source.

The port of `repro/launch/lm_source.py`: the adaptive fastest-k machinery
(every controller, every execution mode, both engines) around a real model
loss instead of the quadratic toy.  The source wraps ``model.loss_fn``
(per-row next-token cross-entropy) behind the per-example interface the
engines consume:

  * workers are contiguous worker-major row shards of one token batch
    (``data = (tokens, targets)``, both (rows, seq_len) int32), the
    partition `launch.steps.make_train_step` trains with;
  * the eq.-(2) aggregate, the stale shard gradients and the eval CE all
    delegate to `PerExampleSource` over `steps.per_row_loss_fn`, so the
    engines and the train step share one loss path;
  * the model is memoised per (arch, smoke, overrides), and ``cache_token``
    carries that triple.

The engines map the closures over their lanes with `torch.func.vmap`, which
a kernel launched through ctypes cannot take, so the source always runs the
plain path (``use_kernels=False``), as the reference's runs with
``use_pallas=False``; a config with ``remat`` on raises there
(`transformer.checkpointed`).  The smoke configs have it off.

Typical use (fig_lm, `launch/quickstart.py --setup lm`)::

    src = LMSource(arch="qwen1.5-0.5b", smoke=True, overrides=(("n_layers", 2), ("d_model", 64)))
    params0 = src.init_params(prng.PRNGKey(0))
    data = src.make_data(n_rows=32, seq_len=32, seed=0)
    result = run_sweep_source(src, params0, data, n_workers=16, cases=cases, num_iters=600, key=key,
                              n_replicas=8, eval_every=30)
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Hashable, Tuple

import torch
from torch.utils._pytree import tree_map

from repro_torch import resolve_device
from repro_torch.checkpoint import convert
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import prng
from repro_torch.core.gradsource import PerExampleSource, SourceFns
from repro_torch.data import TokenStream
from repro_torch.launch.steps import per_row_loss_fn
from repro_torch.models import Model, build_model

__all__ = ["LMSource"]


@functools.lru_cache(maxsize=8)
def _model_for(arch: str, smoke: bool, overrides: Tuple[Tuple[str, Any], ...]) -> Model:
    """One model per configuration, so equal sources share their loss.  Its
    `loss_fn` runs on its inputs' device; the source makes its parameters
    and data on the device it is given, so the model is built on the CPU."""
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    return build_model(cfg.replace(**dict(overrides), use_kernels=False), device="cpu")


@dataclasses.dataclass(frozen=True)
class LMSource:
    """GradSource over a registered architecture's per-row CE loss.
    ``overrides`` is a tuple of ``(field, value)`` pairs applied to the
    (smoke) config, a hashable knob to shrink it."""

    arch: str = "qwen1.5-0.5b"
    smoke: bool = True
    overrides: Tuple[Tuple[str, Any], ...] = ()

    @property
    def model(self) -> Model:
        return _model_for(self.arch, self.smoke, self.overrides)

    def _delegate(self) -> PerExampleSource:
        return PerExampleSource(per_row_loss_fn(self.model))

    def check(self, data, n_workers: int) -> None:
        tokens, targets = data
        if tokens.shape != targets.shape:
            raise ValueError(f"tokens {tuple(tokens.shape)} and targets {tuple(targets.shape)} disagree")
        self._delegate().check(data, n_workers)

    def build(self, data, n_workers: int) -> SourceFns:
        return self._delegate().build(data, n_workers)

    def build_stale(self, data, n_workers: int):
        return self._delegate().build_stale(data, n_workers)

    def cache_token(self) -> Hashable:
        return ("lm", self.arch, self.smoke, self.overrides)

    def init_params(self, key, device="cuda"):
        """Random parameters on ``device`` from a `torch.Generator` (on that
        device) or a `prng` key, whose two words seed a CPU generator: a key
        gives the same parameters on every device.  JAX's bits are not
        reproduced: `params_from_jax` carries them."""
        dev = resolve_device(device)
        if isinstance(key, torch.Generator):
            return convert.init(self.model.cfg, key, dev)
        k0, k1 = (int(w) for w in prng.as_key(key).reshape(2))
        params = convert.init(self.model.cfg, torch.Generator().manual_seed((k0 << 32) | k1), "cpu")
        return tree_map(lambda a: a.to(dev), params)

    def params_from_jax(self, tree, device="cuda"):
        """The JAX package's parameters (numpy leaves) on ``device``, bits kept."""
        return convert.params_from_jax(tree, device)

    def make_data(self, n_rows: int, seq_len: int, seed: int = 0, device="cuda"):
        """One deterministic token batch ``(tokens, targets)`` of shape
        (n_rows, seq_len) on ``device``, worker-major shardable."""
        stream = TokenStream(vocab_size=self.model.cfg.vocab_size, seq_len=seq_len, global_batch=n_rows,
                             seed=seed, device=device)
        return stream.batch_at(0)
