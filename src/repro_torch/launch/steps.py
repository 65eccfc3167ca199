"""The fastest-k train step: one call runs the paper's whole loop body on
the LM loss, as `repro/launch/steps.py` does.

    sample worker response times (straggler simulation) -> fastest-k mask ->
    per-row weighted loss -> gradient -> optimizer update -> renewal-clock
    advance -> controller update (k, Pflug's counters, the previous gradient)

The body comes from the same per-mode builders the simulation engines run
(`core.execmode.make_mode_steps`): the straggler draw, renewal residuals,
fastest-K ranking and mode bookkeeping are one implementation, with the LM
loss plugged in as the gradient closures and the optimizer through the
``apply_update`` hook.  ``mode`` selects sync fastest-k (the default),
K-async or K-batch-async; the async modes carry their renewal state
(parameter snapshots, residual clocks, staleness, pending) across calls in
``TrainState.exec_async``.

The step is one eager call, not mapped and not captured, so it takes its
gradients with `torch.autograd` on detached leaves, which lets ``cfg.remat``
recompute each block in the backward pass.  The gradients take the plain
path (``use_kernels=False``): neither package has a backward kernel, and
the reference trains with ``use_pallas=False``.  The eval forward after the
update runs under `torch.no_grad` with the model's own config, so on the
card it goes through the kernels, as serving does, and a kernel that fails
fails the step.

The step consumes its state: the parameters and the optimizer's moments
are updated in place (`Optimizer.apply`), as the reference's jit donates
its state to XLA.  A sync step holds no per-worker parameter snapshots.
"""

from __future__ import annotations

import inspect
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.core import aggregation, execmode
from repro_torch.launch import sharding
from repro_torch.launch.mesh import is_device_mesh
from repro_torch.launch.specs import window_for
from repro_torch.models.model import Model, build_model
from repro_torch.optim.optimizers import Optimizer

__all__ = ["TrainState", "init_train_state", "place_train_state", "per_row_loss_fn", "make_train_step",
           "make_prefill_step", "make_decode_step"]


class TrainState(NamedTuple):
    params: Any
    opt_state: Any
    ctrl_state: Any
    sim_time: torch.Tensor  # the renewal clock, f32 scalar
    step: torch.Tensor  # int32
    # The async modes' renewal state (worker_params, remaining, staleness,
    # pending), carried between steps; None in sync mode.
    exec_async: Any = None


def init_train_state(opt: Optimizer, controller, params, mesh=None) -> TrainState:
    """The state at step 0 around ``params`` (``model.init(generator)``, or
    the reference's weights through `params_from_jax`), on their device;
    under a DeviceMesh ``mesh``, placed by `place_train_state`.  Every rank
    passes the same whole ``params`` and keeps its own slice."""
    dev = tree_flatten(params)[0][0].device
    state = TrainState(
        params=params,
        opt_state=opt.init(params),
        ctrl_state=controller.init(params),
        sim_time=torch.zeros((), dtype=torch.float32, device=dev),
        step=torch.zeros((), dtype=torch.int32, device=dev),
    )
    return state if mesh is None else place_train_state(state, mesh)


def place_train_state(state: TrainState, mesh) -> TrainState:
    """The state under ``mesh``: the parameters, the optimizer's moments,
    the controller's parameter-shaped leaves (Pflug's prev_grad) and the
    async modes' per-worker snapshots are DTensors placed by
    `sharding.param_shardings`' leaf-name rules (`sharding.place_state`);
    scalars stay plain.  A no-op on a `launch.mesh.HostMesh`."""
    return state._replace(params=sharding.place_state(state.params, mesh),
                          opt_state=sharding.place_state(state.opt_state, mesh),
                          ctrl_state=sharding.place_state(state.ctrl_state, mesh),
                          exec_async=sharding.place_state(state.exec_async, mesh))


def per_row_loss_fn(model: Model) -> Callable:
    """``(params, tokens, targets) -> (rows,)`` over ``model.loss_fn``: the
    per-example signature `LMSource` and the stale gradients consume."""

    def per_row(params, tokens, targets):
        losses, _ = model.loss_fn(params, {"tokens": tokens, "targets": targets})
        return losses

    return per_row


def _grad(loss_of: Callable, params):
    """The gradient of the scalar ``loss_of(params)`` by `torch.autograd`,
    through detached leaves that share the parameters' storage."""
    leaves, spec = tree_flatten(params)
    xs = [p.detach().requires_grad_() for p in leaves]
    with torch.enable_grad():
        gs = torch.autograd.grad(loss_of(tree_unflatten(xs, spec)), xs)
    return tree_unflatten(list(gs), spec)


def _stale_grad_fns(per_row: Callable, toks_w: torch.Tensor, tgts_w: torch.Tensor, n_slots: int):
    """The async modes' ``(stale_grad, shard_grad_at)`` (see
    `execmode.make_stale_grad_fns`, whose arithmetic this is), one slot at a
    time through autograd instead of `torch.func.vmap` over the stack."""
    s = toks_w.shape[1]

    def at_slot(worker_params, i: int):
        return tree_map(lambda a: a[i], worker_params)

    def stale_grad(worker_params, mask, k):
        # slot i's term of the eq.-(2) loss dot(shard_sums, mask) / (k s),
        # differentiated at slot i's snapshot; the slots summed in f32
        denom = k.to(torch.float32) * s
        total = None
        for i in range(n_slots):
            g = _grad(lambda w: per_row(w, toks_w[i], tgts_w[i]).sum() * mask[i] / denom,
                      at_slot(worker_params, i))
            total = tree_map(lambda a: a.to(torch.float32), g) if total is None else tree_map(
                lambda a, b: a + b.to(torch.float32), total, g)
        return tree_map(lambda a, w: a.to(w.dtype), total, worker_params)

    def shard_grad_at(worker_params, i):
        i = int(i)
        return _grad(lambda w: per_row(w, toks_w[i], tgts_w[i]).mean(), at_slot(worker_params, i))

    return stale_grad, shard_grad_at


def make_train_step(
    model: Model,
    opt: Optimizer,
    controller,
    straggler,
    n_workers: int,
    comm: Optional[aggregation.CommModel] = None,
    n_micro: int = 1,
    mode: str = "sync",
    mesh=None,
) -> Callable[[TrainState, Dict[str, torch.Tensor], torch.Tensor], Tuple[TrainState, Dict]]:
    """``train_step(state, batch, key) -> (state, metrics)`` for a worker
    count and policy.  Workers are contiguous worker-major row shards of
    the batch (eq. (2): each participating worker contributes ``(1/k) *
    (1/s) * sum`` of its rows' gradients).  ``key`` is a `prng` key.

    ``n_micro > 1`` accumulates the gradient over microbatches (sync mode
    only): each worker's rows are split across microbatches, the worker-major
    layout kept inside each, and the f32 sum is the single-shot gradient up
    to rounding.  The first async call builds the renewal state from the
    parameters (n_workers snapshots).

    With a DeviceMesh ``mesh`` the step takes the state of
    `init_train_state(..., mesh=mesh)`: the batch is placed by
    `sharding.batch_shardings` and the step runs under
    `sharding.mesh_context` (the activation resolver, as the reference's
    train CLI installs it), so every product runs on DTensors and DTensor
    inserts the collectives.  The straggler draw, the ranking and k are
    plain tensors that every rank computes whole from the same key; the
    metrics come back as plain tensors.
    """
    if mode not in execmode.MODES:
        raise ValueError(f"unknown mode {mode!r}; options {sorted(execmode.MODES)}")
    if mode != "sync" and n_micro != 1:
        raise ValueError("gradient accumulation (n_micro > 1) is sync-only")
    mode_idx = execmode.MODES[mode]
    mesh = mesh if is_device_mesh(mesh) else None
    # Gradients take the plain path: the kernels are forward-only.
    grad_model = build_model(model.cfg.replace(use_kernels=False), model.device)
    per_row = per_row_loss_fn(grad_model)
    try:
        accepts_stats = len(inspect.signature(controller.update).parameters) >= 4
    except (TypeError, ValueError):  # builtins and other callables without a signature
        accepts_stats = True

    def ctrl_update(cstate, g, sim_time, stats):
        if accepts_stats:
            return controller.update(cstate, g, sim_time, stats)
        return controller.update(cstate, g, sim_time)

    def apply_update(params, g, opt_state):
        return opt.apply(g, opt_state, params)

    def draw(sub, sim_time):
        del sim_time
        return straggler.sample(sub, n_workers)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor], key: torch.Tensor):
        if mesh is None:
            return local_step(state, batch, key)
        with sharding.mesh_context(mesh):
            new_state, metrics = local_step(state, sharding.place_batch(batch, mesh), key)
        new_state = new_state._replace(ctrl_state=sharding.gathered_scalars(new_state.ctrl_state))
        return new_state, sharding.gathered(metrics)

    def local_step(state: TrainState, batch: Dict[str, torch.Tensor], key: torch.Tensor):
        b = batch["tokens"].shape[0]
        if b % n_workers:
            raise ValueError(f"batch {b} is not divisible by n_workers {n_workers}")
        rows_per_worker = b // n_workers

        def weighted_loss(batch_part, weights_part):
            def loss_of(params):
                losses, _ = grad_model.loss_fn(params, batch_part)
                return torch.sum(weights_part.to(losses.dtype) * losses)

            return loss_of

        def sync_grad(params, arrive_f, k):
            weights = aggregation.per_example_weights(arrive_f, k, rows_per_worker)
            if n_micro == 1:
                return _grad(weighted_loss(batch, weights), params)
            if rows_per_worker % n_micro:
                raise ValueError(f"{rows_per_worker} rows per worker do not split into {n_micro} microbatches")

            def to_micro(x):
                # (W*R, ...) -> (n_micro, W*R/n_micro, ...), worker-major inside each
                tail = tuple(x.shape[1:])
                x = x.reshape((n_workers, n_micro, rows_per_worker // n_micro) + tail).transpose(0, 1)
                return x.reshape((n_micro, n_workers * rows_per_worker // n_micro) + tail)

            micro_batch, micro_weights = tree_map(to_micro, batch), to_micro(weights)
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)
            for j in range(n_micro):
                g = _grad(weighted_loss({kk: v[j] for kk, v in micro_batch.items()}, micro_weights[j]), params)
                grads = tree_map(lambda a, gi: a + gi.to(torch.float32), grads, g)
            return grads

        if mode == "sync":
            stale_grad = shard_grad_at = None
        else:
            extra = set(batch) - {"tokens", "targets"}
            if extra:
                raise ValueError(f"async modes support tokens/targets batches only; got extra keys {sorted(extra)}")
            shard = (n_workers, rows_per_worker)
            stale_grad, shard_grad_at = _stale_grad_fns(
                per_row, batch["tokens"].reshape(shard + tuple(batch["tokens"].shape[1:])),
                batch["targets"].reshape(shard + tuple(batch["targets"].shape[1:])), n_workers)

        steps = execmode.make_mode_steps(
            n_slots=n_workers, draw=draw, sync_grad=sync_grad, stale_grad=stale_grad, shard_grad_at=shard_grad_at,
            comm_time=comm.time if comm is not None else None,
            eta=0.0,  # unused: apply_update supersedes the default SGD map
            ctrl_update=ctrl_update, apply_update=apply_update,
        )

        dev = key.device
        if mode == "sync":
            # the sync tail reads no snapshot, so the carry holds none (the
            # reference's XLA drops the n_workers copies it builds)
            carry = execmode.ExecCarry(
                params=state.params, worker_params=None,
                remaining=torch.zeros((n_workers,), dtype=torch.float32, device=dev),
                staleness=torch.zeros((n_workers,), dtype=torch.int32, device=dev),
                pending=torch.zeros((n_workers,), dtype=torch.bool, device=dev),
                ctrl_state=state.ctrl_state, sim_time=state.sim_time, key=key, opt_state=state.opt_state)
        elif state.exec_async is None:
            carry = execmode.init_exec_carry(state.params, n_workers, state.ctrl_state, key,
                                             opt_state=state.opt_state)._replace(sim_time=state.sim_time)
        else:
            worker_params, remaining, staleness, pending = state.exec_async
            carry = execmode.ExecCarry(params=state.params, worker_params=worker_params, remaining=remaining,
                                       staleness=staleness, pending=pending, ctrl_state=state.ctrl_state,
                                       sim_time=state.sim_time, key=key, opt_state=state.opt_state)
        new_carry, k_used = steps[mode_idx](carry)

        # the eval forward: the logged loss and ce are the new parameters'
        with torch.no_grad():
            per_row_eval, metrics = model.loss_fn(new_carry.params, batch)
        out_metrics = {
            "loss": per_row_eval.mean(),
            "ce": metrics["ce"],
            "k": k_used,
            "iter_time": new_carry.sim_time - state.sim_time,
            "sim_time": new_carry.sim_time,
            "active_workers": k_used,
        }
        exec_async = None if mode == "sync" else (new_carry.worker_params, new_carry.remaining,
                                                  new_carry.staleness, new_carry.pending)
        new_state = TrainState(params=new_carry.params, opt_state=new_carry.opt_state,
                               ctrl_state=new_carry.ctrl_state, sim_time=new_carry.sim_time,
                               step=state.step + 1, exec_async=exec_async)
        return new_state, out_metrics

    return train_step


def make_prefill_step(model: Model, cfg: ModelConfig, shape: InputShape, mesh=None):
    """``prefill_step(params, batch)``: the model's prefill at the input
    shape's attention window (`specs.window_for`).  Under a DeviceMesh
    ``mesh`` the parameters are those of `sharding.place_state`, the batch
    is placed by `sharding.batch_shardings`, the prefill runs under
    `sharding.mesh_context`, and the returned cache is placed by
    `batch_shardings` too (DTensor logits and cache)."""
    w = window_for(cfg, shape)
    mesh = mesh if is_device_mesh(mesh) else None

    def prefill_step(params, batch):
        if mesh is None:
            return model.prefill(params, batch, window=w)
        with sharding.mesh_context(mesh):
            logits, cache = model.prefill(params, sharding.place_batch(batch, mesh), window=w)
            return logits, sharding.place_batch(cache, mesh)

    return prefill_step


def make_decode_step(model: Model, cfg: ModelConfig, shape: InputShape, mesh=None):
    """``decode_step(params, token, cache, pos, **extras)``: one decode step
    at the input shape's attention window; ``extras`` are encdec's
    ``enc_out`` or ``frames``.  Under a DeviceMesh ``mesh`` the token,
    the cache and the extras are placed by `sharding.batch_shardings` and
    the step runs under `sharding.mesh_context`; the cache is updated in
    place, shard by shard."""
    w = window_for(cfg, shape)
    mesh = mesh if is_device_mesh(mesh) else None

    def decode_step(params, token, cache, pos, **extras):
        if mesh is None:
            return model.decode_step(params, token, cache, pos, window=w, **extras)
        with sharding.mesh_context(mesh):
            placed = sharding.place_batch({"token": token, "cache": cache, **extras}, mesh)
            token, cache = placed.pop("token"), placed.pop("cache")
            return model.decode_step(params, token, cache, pos, window=w, **placed)

    return decode_step
