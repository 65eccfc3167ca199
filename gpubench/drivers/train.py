"""Training traffic: the port's fastest-k train step
(`launch/steps.py::make_train_step`) called step after step on fresh
batches.

Set-up builds the model, makes the weights from the seed on the device
(keeping a copy of them), builds the optimizer, the controller and the
straggler model of the traffic file, and runs the first ``setup_steps``
steps through the same call and feed as the window; their rows all differ.
Those steps are what the plain reference (`reference.train_ref`) follows
once the window has closed and the program's state is freed: each step's
k, clock and loss, each leaf's first gradient as the optimizer holds it
(AdamW's first moment after one step, over 1 - b1) and each leaf's change
after the last set-up step.  The window's steps, which Pflug's test drives
once its burn-in has passed, are held to the reference's rule, draw and
clock step by step (`train_ref.window_departures`).
"""

from __future__ import annotations

import dataclasses
import statistics

import torch

from gpubench import flops, weights
from gpubench.bench import BenchError, Check, Outcome, Record, window
from gpubench.drivers import lm
from gpubench.reference import precision, train_ref

# a leaf whose reference gradient is below this share of the median leaf's
# moves under AdamW by round-off alone, and is left out of the change
SILENT_LEAF = 1e-3


def _leaf_gaps(prog: dict, ref: dict, keep=None) -> dict:
    """Each leaf's |prog norm - ref norm| over the larger of its reference
    norm and the median leaf's."""
    paths = [p for p in ref if keep is None or p in keep]
    median = statistics.median(ref[p] for p in paths)
    return {p: abs(prog[p] - ref[p]) / max(ref[p], median) for p in paths}


def moving_leaves(ref: dict) -> set:
    grads = ref["grad_norms"]
    median = statistics.median(grads.values())
    return {p for p, g in grads.items() if g >= SILENT_LEAF * median}


def compare(prog: dict, ref: dict) -> dict:
    """The compared numbers: steps whose k differs, the clock's and the
    logged loss's largest relative gaps, and the worst leaf's gap of the
    first gradient's norm and of the change's norm (leaves that only
    round-off moves left out of the change)."""
    grads = ref["grad_norms"]
    finite = all(map(lambda v: v == v and abs(v) != float("inf"), prog["loss"] + prog["sim_time"]))
    return {
        "k_mismatch": float(sum(a != b for a, b in zip(prog["k"], ref["k"]))),
        "sim_time_gap": max(abs(a - b) / abs(b) for a, b in zip(prog["sim_time"], ref["sim_time"])),
        "loss_gap": max(abs(a - b) / abs(b) for a, b in zip(prog["loss"], ref["loss"])) if finite else float("inf"),
        "grad_norm_gap": max(_leaf_gaps(prog["grad_norms"], grads).values()),
        "change_norm_gap": max(_leaf_gaps(prog["change_norms"], ref["change_norms"], moving_leaves(ref)).values()),
    }


def run(ctx) -> Outcome:
    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    precision.no_tf32()
    gen = torch.Generator(device=dev).manual_seed(ctx.seed)
    b, t, n = tr["batch"], tr["seq"], tr["n_workers"]
    oc, cc, rate = tr["optimizer"], tr["controller"], tr["straggler"]["rate"]
    if (oc["name"], cc["name"], tr["straggler"]["family"]) != ("adamw", "pflug", "exponential"):
        raise BenchError("this driver runs AdamW, Pflug's controller and Exponential times")
    params = weights.make_params(cfg, gen, dev)
    p0 = {path: x.clone() for path, x in weights.leaves(params).items()}

    def feed():
        tokens, targets = weights.markov_tokens(b, t, cfg["vocab_size"], gen, dev, tr["follow_p"])
        key = torch.randint(0, 2**32, (2,), generator=gen, device=dev, dtype=torch.int64)
        return (tokens, targets), key

    setup_feed = [feed() for _ in range(tr["setup_steps"])]
    counters: dict = {}
    if ctx.control is not None:
        # the reference at a lower precision in the program's place; training's
        # readings need no window
        prog = train_ref.train(p0, cfg, [f for f, _ in setup_feed], [k for _, k in setup_feed], n, rate, cc, oc,
                               ctx.control)
        ctx.window_opens()
        steps, elapsed, peak, window_departed, switches, n_window = 0, 1.0, 0, 0, 0, 0
    else:
        from repro_torch.core.aggregation import CommModel
        from repro_torch.core.controller import PflugController
        from repro_torch.core.straggler import Exponential
        from repro_torch.launch import steps as steps_lib
        from repro_torch.optim.optimizers import Optimizer, adamw

        model = lm.program_model(cfg, dev)
        opt = adamw(oc["lr"], weight_decay=oc["weight_decay"], b1=oc["b1"], b2=oc["b2"], eps=oc["eps"])
        if ctx.fault not in (None, "unchanged", "half_batch", "draw", "k_stuck"):
            raise BenchError(f"unknown fault {ctx.fault!r}")

        def apply(grads, state, params_):
            with ctx.span("opt_apply"):
                if ctx.fault == "unchanged":  # a step that returns its state unchanged
                    return params_, state
                return opt.apply(grads, state, params_)

        opt_w = Optimizer(init=opt.init, update=opt.update, apply=apply)
        controller = PflugController(n_workers=n, k0=cc["k0"], step=cc["step"], thresh=cc["thresh"],
                                     burnin=cc["burnin"], k_max=cc.get("k_max"))
        # the draw fault moves the straggler's rate by one part in a million
        drawn = rate * (1 + 1e-6) if ctx.fault == "draw" else rate
        step_fn = steps_lib.make_train_step(model, opt_w, controller, Exponential(rate=drawn), n, CommModel())
        state = steps_lib.init_train_state(opt_w, controller, params)

        def call(batch, key):
            tokens, targets = batch
            if ctx.fault == "half_batch":  # half of the rows left out, the mean over the rest
                tokens, targets = tokens[: b // 2], targets[: b // 2]
            return step_fn(state, {"tokens": tokens, "targets": targets}, key)

        prog = {"loss": [], "k": [], "sim_time": []}
        for i, (batch, key) in enumerate(setup_feed):
            state, m = call(batch, key)
            prog["loss"].append(float(m["loss"]))
            prog["k"].append(int(m["k"]))
            prog["sim_time"].append(float(m["sim_time"]))
            if i == 0:
                prog["grad_norms"] = {path: float(mu.float().norm()) / (1 - oc["b1"])
                                      for path, mu in weights.leaves(state.opt_state.mu).items()}
        prog["change_norms"] = {path: float((x.float() - p0[path].float()).norm())
                                for path, x in weights.leaves(state.params).items()}
        if ctx.fault == "k_stuck":  # from the window on, the controller never raises k
            stuck = dataclasses.replace(controller, k_max=int(state.ctrl_state.k))
            step_fn = steps_lib.make_train_step(model, opt_w, stuck, Exponential(rate=drawn), n, CommModel())

        def after(m):
            """The step's k used and the controller and clock it left, on the
            device until the window has closed."""
            cs = state.ctrl_state
            return (m["k"], cs.k, cs.count_negative, cs.count_iter, m["sim_time"])

        start = (state.ctrl_state.k, state.ctrl_state.count_negative, state.ctrl_state.count_iter, state.sim_time)

        def one():
            nonlocal state
            batch, key = feed()
            with ctx.span("step"):
                state, m = call(batch, key)
                m["loss"].item()
            return key, after(m)

        done, walls, elapsed = window(ctx, one, tr["trace_steps"])
        steps = len(walls)
        if ctx.tracer is not None:
            counters["untraced_flops_per_s"] = steps * b * t * flops.train_flops_per_token(cfg, t) / sum(walls)
        peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
        n_window = len(done)
        read = [tuple(x.item() for x in a) for _, a in done]
        start = tuple(x.item() for x in start)
        window_departed = train_ref.window_departures(start, read, torch.stack([key for key, _ in done]), n, rate, cc)
        ks = [start[0]] + [r[1] for r in read]
        switches = sum(a != b_ for a, b_ in zip(ks, ks[1:]))
        del state, step_fn, model, params
        if dev.type == "cuda":
            torch.cuda.empty_cache()

    ref = train_ref.train(p0, cfg, [f for f, _ in setup_feed], [k for _, k in setup_feed], n, rate, cc, oc)
    got = {**compare(prog, ref), "window_steps_departed": float(window_departed)}
    grad_gaps = _leaf_gaps(prog["grad_norms"], ref["grad_norms"])
    change_gaps = _leaf_gaps(prog["change_norms"], ref["change_norms"], moving_leaves(ref))
    info = {"worst_grad_leaf": max(grad_gaps, key=grad_gaps.get),
            "worst_change_leaf": max(change_gaps, key=change_gaps.get),
            "silent_leaves": sorted(set(ref["grad_norms"]) - moving_leaves(ref)),
            "window_steps": n_window, "window_k_switches": switches}
    if ctx.detail:
        info.update(grad_gaps=grad_gaps, change_gaps=change_gaps, ref_grad_norms=ref["grad_norms"])
    checks = [Check(name, value, ctx.limit(name)) for name, value in got.items()]
    return Outcome(metrics={"train_tokens_per_s": steps * b * t / elapsed}, attempted=steps, failed=0,
                   checks=checks, record=Record(ctx.tracer.trace if ctx.tracer else None, counters),
                   memory_peak_bytes=int(peak), info=info)
