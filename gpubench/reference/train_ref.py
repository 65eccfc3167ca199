"""Plain reference of the fastest-k train step on a language model.

One step, as the paper's method runs it on an LM loss (eq. (2) with
Algorithm 1's controller), with AdamW:

    key -> its second half draws the n workers' Exponential(rate) times
    (`threefry.exponential_times`); the k fastest workers' rows (worker i
    owns rows [i s, (i + 1) s)) weigh 1 / (k s), the others 0;
    g = gradient of sum_r w_r loss_r, the rows' losses from
    `moe_lm.row_losses` in float32;
    AdamW (moments in float32; b ** step in float32; the decay decoupled):
        m = b1 m + (1 - b1) g,  v = b2 v + (1 - b2) g^2,
        p = (p - lr (m / bc1) / (sqrt(v / bc2) + eps) - lr wd p) in p's dtype;
    clock += the k-th fastest time; Pflug's test on sign(g . g_prev)
    decides the next k after the burn-in (`pflug_rule`);
    the logged loss is the mean row loss at the new parameters.

`window_departures` holds the steps of a measured window, which the
reference does not recompute, to the same rule, draw and clock.

Parameters are stored in the configuration's dtype and computed in float32.
"""

from __future__ import annotations

import torch

from gpubench.reference import moe_lm, threefry


def _nest(flat: dict) -> dict:
    tree: dict = {}
    for path, t in flat.items():
        node = tree
        *parents, name = path.split(".")
        for part in parents:
            node = node.setdefault(part, {})
        node[name] = t
    return tree


def pflug_rule(k: int, count_neg: int, count_iter: int, event: int, ctrl: dict, k_cap: int) -> tuple:
    """Algorithm 1's counters (k, count_neg, count_iter) after one sign
    event: +1 for a negative g . g_prev, -1 for a non-negative one, 0 before
    there is a previous gradient."""
    count_neg += event
    if count_neg > ctrl["thresh"] and count_iter > ctrl["burnin"] and k + ctrl["step"] <= k_cap:
        return k + ctrl["step"], 0, 1
    return k, count_neg, count_iter + 1


def window_departures(start: tuple, steps: list, keys: torch.Tensor, n_workers: int, rate: float, ctrl: dict) -> int:
    """Steps of a window whose controller or clock departs from the
    reference.  ``start``: the program's (k, count_neg, count_iter, clock)
    before the first; ``steps``: its (k used, k, count_neg, count_iter,
    clock) after each; ``keys``: (S, 2) the steps' keys.  A step departs
    where it used another k than its controller held, where its clock is not
    the last one plus the k-th fastest of the reference's draw (float32,
    exact), or where no sign event (+1 or -1: the sign of g . g_prev is the
    program's own, the window's gradients are not recomputed) takes the
    counters from the last step's to this one's by `pflug_rule`.  Each step
    is judged from the program's state before it, so a departure counts
    once."""
    if not steps:
        return 0
    k_cap = ctrl.get("k_max") or n_workers
    used = torch.tensor([s[0] for s in steps], device=keys.device)
    times = threefry.exponential_times(threefry.split(keys)[:, 1, :], n_workers, rate)
    kth = threefry.fastest_k(times, used)[1].tolist()
    departed, (k, c, i, clock) = 0, start
    for (k_used, *after, clock_after), t in zip(steps, kth):
        ok = k_used == k
        ok &= float(torch.tensor(clock, dtype=torch.float32) + torch.tensor(t, dtype=torch.float32)) == clock_after
        ok &= any(pflug_rule(k, c, i, e, ctrl, k_cap) == tuple(after) for e in (-1, 1))
        departed += not ok
        (k, c, i), clock = after, clock_after
    return departed


def train(params0: dict, cfg: dict, batches: list, keys: list, n_workers: int, rate: float, ctrl: dict, opt: dict,
          pr: str = "fp32") -> dict:
    """Run len(batches) steps from ``params0`` ({dotted path: tensor}, left
    unchanged).  Returns {"loss", "k", "sim_time"} a step, "grad_norms" of the
    first step and "change_norms" after the last, {path: float} each."""
    P = {path: t.clone() for path, t in params0.items()}
    dev = next(iter(P.values())).device
    mu = {path: torch.zeros(t.shape, dtype=torch.float32, device=dev) for path, t in P.items()}
    nu = {path: torch.zeros(t.shape, dtype=torch.float32, device=dev) for path, t in P.items()}
    prev = {path: torch.zeros(t.shape, dtype=torch.float32, device=dev) for path, t in P.items()}
    k, count_neg, count_iter, have_prev = ctrl["k0"], 0, 1, False
    k_cap = ctrl.get("k_max") or n_workers
    b1, b2, eps, lr, wd = opt["b1"], opt["b2"], opt["eps"], opt["lr"], opt["weight_decay"]
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)  # noqa: E731
    clock = f32(0.0)
    out = {"loss": [], "k": [], "sim_time": []}
    for step, ((tokens, targets), key) in enumerate(zip(batches, keys), start=1):
        times = threefry.exponential_times(threefry.split(key)[1], n_workers, rate)
        mask, kth = threefry.fastest_k(times, torch.tensor(k, device=dev))
        s = tokens.shape[0] // n_workers
        w_rows = (mask / (k * s)).repeat_interleave(s)
        W = {path: t.to(torch.float32, copy=True).requires_grad_() for path, t in P.items()}
        with torch.enable_grad():
            loss = (w_rows * moe_lm.row_losses(_nest(W), cfg, tokens, targets, pr, checkpoint=True)).sum()
            grads = dict(zip(W, torch.autograd.grad(loss, list(W.values()))))
        del W, loss
        bc1 = 1 - torch.pow(f32(b1), f32(step))
        bc2 = 1 - torch.pow(f32(b2), f32(step))
        grads = {path: g.detach() for path, g in grads.items()}
        for path, g in grads.items():
            mu[path] = b1 * mu[path] + (1 - b1) * g
            nu[path] = b2 * nu[path] + (1 - b2) * g * g
            p32 = P[path].float()
            u = -lr * (mu[path] / bc1) / (torch.sqrt(nu[path] / bc2) + eps) - lr * wd * p32
            P[path] = (p32 + u).to(P[path].dtype)
        clock = clock + kth
        dot = sum(float((g * prev[path]).sum()) for path, g in grads.items())
        event = (1 if dot < 0 else -1) if have_prev else 0
        k_used = k
        k, count_neg, count_iter = pflug_rule(k, count_neg, count_iter, event, ctrl, k_cap)
        prev, have_prev = grads, True
        if step == 1:
            out["grad_norms"] = {path: float(g.norm()) for path, g in grads.items()}
        with torch.no_grad():
            evals = moe_lm.row_losses(_nest(P), cfg, tokens, targets, pr)
        out["loss"].append(float(evals.mean()))
        out["k"].append(int(k_used))
        out["sim_time"].append(float(clock))
    out["change_norms"] = {path: float((P[path].float() - params0[path].float()).norm()) for path in P}
    return out
