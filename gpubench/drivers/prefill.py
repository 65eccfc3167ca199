"""Prefill traffic: one client in a closed loop, each request one
`serve.generate` call with ``new_tokens`` tokens on a batch of prompts of
one length.

Each seed serves the same mix: the lengths of the traffic file in rounds,
every length once a round, in an order shuffled from the seed; prompts are
uniform token ids from the seed.  Set-up builds the model, makes the
weights from the seed on the device and serves one request of every
length.  A request's time to first token runs from its send to its first
token's logits on the host.  Once the window has closed, a sample of the
finished requests drawn from the seed, the longest length among them, is
run again by the plain reference (`reference.moe_lm`) and the served
logits compared.
"""

from __future__ import annotations

import random
import statistics
import time

import torch

from gpubench import flops, weights
from gpubench.bench import BenchError, Check, Outcome, Record, window
from gpubench.drivers import lm
from gpubench.reference import moe_lm, precision


def readings(served: list, refs: list) -> dict:
    """``served`` and ``refs``: (tokens (B,), logits (B, Vpad)) of the
    program and (B, Vpad) float32 logits of the reference, a request each.
    Each row's relative L2 gap of the logits, the gap by which its served
    token's reference logit lies below the reference's best, and whether the
    served token is the greedy choice of the served logits."""
    rel, gap, greedy = [], [], []
    for (tok, lg), ref in zip(served, refs):
        ref, lg, tok = ref.float().cpu(), lg.float().cpu(), tok.cpu()
        rel += ((lg - ref).norm(dim=1) / ref.norm(dim=1)).tolist()
        gap += (ref.max(dim=1).values - ref.gather(1, tok[:, None])[:, 0]).tolist()
        greedy += (lg.argmax(dim=1) == tok).tolist()
    return {"rel": rel, "gap": gap, "greedy": greedy}


def compare(served: list, refs: list, reach: float) -> dict:
    """The compared numbers: the share of rows whose served logits lie
    farther than ``reach`` (relative L2) from the reference's, and the rows
    whose served token is not the greedy choice of the logits served with
    it.  A bfloat16 row misses float32 by a few percent, and by up to about
    ``reach`` where a near tie in the top-k routing flips an expert; a row
    computed a precision lower misses by more, whatever its routing."""
    r = readings(served, refs)
    beyond = [not (x <= reach) for x in r["rel"]]
    return {"rows_beyond_reach": sum(beyond) / len(beyond),
            "served_not_greedy": float(len(r["greedy"]) - sum(r["greedy"]))}


def run(ctx) -> Outcome:
    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    precision.no_tf32()
    gen = torch.Generator(device=dev).manual_seed(ctx.seed)
    rng = random.Random(ctx.seed)
    model = lm.program_model(cfg, dev)
    params = weights.make_params(cfg, gen, dev)
    lengths, batch, vocab = tr["lengths"], tr["prompts_per_request"], cfg["vocab_size"]

    from repro_torch.kernels.attention import ops as attn_ops
    from repro_torch.launch import serve

    def prompts(t):
        return torch.randint(0, vocab, (batch, t), generator=gen, device=dev)

    def serve_one(p):
        if ctx.control is not None:
            ref = moe_lm.last_logits(params, cfg, p, ctx.control)
            return ref.argmax(dim=1), ref
        if ctx.fault == "half_batch":
            res = serve.generate(model, params, p[: batch // 2], tr["new_tokens"])
            return res.tokens[:, 0].repeat(2), res.prefill_logits.repeat(2, 1)
        if ctx.fault == "slot":  # the first prompt's answer is another prompt's
            p = torch.cat([(p[:1] + 1) % vocab, p[1:]])
        res = serve.generate(model, params, p, tr["new_tokens"])
        tok = res.tokens[:, 0]
        if ctx.fault == "answer":
            tok = (tok + 1) % vocab
        return tok, res.prefill_logits

    for t in sorted(lengths):  # warm-up: every shape the traffic uses
        serve_one(prompts(t))[1].cpu()
    if ctx.fault not in (None, "half_batch", "answer", "slot"):
        raise BenchError(f"unknown fault {ctx.fault!r}")

    order = []

    def one():
        if not order:
            order.extend(rng.sample(lengths, len(lengths)))
        p = prompts(order.pop())
        sent = time.perf_counter()
        with ctx.span("request"):
            tok, lg = serve_one(p)
            tok, lg = tok.cpu(), lg.cpu()
        return p, tok, lg, time.perf_counter() - sent

    launches0 = attn_ops.launches
    done, walls, elapsed = window(ctx, one, tr["trace_requests"])
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    served, traced = done[: len(walls)], done[len(walls):]
    tokens = sum(p.numel() for p, *_ in served)
    ttfts = [s for *_, s in served]
    p95 = statistics.quantiles(ttfts, n=20, method="inclusive")[-1] if len(ttfts) > 1 else ttfts[0]
    counters = {"requests": len(done), "flash_launches": attn_ops.launches - launches0}
    if traced:
        counters["untraced_flops_per_s"] = sum(flops.prefill_flops(cfg, p.shape[0], p.shape[1])
                                               for p, *_ in served) / sum(walls)
        attn = [flops.flash_attention_work(p.shape[0], p.shape[1], cfg["num_attention_heads"],
                                           cfg["num_key_value_heads"], flops.head_dim(cfg)) for p, *_ in traced]
        counters["flash_bound_s_traced"] = cfg["num_hidden_layers"] * sum(
            flops.bound_seconds(a["flops"], a["bytes"]) for a in attn)

    # the check, once the program's state is freed
    del model
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    longest = max(p.shape[1] for p, *_ in done)
    n_check = min(tr["check_requests"], len(done))
    pick = rng.sample([i for i, d in enumerate(done) if d[0].shape[1] == longest], 1)
    rest = [i for i in range(len(done)) if i not in pick]
    pick += rng.sample(rest, min(n_check - 1, len(rest)))
    with torch.no_grad():
        refs = [moe_lm.last_logits(params, cfg, done[i][0]) for i in pick]
    served = [(done[i][1], done[i][2]) for i in pick]
    got = compare(served, refs, ctx.plan.limits["row_reach"])
    r = readings(served, refs)
    info = {"rows_checked": len(r["rel"]), "median_row_rel_err": statistics.median(r["rel"]),
            "widest_row_rel_err": max(r["rel"]), "widest_served_gap": max(r["gap"])}
    if ctx.detail:  # each row: prompt length, place in the request, relative error, served gap
        shape = [(done[i][0].shape[1], j) for i in pick for j in range(done[i][0].shape[0])]
        info["rows"] = [[t, j, x, g] for (t, j), x, g in zip(shape, r["rel"], r["gap"])]
    checks = [Check(name, value, ctx.limit(name)) for name, value in got.items()]
    return Outcome(metrics={"prefill_tokens_per_s": tokens / elapsed, "ttft_ms_p95": 1e3 * p95},
                   attempted=len(done), failed=0, checks=checks,
                   record=Record(ctx.tracer.trace if ctx.tracer else None, counters),
                   memory_peak_bytes=int(peak),
                   info=info)
