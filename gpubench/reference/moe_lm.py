"""Plain reference of a decoder-only mixture-of-experts language model.

Follows the configuration as the port runs it (the JAX package's MoE
family): pre-norm blocks of RMSNorm (eps 1e-6) and grouped-query causal
attention with rotary embeddings on the two halves of each head (theta
from the configuration), then RMSNorm and a mixture of experts:

    router logits = h W_r (float32); p = softmax; the top k experts by p,
    ties to the lower index; gates = their p renormalised to sum 1;
    capacity C = max(floor(capacity_factor * T * k / E), 1) tokens an
    expert and a batch row, filled slot by slot (all tokens' first choices
    in sequence order, then their second, ...); an assignment past C is
    dropped;  y = sum of kept gates * W_out(silu(h W_gate) * (h W_in));
    load-balance loss E * sum_e f_e p_e (f_e the share of tokens whose
    first choice is e, p_e the mean router probability), summed over layers.

Then the final RMSNorm and the output head over the padded vocabulary.
Every product is float32 on operands rounded by `precision.operand`, so
the same code is the control at a lower precision.  Parameters are read in
the port's tree layout; nothing of the port is imported.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from gpubench.reference import precision as prec


def _w(x: torch.Tensor, p: str) -> torch.Tensor:
    return prec.operand(x, p)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * scale.float()


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, T, H, hd): rotate the first half of each head against the second."""
    t, hd = x.shape[1], x.shape[-1]
    half = hd // 2
    freq = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32, device=x.device) / half))
    ang = torch.arange(t, dtype=torch.float32, device=x.device)[:, None] * freq
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(h: torch.Tensor, p: dict, cfg: dict, pr: str) -> torch.Tensor:
    b, t, d = h.shape
    wq, wk, wv, wo = p["wq"], p["wk"], p["wv"], p["wo"]
    nh, kvh, hd = wq.shape[1], wk.shape[1], wq.shape[2]
    q = (_w(h, pr) @ _w(wq.reshape(d, nh * hd), pr)).reshape(b, t, nh, hd)
    k = (_w(h, pr) @ _w(wk.reshape(d, kvh * hd), pr)).reshape(b, t, kvh, hd)
    v = (_w(h, pr) @ _w(wv.reshape(d, kvh * hd), pr)).reshape(b, t, kvh, hd)
    q, k = rope(q, cfg["rope_theta"]), rope(k, cfg["rope_theta"])
    g = nh // kvh
    k = k.repeat_interleave(g, dim=2)
    v = v.repeat_interleave(g, dim=2)
    causal = torch.ones((t, t), dtype=torch.bool, device=h.device).tril()
    outs = []
    for i in range(b):  # a batch row at a time: the (H, T, T) scores of one row
        qi, ki, vi = (a[i].transpose(0, 1) for a in (q, k, v))  # (H, T, hd)
        s = (_w(qi, pr) @ _w(ki, pr).transpose(1, 2)) / math.sqrt(hd)
        s = s.masked_fill(~causal, float("-inf"))
        outs.append((_w(torch.softmax(s, dim=-1), pr) @ _w(vi, pr)).transpose(0, 1))
    o = torch.stack(outs).reshape(b, t, nh * hd)
    return _w(o, pr) @ _w(wo.reshape(nh * hd, d), pr)


def route(h: torch.Tensor, router: torch.Tensor, cfg: dict, pr: str):
    """(experts (B, T, K), gates (B, T, K) with dropped assignments at 0,
    load-balance loss)."""
    b, t, _ = h.shape
    e, top_k = cfg["num_local_experts"], cfg["num_experts_per_tok"]
    probs = torch.softmax(_w(h, pr) @ _w(router, pr), dim=-1)
    top_p, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, idx = top_p[..., :top_k], idx[..., :top_k]
    gates = top_p / top_p.sum(dim=-1, keepdim=True)
    cap = max(int(cfg["capacity_factor"] * t * top_k / e), 1)
    fill = torch.zeros((b, e), dtype=torch.int64, device=h.device)
    kept = []
    for j in range(top_k):
        onehot = F.one_hot(idx[..., j], e)  # (B, T, E)
        rank = (torch.cumsum(onehot, dim=1) - 1).gather(2, idx[..., j:j + 1])[..., 0]
        pos = rank + fill.gather(1, idx[..., j])
        kept.append(pos < cap)
        fill = fill + torch.minimum(onehot.sum(dim=1), cap - fill)
    gates = gates * torch.stack(kept, dim=-1)
    f_e = F.one_hot(idx[..., 0], e).float().mean(dim=(0, 1))
    aux = e * torch.sum(f_e * probs.mean(dim=(0, 1)))
    return idx, gates, aux


def moe(h: torch.Tensor, p: dict, cfg: dict, pr: str):
    b, t, d = h.shape
    idx, gates, aux = route(h, p["router"], cfg, pr)
    flat_h = h.reshape(b * t, d)
    flat_idx, flat_g = idx.reshape(b * t, -1), gates.reshape(b * t, -1)
    y = torch.zeros_like(flat_h)
    for e in range(cfg["num_local_experts"]):
        gate = (flat_g * (flat_idx == e)).sum(dim=-1)
        rows = torch.nonzero(gate > 0)[:, 0]
        if rows.numel() == 0:
            continue
        x = _w(flat_h[rows], pr)
        a = F.silu(x @ _w(p["w_gate"][e], pr)) * (x @ _w(p["w_in"][e], pr))
        out = _w(a, pr) @ _w(p["w_out"][e], pr)
        y = y.index_add(0, rows, out * gate[rows, None])
    return y.reshape(b, t, d), aux


def layer(x: torch.Tensor, p: dict, cfg: dict, pr: str):
    eps = cfg["rms_norm_eps"]
    x = x + attention(rmsnorm(x, p["ln1"]["scale"], eps), p["attn"], cfg, pr)
    y, aux = moe(rmsnorm(x, p["ln2"]["scale"], eps), p["moe"], cfg, pr)
    return x + y, aux


def layer_params(params: dict, i: int) -> dict:
    return {k: layer_params(v, i) if isinstance(v, dict) else v[i] for k, v in params.items()}


def hidden(params: dict, cfg: dict, tokens: torch.Tensor, pr: str = "fp32", checkpoint: bool = False):
    """(final-normed hidden states (B, T, D) float32, summed load-balance loss)."""
    x = params["embed"].float()[tokens]
    aux_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg["num_hidden_layers"]):
        p = layer_params(params["layers"], i)
        if checkpoint:
            x, aux = torch.utils.checkpoint.checkpoint(lambda x_, p_: layer(x_, p_, cfg, pr), x, p,
                                                       use_reentrant=False)
        else:
            x, aux = layer(x, p, cfg, pr)
        aux_sum = aux_sum + aux
    return rmsnorm(x, params["final_norm"]["scale"], cfg["rms_norm_eps"]), aux_sum


def last_logits(params: dict, cfg: dict, tokens: torch.Tensor, pr: str = "fp32") -> torch.Tensor:
    """(B, Vpad) float32 logits of the last position, every padded column."""
    x, _ = hidden(params, cfg, tokens, pr)
    return _w(x[:, -1], pr) @ _w(params["lm_head"], pr)


def row_losses(params: dict, cfg: dict, tokens: torch.Tensor, targets: torch.Tensor, pr: str = "fp32",
               checkpoint: bool = False) -> torch.Tensor:
    """(B,) per-row losses: the mean next-token cross-entropy of the row over
    the true vocabulary, plus router_aux_weight * load-balance loss / B."""
    x, aux = hidden(params, cfg, tokens, pr, checkpoint)
    vocab = cfg["vocab_size"]
    ces = []
    for i in range(x.shape[0]):
        lg = _w(x[i], pr) @ _w(params["lm_head"], pr)
        lg = lg[:, :vocab]
        ces.append((torch.logsumexp(lg, dim=-1) - lg.gather(1, targets[i][:, None])[:, 0]).mean())
    return torch.stack(ces) + cfg["router_aux_weight"] * aux / x.shape[0]
