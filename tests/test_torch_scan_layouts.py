"""The two scans on the reference's head-dim layout under a mesh: rwkv6-3b's
wkv split over its value dim V and hymba-1.5b's SSM split over its feature
dim P, with only the key side gathered (`shardctx.on_local_shards`'
value-side layout, `linear_scan.WKV6_DIMS` and `SSM_DIMS`).

The configs: rwkv6-3b's and hymba-1.5b's smoke configs with 3 heads of 64
features (`d_model` 192; hymba one kv head), built the same way in both
packages from the JAX package's seed-0 weights (`test_torch_train.
_model_pair`).  Three heads divide neither model axis of the (1, 4) and
(2, 2) meshes, but the head dim 64 does, as rwkv6-3b's 40 heads and
hymba-1.5b's 25 on a 16-way axis; hymba's N = 8 divides both axes. So the
projections shard the head dim (`launch/sharding.py::PARAM_ALTS`), and
each rank scans its batch shard's V/m (P/m) columns of every head with r,
k, w and u (dt, a, B and C) whole.

On a gloo world of 4 CPU ranks (`torch_dist_worker.start_world`, one
torch thread a rank), on both meshes, held against the port's mesh-free
run and against the JAX package (mesh-free; rwkv's Pallas wkv in
interpret mode, as tests/test_torch_rwkv.py runs it):

1. the sharded prefill's logits (batch 4, prompt 64, seed 1);
2. its final states, in the cache's layout (`CACHE_RULES`: replicated on
   "model", where 3 heads do not divide it), and the other cache leaves;
3. two greedy decode steps after it, the same tokens;
4. a 3-step sync train step (`test_torch_train.run_both`: k exact,
   sim_time 1e-6, ce and loss 1e-4 relative, the parameters at `GRAD_TOL`
   of a leaf's max): the key side's gradients are partial sums across the
   value ranks, so this is the case that shows them.

1-3 within `SERVE_ATOL` 1e-5 of each tensor's max |value| (`_close`):
DTensor sums the tensor-parallel products in another order, and through
rwkv6-3b's two layers that moves its logits (max 3.46) by up to 1.35e-5
absolute against mesh-free with one torch thread, on this tree and as much
on the tree before the value split (1.28e-5, 1.31e-5), and its wkv states
(max ~10) by as much relative.

The pieces, with no process: `kernels.wkv.ops.wkv6_piece` (a rank's call
of the kernel's wrapper, cut from whole tensors) and the SSM scan on P
columns, for every rank of 2, 4 and 16, joined along the last dim, are the
scan of the whole tensors (on the CPU, bit for bit).

The layout, read from the scans' calls (`torch_dist_worker.scan_spy`):
each rank's piece holds V/m (P/m) columns of v (xs) and of the state in,
y and the state out are sharded on their last dim, and the all-gather
bytes of each call, counted by `roofline.analysis.StepCounter`, are those
of the key side alone: no all-gather of v or xs.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro_torch.kernels.wkv import ops as wkv_ops  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import linear_scan  # noqa: E402
from test_torch_train import BATCH as TRAIN_BATCH, GRAD_TOL, _leafwise, _model_pair, run_both  # noqa: E402

import torch_dist_worker as W  # noqa: E402

ARCHS = ["rwkv6-3b", "hymba-1.5b"]
WIDTHS = {"rwkv6-3b": dict(n_heads=3, n_kv_heads=3, d_model=192),
          "hymba-1.5b": dict(n_heads=3, n_kv_heads=1, d_model=192)}
SHAPES = [(1, 4), (2, 2)]
CASES = [(a, s) for a in ARCHS for s in SHAPES]
CASE_IDS = [f"{a}-{s[0]}x{s[1]}" for a, s in CASES]
BATCH, PROMPT, STEPS = 4, 64, 2
SERVE_ATOL = 1e-5  # tests/test_torch_distribution.py's, the f32 logits
STATE = {"rwkv6-3b": "s", "hymba-1.5b": "ssm"}
# the scans on DTensors and on a rank's piece; (value-side input, key-side inputs) of each
SHARDED = {"_wkv6_chunked", "_wkv6_sharded", "_ssm_chunked"}
PIECE = {"wkv6_chunked", "wkv6_ref", "ssm_chunked"}
VALUE_IN = {"wkv": 2, "ssm": 0}
KEY_IN = {"wkv": (0, 1, 3, 4), "ssm": (1, 2, 3, 4)}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, what=""):
    """``got`` within `SERVE_ATOL` of ``want``'s max |value|."""
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=SERVE_ATOL * np.abs(want).max(), err_msg=what)


def _window(arch):
    return _model_pair(arch, WIDTHS[arch])[3].cfg.sliding_window


def _prompts(arch):
    return tserve.random_prompts(_model_pair(arch, WIDTHS[arch])[3].cfg, BATCH, PROMPT, 1, "cpu")


def _port_serving(arch):
    """The port's mesh-free prefill and greedy decode steps, as the
    worker's `make_prefill_step` and `make_decode_step` run them."""
    _, _, _, model, params = _model_pair(arch, WIDTHS[arch])
    w = _window(arch)
    with torch.no_grad():
        logits, cache = model.prefill(params, {"tokens": _prompts(arch)}, window=w)
        out = {"prefill_logits": logits, "cache": {k: v.clone() for k, v in cache.items()}}
        if model.cfg.family != "ssm":
            cache = tserve._grow_kv_cache(model, cache, BATCH, PROMPT + STEPS, w)
        tok = torch.argmax(logits, dim=-1)[:, None]
        tokens, steps = [tok], []
        for i in range(STEPS):
            logits, cache = model.decode_step(params, tok, cache, PROMPT + i, window=w)
            steps.append(logits)
            tok = torch.argmax(logits, dim=-1)[:, None]
            tokens.append(tok)
    return {**out, "step_logits": steps, "tokens": torch.cat(tokens, dim=1)}


def _jax_serving(arch):
    """The JAX package's prefill and greedy decode steps of the same prompts
    and weights (rwkv6-3b's wkv through the Pallas kernel in interpret
    mode), as examples/serve_decode.py runs them."""
    _, jmodel, jparams, _, _ = _model_pair(arch, WIDTHS[arch])
    from repro.models import build_model as jax_build_model

    jmodel = jax_build_model(jmodel.cfg.replace(use_pallas=True))
    w = _window(arch)
    logits, cache = jax.jit(lambda p, bt: jmodel.prefill(p, bt, window=w))(
        jparams, {"tokens": jnp.asarray(_np(_prompts(arch)), jnp.int32)})
    out = {"prefill_logits": np.asarray(logits), "cache": {k: np.asarray(v) for k, v in cache.items()}}
    if "k" in cache and cache["k"].shape[2] < PROMPT + STEPS and not w:
        pad = PROMPT + STEPS - cache["k"].shape[2]
        cache = {k: jnp.pad(c, ((0, 0), (0, 0), (0, pad), (0, 0), (0, 0))) if k in ("k", "v") else c
                 for k, c in cache.items()}
    decode = jax.jit(lambda p, tok, c, pos: jmodel.decode_step(p, tok, c, pos, window=w))
    tok = jnp.argmax(logits, axis=-1)[:, None].astype(jnp.int32)
    tokens, steps = [np.asarray(tok)], []
    for i in range(STEPS):
        logits, cache = decode(jparams, tok, cache, jnp.asarray(PROMPT + i, jnp.int32))
        steps.append(np.asarray(logits))
        tok = jnp.argmax(logits, axis=-1)[:, None].astype(jnp.int32)
        tokens.append(np.asarray(tok))
    return {**out, "step_logits": steps, "tokens": np.concatenate(tokens, axis=1)}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """A gloo world of 4 a mesh shape, both started at once; the port's
    mesh-free runs and the references are computed here while they run."""
    tmp = tmp_path_factory.mktemp("scans")
    for arch in ARCHS:
        torch.save(_model_pair(arch, WIDTHS[arch])[4], tmp / f"{arch}.pt")
    started = []
    for shape in SHAPES:
        jobs = []
        for arch in ARCHS:
            pf, over = str(tmp / f"{arch}.pt"), WIDTHS[arch]
            jobs += [("scan_serving", dict(arch=arch, shape=shape, params_file=pf, overrides=over, prompt_len=PROMPT,
                                           steps=STEPS)),
                     ("scan_train", dict(arch=arch, shape=shape, params_file=pf, overrides=over))]
        jobs.append(("time_mix_collectives", dict(shape=shape, params_file=str(tmp / "rwkv6-3b.pt"),
                                                  overrides=WIDTHS["rwkv6-3b"])))
        started.append(W.start_world(4, jobs, str(tmp / f"gloo{shape[0]}x{shape[1]}")))
    want = {}
    for arch in ARCHS:
        run_both(arch, "sync", 1, "sgd", widths=WIDTHS[arch])
        want[arch] = {"port": _port_serving(arch), "jax": _jax_serving(arch)}
    ranks = {shape: W.finish_world(s) for shape, s in zip(SHAPES, started)}
    return {"ranks": ranks, "want": want}


def _got(worlds, case, kind):
    """Every rank's serving ("serve") or train result of CASES[case]."""
    arch, shape = CASES[case]
    return [rank[2 * ARCHS.index(arch) + (kind != "serve")] for rank in worlds["ranks"][shape]]


# ---------------------------------------------------------------- serving


@pytest.mark.parametrize("case", range(len(CASES)), ids=CASE_IDS)
def test_sharded_prefill_logits_match_mesh_free_and_the_reference(worlds, case):
    arch, _ = CASES[case]
    got = _got(worlds, case, "serve")[0]
    want = worlds["want"][arch]
    for ref in (want["port"], want["jax"]):
        _close(got["prefill_logits"], ref["prefill_logits"])


@pytest.mark.parametrize("case", range(len(CASES)), ids=CASE_IDS)
def test_sharded_prefill_states_match_in_the_cache_layout(worlds, case):
    arch, shape = CASES[case]
    per_rank = _got(worlds, case, "serve")
    got = per_rank[0]
    want = worlds["want"][arch]
    for name, leaf in got["cache"].items():
        for ref in (want["port"], want["jax"]):
            _close(leaf, ref["cache"][name], name)
    # (L, B, H, K, V): the batch on "data", replicated on "model" (3 heads do not divide it)
    assert got["cache_placements"][STATE[arch]] == ("S(1)", "R"), got["cache_placements"]
    for other in per_rank[1:]:
        assert torch.equal(other["cache"][STATE[arch]], got["cache"][STATE[arch]])


@pytest.mark.parametrize("case", range(len(CASES)), ids=CASE_IDS)
def test_decode_after_a_sharded_prefill_matches(worlds, case):
    arch, _ = CASES[case]
    per_rank = _got(worlds, case, "serve")
    got = per_rank[0]
    want = worlds["want"][arch]
    assert torch.equal(got["tokens"], want["port"]["tokens"])
    np.testing.assert_array_equal(_np(got["tokens"]), want["jax"]["tokens"])
    for i in range(STEPS):
        for ref in (want["port"], want["jax"]):
            _close(got["step_logits"][i], ref["step_logits"][i], f"step {i}")
    for other in per_rank[1:]:
        assert torch.equal(other["tokens"], got["tokens"])


# --------------------------------------------------------------- training


@pytest.mark.parametrize("case", range(len(CASES)), ids=CASE_IDS)
def test_sync_train_step_with_the_value_side_sharded_matches_both_packages(worlds, case):
    arch, _ = CASES[case]
    per_rank = _got(worlds, case, "train")
    got = per_rank[0]
    jstate, tstate, rows = run_both(arch, "sync", 1, "sgd", widths=WIDTHS[arch])
    assert len(got["rows"]) == len(rows)
    for mesh_m, (jm, tm) in zip(got["rows"], rows):
        for want in (jm, tm):
            assert int(mesh_m["k"]) == int(want["k"])
            np.testing.assert_allclose(float(mesh_m["sim_time"]), float(want["sim_time"]), rtol=1e-6)
            np.testing.assert_allclose(float(mesh_m["ce"]), float(want["ce"]), rtol=1e-4)
            np.testing.assert_allclose(float(mesh_m["loss"]), float(want["loss"]), rtol=1e-4)
    for want_params in (jstate.params, tstate.params):
        for path, a, b in _leafwise(want_params, got["params"]):
            np.testing.assert_allclose(b, a, rtol=0, atol=GRAD_TOL[arch] * np.abs(a).max(), err_msg=path)
    for other in per_rank[1:]:
        assert [int(m["k"]) for m in other["rows"]] == [int(m["k"]) for m in got["rows"]]


# ----------------------------------------------------------------- layout


def _scan_calls(calls, names):
    return [c for c in calls if c["fn"] in names]


@pytest.mark.parametrize("kind", ["serve", "train"])
@pytest.mark.parametrize("case", range(len(CASES)), ids=CASE_IDS)
def test_each_rank_scans_its_value_columns(worlds, case, kind):
    """y and the state come out sharded on their last dim on "model" (and
    the batch on "data"); each rank's piece holds V/m (P/m) columns of v
    (xs) and of the states, and r, k, w (B, C) whole."""
    arch, shape = CASES[case]
    cfg = _model_pair(arch, WIDTHS[arch])[3].cfg
    hd, m, bl = cfg.resolved_head_dim, shape[1], (BATCH if kind == "serve" else TRAIN_BATCH) // shape[0]
    scan = "wkv" if arch.startswith("rwkv") else "ssm"
    # a train step's forward differentiates the plain scan, its eval forward runs the kernel's wrapper
    want_fn = {"_ssm_chunked"} if scan == "ssm" else {"_wkv6_sharded"} if kind == "serve" else {
        "_wkv6_chunked", "_wkv6_sharded"}
    for rank in _got(worlds, case, kind):
        sharded = _scan_calls(rank["calls"], SHARDED)
        assert {c["fn"] for c in sharded} == want_fn
        assert len(sharded) == cfg.n_layers * (1 if kind == "serve" else 2 * 3)  # train: 3 steps of two forwards
        pieces = _scan_calls(rank["calls"], PIECE)
        assert len(pieces) == len(sharded)
        for c in sharded:
            y, s = c["out"]
            assert y["placements"] == s["placements"] == ("S(0)", "S(3)"), c["out"]
            assert y["local"][-1] == s["local"][-1] == hd // m
            assert c["in"][VALUE_IN[scan]]["placements"][1] == "S(3)"
        for c in pieces:
            y, s = c["out"]
            assert y["shape"][0] == bl and y["shape"][-1] == s["shape"][-1] == hd // m
            assert c["in"][VALUE_IN[scan]]["shape"][-1] == hd // m
            assert all(c["in"][j]["shape"][-1] in (hd, cfg.ssm_state) for j in KEY_IN[scan] if c["in"][j]
                       and len(c["in"][j]["shape"]) == 4)


@pytest.mark.parametrize("kind", ["serve", "train"])
@pytest.mark.parametrize("case", range(len(CASES)), ids=CASE_IDS)
def test_the_scans_gather_only_the_key_side(worlds, case, kind):
    """Each sharded scan call's all-gather bytes (`roofline.analysis.
    StepCounter`) are exactly those of its key-side inputs that "model"
    shards, gathered whole on the rank's batch shard (a dim that "model"
    splits unevenly, as DTensor leaves hymba's dt over 3 heads on 2 ranks,
    gathers its shards padded to the largest): v and xs stay sharded."""
    arch, shape = CASES[case]
    scan = "wkv" if arch.startswith("rwkv") else "ssm"
    m = shape[1]
    for rank in _got(worlds, case, kind):
        for c in _scan_calls(rank["calls"], SHARDED):
            want = 0
            for j in KEY_IN[scan]:
                x = c["in"][j]
                if x is None or x["placements"][1] == "R":
                    continue
                size = list(x["shape"])
                if x["placements"][0] == "S(0)":
                    size[0] //= shape[0]
                d = int(x["placements"][1][2:-1])
                size[d] = -(-size[d] // m) * m
                want += 4 * int(np.prod(size))
            assert want > 0 and c["all_gather"] == want, (c["fn"], c["all_gather"], want, c["in"])


# ----------------------------------------------------------------- pieces


@pytest.mark.parametrize("extent", [2, 4, 16])
@pytest.mark.parametrize("with_s0", [False, True], ids=["s0_none", "s0"])
def test_value_pieces_join_to_the_whole_scan(extent, with_s0):
    rng = np.random.default_rng(extent)
    b, t, h, hd, n = 2, 64, 3, 64, 8
    f = lambda *sh: torch.from_numpy(rng.standard_normal(sh, dtype=np.float32))  # noqa: E731
    r, k, v = f(b, t, h, hd), f(b, t, h, hd), f(b, t, h, hd)
    w, u = torch.exp(-torch.exp(0.5 * f(b, t, h, hd))), 0.1 * f(h, hd)
    s0 = 0.2 * f(b, h, hd, hd) if with_s0 else None
    whole = wkv_ops.wkv6(r, k, v, w, u, s0, chunk=32)
    pieces = [wkv_ops.wkv6_piece(r, k, v, w, u, s0, j, extent, chunk=32) for j in range(extent)]
    for got, want in zip((torch.cat([p[i] for p in pieces], dim=-1) for i in range(2)), whole):
        assert torch.equal(got, want)
    dt, a, bm, cm = f(b, t, h).abs(), -f(h).abs(), f(b, t, h, n), f(b, t, h, n)
    s0 = 0.2 * f(b, h, n, hd) if with_s0 else None
    whole = linear_scan.ssm_chunked(v, dt, a, bm, cm, s0, chunk=32)
    cols = [slice(j * hd // extent, (j + 1) * hd // extent) for j in range(extent)]
    pieces = [linear_scan.ssm_chunked(v[..., c], dt, a, bm, cm, None if s0 is None else s0[..., c], chunk=32)
              for c in cols]
    for got, want in zip((torch.cat([p[i] for p in pieces], dim=-1) for i in range(2)), whole):
        assert torch.equal(got, want)


# --------------------------------------------------------------- backward


def _time_mix_grad():
    """The port's mesh-free time mix (`torch_dist_worker.time_mix_collectives`'
    layer and input), forward and backward: the gradient of x."""
    from repro_torch.models import rwkv
    from repro_torch.models.transformer import layer_params

    _, _, _, model, params = _model_pair("rwkv6-3b", WIDTHS["rwkv6-3b"])
    x = torch.randn(4, 32, model.cfg.d_model, generator=torch.Generator().manual_seed(5)).requires_grad_()
    y, _, _ = rwkv.time_mix(layer_params(params["layers"], 0)["tmix"], model.cfg, x)
    y.sum().backward()
    return x.grad


@pytest.mark.parametrize("shape", SHAPES, ids=[f"{s[0]}x{s[1]}" for s in SHAPES])
def test_time_mix_backward_gathers_no_head_dim_operand(worlds, shape):
    """rwkv6-3b's time mix forward and backward on the mesh: the forward
    gathers r, k and w whole (three whole (B/d, T, H, hd) tensors) and not
    v; the backward moves at most one such tensor (the gated output's
    gradient to its own layout, `shardctx.grad_like`, an all-to-all that
    gloo runs as an all-gather), where DTensor's own layouts gathered the
    head-dim-sharded operand of each of the three products after the scan;
    x's gradient is mesh-free's within 1e-5 of its max."""
    got = worlds["ranks"][shape][0][-1]
    cfg = _model_pair("rwkv6-3b", WIDTHS["rwkv6-3b"])[3].cfg
    whole = BATCH // shape[0] * 32 * cfg.n_heads * cfg.resolved_head_dim
    moved = [(kind, bwd) for kind, out, bwd in got["log"]
             if len(out) == 4 and np.prod(out) == whole and kind in ("all-gather", "all-to-all")]
    assert [k for k, bwd in moved if not bwd] == ["all-gather"] * 3, got["log"]
    assert len([k for k, bwd in moved if bwd]) <= 1, got["log"]
    _close(got["grad"], _time_mix_grad())
