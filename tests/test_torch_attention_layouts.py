"""The reference's attention layouts under a mesh, on gloo worlds of CPU
ranks and on fake worlds: head parallelism over repeated kv heads,
query-sequence parallelism where the heads do not divide the model axis,
and decode on the cache's own layout without gathering it.

- The rule, at full width: each of the ten archs' attention on fake
  DTensors of a fake (16, 16) world (`torch_dist_worker.full_width_pieces`,
  train_4k's q, k, v and one query against decode_32k's cache) takes the
  layout that the reference's resolver picks on a JAX `AbstractMesh` for
  `_sdpa`'s alternatives: each rank's q piece has H/16 heads or T/16 rows,
  and the decode scores the cache's own kv heads or its own slots, with no
  all-gather of the cache.
- The pieces, with no process: `shardctx.heads_piece` and
  `ops.flash_attention_piece` for every block of head counts whose q heads
  keep, share or straddle kv heads, joined along the heads, are the
  attention of the whole tensors.
- A gloo world of 4 ranks (`torch_dist_worker.start_world`, one torch thread
  a rank) runs llama3.2-3b smoke (6 q / 2 kv heads: the query sequence on
  (1, 4), heads on (2, 2)) and qwen3-moe-30b-a3b smoke (8 / 2: heads with
  the kv heads sliced on (1, 4), the rank's own kv heads on (2, 2)):
  three sync train steps with blocked attention (block 8, so the query
  pieces offset their positions), held to the port's mesh-free steps and
  the reference's, as tests/test_torch_distribution.py holds its train
  cases (k exact, sim_time 1e-6, ce and loss 1e-4 relative, the
  parameters at GRAD_TOL of each leaf's max); generation, a prefill and
  decode steps, within SERVE_ATOL of the mesh-free logits with the same
  greedy tokens, the cache sequence-sharded on (1, 4) (each rank scores
  its slots, the softmax across the ranks) and head-sharded on (2, 2); a
  ring-buffer cache of 16 slots (4 a rank) that wraps during the decode.
  Each rank's local q is recorded (`torch_dist_worker.attention_spy`).
- Fake worlds of 4 and of 1: a train step's attention FLOPs a rank
  (`roofline.count_step` through `count_train_step(fake=True)`) are 1/4 of
  the world of one's.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro.launch import sharding as jsh  # noqa: E402
from repro_torch import shardctx  # noqa: E402
from repro_torch.configs import INPUT_SHAPES, get_config, list_archs  # noqa: E402
from repro_torch.kernels.attention import ops as attn_ops  # noqa: E402
from repro_torch.kernels.attention.ref import attention_ref  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from test_torch_train import GRAD_TOL, _leafwise, _model_pair, run_both  # noqa: E402

import torch_dist_worker as W  # noqa: E402

ARCHS = ["llama3.2-3b", "qwen3-moe-30b-a3b"]
SHAPES = [(1, 4), (2, 2)]
CASES = [(a, s) for a in ARCHS for s in SHAPES]
CASE_IDS = [f"{a}-{s[0]}x{s[1]}" for a, s in CASES]
# blocked attention, 4 key blocks of the 32-token train batch
BLOCKED = {"attention_impl": "blocked", "attention_block": 8}
# prompts whose cache (prompt + 4 new tokens) divides 4 ranks; llama's 124
# positions take `_sdpa` (not a multiple of 128), qwen3-moe's 128 the
# kernel's wrapper (its plain version on the CPU)
PROMPT, NEW_TOKENS = {"llama3.2-3b": 124, "qwen3-moe-30b-a3b": 128}, 4
WINDOW_CASE = dict(arch="llama3.2-3b", shape=(1, 4), window=16, new_tokens=8)
# llama3.2-3b smoke's 6 q / 2 kv heads on a model axis of 3: rank 1's q
# heads 2 and 3 straddle kv heads 0 and 1
STRADDLE_CASE = dict(arch="llama3.2-3b", shape=(1, 3))
SERVE_ATOL = 1e-5  # tests/test_torch_distribution.py's, the f32 logits
JAX_ATOL = SERVE_ATOL  # the JAX package's logits of the same prompts and weights
MODEL_AXIS = 16
FULL = list_archs()


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """A gloo world of 4 (every train and serving case), fake worlds of 4
    and of 1 (the attention FLOPs) and a fake world of 256 (the ten archs
    at full width), started at once; the references are computed here
    while they run."""
    tmp = tmp_path_factory.mktemp("layouts")
    for arch in ARCHS:
        torch.save(_model_pair(arch)[4], tmp / f"{arch}.pt")
    jobs = []
    for arch, shape in CASES:
        pf = str(tmp / f"{arch}.pt")
        jobs += [("layout_train", dict(arch=arch, shape=shape, params_file=pf, overrides=BLOCKED)),
                 ("layout_serving", dict(arch=arch, shape=shape, params_file=pf, prompt_len=PROMPT[arch],
                                         new_tokens=NEW_TOKENS))]
    w = WINDOW_CASE
    jobs.append(("layout_serving", dict(arch=w["arch"], shape=w["shape"], params_file=str(tmp / f"{w['arch']}.pt"),
                                        prompt_len=PROMPT[w["arch"]], new_tokens=w["new_tokens"],
                                        window=w["window"])))
    started = [W.start_world(4, jobs, str(tmp / "gloo4")),
               W.start_world(3, [("straddled_heads", STRADDLE_CASE)], str(tmp / "gloo3")),
               W.start_fake_world(4, [("attention_flops", dict(arch=a, shape=s)) for a, s in CASES],
                                  str(tmp / "fake4")),
               W.start_fake_world(1, [("attention_flops", dict(arch=a, shape=(1, 1))) for a in ARCHS],
                                  str(tmp / "fake1")),
               W.start_fake_world(256, [("full_width_pieces", dict(archs=FULL))], str(tmp / "fake256"))]
    for arch in ARCHS:
        run_both(arch, "sync", 1, "sgd", overrides=BLOCKED)
    gloo, gloo3, fake4, fake1, fake256 = (W.finish_world(s) for s in started)
    return {"gloo": gloo, "straddle": [rank[0] for rank in gloo3], "fake4": fake4[0], "fake1": fake1[0],
            "full": fake256[0][0]}


def _gloo(worlds, case, kind):
    """Every rank's result of CASES[case]'s train ("train") or serving job."""
    return [rank[2 * case + (kind != "train")] for rank in worlds["gloo"]]


def _expected_piece(h, t, shape):
    """(rows, heads) of a rank's q piece by the reference's rule on a model
    axis of extent m = shape[1]: H/m heads where m divides H, else T/m rows."""
    m = shape[1]
    return (t, h // m) if h % m == 0 else (t // m, h)


_JAX_SERVING = {}


def _jax_serving(arch, prompts, steps, window=0):
    """The JAX package's serving of ``arch``'s smoke config with the
    weights the port's runs load (`_model_pair`), as examples/serve_decode.py
    runs it: a prefill of ``prompts``, the cache padded to the prompt and
    ``steps`` + 1 positions (or the ring of ``window`` slots), ``steps``
    greedy decode steps.  (prefill logits, step logits, tokens), the first
    token from the prefill logits."""
    key = (arch, prompts.shape, steps, window)
    if key not in _JAX_SERVING:
        _, jmodel, jparams, _, _ = _model_pair(arch)
        t = prompts.shape[1]
        logits, cache = jax.jit(lambda p, bt: jmodel.prefill(p, bt, window=window))(
            jparams, {"tokens": jnp.asarray(_np(prompts), jnp.int32)})
        prefill = np.asarray(logits)
        if not window:
            pad = t + steps + 1 - cache["k"].shape[2]
            cache = {kk: jnp.pad(c, ((0, 0), (0, 0), (0, pad), (0, 0), (0, 0))) if kk in ("k", "v") else c
                     for kk, c in cache.items()}
        decode = jax.jit(lambda p, tok, c, pos: jmodel.decode_step(p, tok, c, pos, window=window))
        token = jnp.argmax(logits, axis=-1)[:, None].astype(jnp.int32)
        tokens, step_logits = [np.asarray(token)], []
        for i in range(steps):
            logits, cache = decode(jparams, token, cache, jnp.asarray(t + i, jnp.int32))
            token = jnp.argmax(logits, axis=-1)[:, None].astype(jnp.int32)
            step_logits.append(np.asarray(logits))
            tokens.append(np.asarray(token))
        _JAX_SERVING[key] = prefill, step_logits, np.concatenate(tokens, axis=1)
    return _JAX_SERVING[key]


# ------------------------------------------------------- the full-width rule


def _reference_choice(shape, *alts):
    """Index of the first of ``alts`` that the reference's resolver
    satisfies for ``shape`` on a (16, 16) ("data", "model") AbstractMesh,
    as its `constrain_alt` picks; None where none does."""
    resolve = jsh.activation_resolver(AbstractMesh((16, MODEL_AXIS), ("data", "model")))
    return next((i for i, alt in enumerate(alts) if resolve(alt, shape, strict=True) is not None), None)


@pytest.mark.parametrize("arch", FULL)
def test_full_width_attention_takes_the_reference_layout(worlds, arch):
    cfg, tr = get_config(arch), INPUT_SHAPES["train_4k"]
    got = worlds["full"][arch]["train"]
    q = (tr.global_batch, tr.seq_len, cfg.n_heads, cfg.resolved_head_dim)
    choice = _reference_choice(q, shardctx.BY_HEADS, shardctx.BY_SEQUENCE)
    assert choice == (0 if cfg.n_heads % MODEL_AXIS == 0 else 1)
    rows, heads = (tr.seq_len, cfg.n_heads // MODEL_AXIS) if choice == 0 else (tr.seq_len // MODEL_AXIS, cfg.n_heads)
    assert [c["fn"] for c in got] == ["_sdpa"]
    b = tr.global_batch // 16
    assert got[0]["q"] == (b, rows, heads, cfg.resolved_head_dim), got
    # heads: the kv heads that the rank's q heads read; the query: k whole along S
    kvl = max(1, heads // (cfg.n_heads // cfg.n_kv_heads)) if choice == 0 else cfg.n_kv_heads
    assert got[0]["k"] == (b, tr.seq_len, kvl, cfg.resolved_head_dim), got


@pytest.mark.parametrize("arch", FULL)
def test_full_width_decode_keeps_the_cache_layout(worlds, arch):
    """The cache as the reference's `_sdpa_decode_grouped` keeps it: its
    kv heads on the model axis where they divide it, else its sequence; a
    query gathers none of it."""
    cfg, dec = get_config(arch), INPUT_SHAPES["decode_32k"]
    res = worlds["full"][arch]
    s = min(dec.seq_len, cfg.sliding_window or dec.seq_len)
    kshape = (dec.global_batch, s, cfg.n_kv_heads, cfg.resolved_head_dim)
    choice = _reference_choice(kshape, shardctx.BY_HEADS, shardctx.BY_SEQUENCE)
    b = dec.global_batch // 16
    assert res["cache_placements"] == (("S(1)", "S(3)") if choice == 0 else ("S(1)", "S(2)"))
    (call,) = res["decode"]
    if choice == 0:
        assert call["fn"] == "_sdpa" and call["k"] == (b, s, cfg.n_kv_heads // MODEL_AXIS, cfg.resolved_head_dim)
    else:
        assert call["fn"] == "_sdpa_decode_partial" and call["k"] == (b, s // MODEL_AXIS, cfg.n_kv_heads,
                                                                      cfg.resolved_head_dim)
    cache_bytes = b * s * cfg.n_kv_heads * cfg.resolved_head_dim * 2
    assert res["decode_collectives"]["all-gather"] < cache_bytes / MODEL_AXIS, res["decode_collectives"]


# ------------------------------------------------------------- the pieces


# (H, KV, extent): q heads that are whole groups, share one kv head, or
# straddle two (6 / 2 on 3 ranks: rank 1's heads 2, 3 read kv heads 0, 1)
PIECE_CASES = [(6, 2, 2), (6, 2, 3), (6, 2, 6), (8, 2, 4), (32, 4, 16), (24, 8, 8), (25, 5, 5), (96, 8, 16),
               (16, 16, 4)]


@pytest.mark.parametrize("h,kvh,extent", PIECE_CASES)
def test_head_pieces_join_to_the_whole_attention(h, kvh, extent):
    rng = np.random.default_rng(h * 100 + kvh * 10 + extent)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 16, n, 16)).astype(np.float32)) for n in (h, kvh, kvh))
    whole = attention_ref(q, k, v, causal=True)
    pieces = [attn_ops.flash_attention_piece(q, k, v, r, extent) for r in range(extent)]
    torch.testing.assert_close(torch.cat(pieces, dim=2), whole, rtol=0, atol=1e-6)
    for r in range(extent):
        held = shardctx.heads_piece(q, k, v, r, extent)
        # the rank holds its q heads, and its own kv heads where KV divides the extent, else all of them
        assert held[0].shape[2] == h // extent and held[1].shape[2] == (kvh // extent if kvh % extent == 0 else kvh)
        ql, kl, _ = shardctx.heads_step(lambda *qkv: qkv[:3], *held, h, kvh, r, extent)
        q0, hl, k0, k1 = shardctx.head_block(h, kvh, r, extent)
        assert ql.shape[2] == hl == h // extent and hl % kl.shape[2] == 0
        straddles = hl % (h // kvh) and (h // kvh) % hl
        assert kl.shape[2] == (hl if straddles else k1 - k0)


# --------------------------------------------------------- the gloo world


@pytest.mark.parametrize("case", range(len(CASES)), ids=CASE_IDS)
def test_blocked_train_step_in_the_layout_matches_both_packages(worlds, case):
    arch, shape = CASES[case]
    per_rank = _gloo(worlds, case, "train")
    got = per_rank[0]
    jstate, tstate, rows = run_both(arch, "sync", 1, "sgd", overrides=BLOCKED)
    for mesh_m, (jm, tm) in zip(got["rows"], rows, strict=True):
        for want in (jm, tm):
            assert int(mesh_m["k"]) == int(want["k"])
            np.testing.assert_allclose(float(mesh_m["sim_time"]), float(want["sim_time"]), rtol=1e-6)
            np.testing.assert_allclose(float(mesh_m["ce"]), float(want["ce"]), rtol=1e-4)
            np.testing.assert_allclose(float(mesh_m["loss"]), float(want["loss"]), rtol=1e-4)
    for want_params in (jstate.params, tstate.params):
        for path, a, b in _leafwise(want_params, got["params"]):
            np.testing.assert_allclose(b, a, rtol=0, atol=GRAD_TOL[arch] * np.abs(a).max(), err_msg=path)
    # each rank's blocked attention ran on its piece: T/m rows or H/m heads
    rows_heads = _expected_piece(_model_pair(arch)[3].cfg.n_heads, 32, shape)
    for rank in per_rank:
        pieces = {(c["q"][1], c["q"][2]) for c in rank["calls"] if c["fn"] == "_sdpa_blocked"}
        assert pieces == {rows_heads}, pieces


@pytest.mark.parametrize("case", range(len(CASES)), ids=CASE_IDS)
def test_serving_in_the_layout_matches_the_mesh_free_run(worlds, case):
    arch, shape = CASES[case]
    per_rank = _gloo(worlds, case, "serve")
    got = per_rank[0]
    _, _, _, model, params = _model_pair(arch)
    t = PROMPT[arch]
    prompts = tserve.random_prompts(model.cfg, 4, t, 1, "cpu")
    want = tserve.generate(model, params, prompts, NEW_TOKENS)
    np.testing.assert_allclose(_np(got["prefill_logits"]), _np(want.prefill_logits), rtol=0, atol=SERVE_ATOL)
    assert torch.equal(got["tokens"], want.tokens)
    # the JAX package: generate's tokens, the prefill and the step logits of the same prompts
    jprefill, jsteps, jtokens = _jax_serving(arch, prompts, NEW_TOKENS - 1)
    np.testing.assert_array_equal(_np(got["tokens"]), jtokens)
    for mesh_logits, jlogits in zip([got["prefill_logits"], *got["step_logits"]], [jprefill, jprefill, *jsteps[:2]]):
        np.testing.assert_allclose(_np(mesh_logits), jlogits, rtol=0, atol=JAX_ATOL)
    logits, cache = model.prefill(params, {"tokens": prompts})
    np.testing.assert_allclose(_np(got["step_logits"][0]), _np(logits), rtol=0, atol=SERVE_ATOL)
    cache = tserve._grow_kv_cache(model, cache, 4, t + 4, 0)
    tok = torch.argmax(logits, dim=-1)[:, None]
    for i in range(2):
        logits, cache = model.decode_step(params, tok, cache, t + i)
        np.testing.assert_allclose(_np(got["step_logits"][1 + i]), _np(logits), rtol=0, atol=SERVE_ATOL)
        tok = torch.argmax(logits, dim=-1)[:, None]
    for other in per_rank[1:]:
        assert torch.equal(other["tokens"], got["tokens"])
    # the cache (L, B, S, KV, hd): kv heads on "model" where KV divides it, else the sequence
    cfg, m = model.cfg, shape[1]
    kv_heads = cfg.n_kv_heads % m == 0
    assert got["cache_placements"]["k"][1] == ("S(3)" if kv_heads else "S(2)"), got["cache_placements"]
    s = t + 4
    assert got["cache_local"] == (cfg.n_layers, 4 // shape[0], s if kv_heads else s // m,
                                  cfg.n_kv_heads // m if kv_heads else cfg.n_kv_heads, cfg.resolved_head_dim)
    # the prefill's q pieces; a decode's: its own slots (softmax across ranks) or its own kv heads
    rows_heads = _expected_piece(cfg.n_heads, t, shape)
    calls = got["calls"]
    for part in ("generate", "prefill"):
        pieces = {(c["fn"], c["q"][1], c["q"][2]) for c in calls[part] if c["q"][1] > 1}
        assert pieces == {("flash_attention" if t % 128 == 0 else "_sdpa", *rows_heads)}, (part, pieces)
    dec = calls["decode"]
    assert len(dec) == 2 * cfg.n_layers
    if kv_heads:
        assert all(c["fn"] == "_sdpa" and c["k"][1:3] == (s, cfg.n_kv_heads // m) for c in dec), dec
    else:
        assert all(c["fn"] == "_sdpa_decode_partial" and c["k"][1:3] == (s // m, cfg.n_kv_heads) for c in dec), dec
    # a query's attention gathers nothing of the cache: at most the query's heads
    q_bytes = 4 // shape[0] * cfg.n_heads * cfg.resolved_head_dim * 4
    for rank in per_rank:
        coll = rank["attention_collectives"]
        assert coll["all-gather"] <= q_bytes and coll["all-to-all"] == 0, coll
        assert (coll["all-reduce"] > 0) == (not kv_heads), coll
        assert rank["decode_collectives"]["all-gather"] > 0  # the step's gathers: the vocab-gathered embedding


def test_ring_buffer_cache_wraps_across_the_ranks(worlds):
    """A window of 16 slots, 4 a rank, sequence-sharded on (1, 4): the
    decode writes each new k and v into the rank that holds its slot and
    wraps past the last slot."""
    w = WINDOW_CASE
    per_rank = [rank[-1] for rank in worlds["gloo"]]
    got = per_rank[0]
    _, _, _, model, params = _model_pair(w["arch"])
    prompts = tserve.random_prompts(model.cfg, 4, PROMPT[w["arch"]], 1, "cpu")
    want = tserve.generate(model, params, prompts, w["new_tokens"], window=w["window"])
    np.testing.assert_allclose(_np(got["prefill_logits"]), _np(want.prefill_logits), rtol=0, atol=SERVE_ATOL)
    assert torch.equal(got["tokens"], want.tokens)
    jprefill, _, jtokens = _jax_serving(w["arch"], prompts, w["new_tokens"] - 1, window=w["window"])
    np.testing.assert_allclose(_np(got["prefill_logits"]), jprefill, rtol=0, atol=JAX_ATOL)
    np.testing.assert_array_equal(_np(got["tokens"]), jtokens)
    dec = [c for c in got["calls"]["generate"] if c["q"][1] == 1]
    assert len(dec) == (w["new_tokens"] - 1) * model.cfg.n_layers
    assert all(c["fn"] == "_sdpa_decode_partial" and c["k"][1] == w["window"] // 4 for c in dec), dec


def test_straddled_heads_through_the_wrappers_match_the_whole_attention(worlds):
    """6 q over 2 kv heads on 3 ranks: `_sdpa`, `_sdpa_blocked` (forward
    and gradients) and the kernel's wrapper (forward) on the rank's 2 q
    heads, kv repeated locally to one a q head, equal the mesh-free
    attention; k's and v's gradients, partial on the model axis, sum to
    the whole's."""
    per_rank = worlds["straddle"]
    cfg = _model_pair(STRADDLE_CASE["arch"])[3].cfg.replace(attention_block=8)
    gen = torch.Generator().manual_seed(0)
    whole = [torch.randn(2, 16, n, cfg.resolved_head_dim, generator=gen).requires_grad_()
             for n in (cfg.n_heads, cfg.n_kv_heads, cfg.n_kv_heads)]
    cot = torch.randn(2, 16, cfg.n_heads, cfg.resolved_head_dim, generator=gen)
    mask = torch.tril(torch.ones(16, 16, dtype=torch.bool))[None, None]
    for name, fn in (("sdpa", lambda *qkv: layers._sdpa(cfg, *qkv, mask)),
                     ("blocked", lambda *qkv: layers._sdpa_blocked(cfg, *qkv, causal=True, window=0)),
                     ("flash", lambda *qkv: attn_ops.flash_attention(*(x.detach() for x in qkv), causal=True))):
        want = fn(*whole)
        grads = torch.autograd.grad((want * cot).sum(), whole) if name != "flash" else None
        for rank in per_rank:
            got = rank[name]
            assert got["out_placements"] == ("S(0)", "S(2)"), got["out_placements"]
            np.testing.assert_allclose(_np(got["out"]), _np(want), rtol=0, atol=1e-6, err_msg=name)
            for g, w in zip(got.get("grads", []), grads or []):
                np.testing.assert_allclose(_np(g), _np(w), rtol=0, atol=1e-5, err_msg=name)
    # every rank's pieces: 2 q heads, and kv repeated to 2 heads (2 is neither a multiple nor a divisor of g = 3)
    for rank in per_rank:
        assert {(c["fn"], c["q"][2], c["k"][2]) for c in rank["calls"]} == {
            ("_sdpa", 2, 2), ("_sdpa_blocked", 2, 2), ("flash_attention", 2, 2)}


# ----------------------------------------------------------- the FLOPs


@pytest.mark.parametrize("case", range(len(CASES)), ids=CASE_IDS)
def test_attention_flops_a_rank_are_a_share_of_the_world_of_one(worlds, case):
    arch, shape = CASES[case]
    got = worlds["fake4"][case]
    one = worlds["fake1"][ARCHS.index(arch)]

    def attention(res):
        return sum(c["flops"] for c in res["calls"])

    assert attention(one) > 0 and len(got["calls"]) == len(one["calls"])
    assert attention(got) * 4 == attention(one), (attention(got), attention(one))
    assert got["flops"] < one["flops"]
