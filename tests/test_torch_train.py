"""The port's LM training path on the CPU against the JAX package, on the
same inputs: the token stream, the optimizers, the per-row loss and its
gradients, the fastest-k train step in every mode, checkpoints across both
packages, and the train CLI.  Weights cross from the JAX `model.init`
through `params_from_jax`.  The train step of rwkv6-3b and qwen1.5-0.5b
and Pflug on the LM are in tests/test_torch_train_steps.py, the MoE and
hybrid archs' cases in tests/test_torch_train_families.py, the vlm and
encdec archs' in tests/test_torch_vlm.py and tests/test_torch_encdec.py,
through the `check_*` helpers here (tier-1's workers take a file each).

Tolerances:
- `TokenStream`: bit for bit (integer draws only);
- optimizers, 5 updates of a mixed bf16/f32 tree on the same gradients:
  f32 leaves within 1e-6 relative, bf16 leaves within 1 ulp;
- per-row losses within 1e-5 relative; gradients of the eq.-(2) weighted
  loss within 1e-4 of each leaf's max |g| (XLA and torch sum in other
  orders through two layers and a 512-way softmax), except rwkv6-3b's
  within 1e-3: its smoke model's gradient is ill-conditioned, and the
  reference's own moves by 2.3e-4 of a leaf's max when its weights are
  scaled by 1 + 1e-7 noise (llama3.2-3b's by 2.1e-6); the gap to the port
  grows ~10x a layer (2e-5 at one layer, 1.6e-4 at two, 2.2e-3 at four);
- the train step, 3 steps: k equal, sim_time within 1e-6 relative, ce
  within 1e-4 relative; with SGD (momentum 0.9) the parameters within 1e-4
  of each leaf's max |p| (rwkv6-3b's within 1e-3, as its gradients).  With AdamW they are held to 2 lr per step
  instead: Adam's update is ~lr sign(g) wherever |g| >> eps, so an element
  whose gradient both packages compute as a near-zero sum of cancelling
  terms can take the opposite sign in each (seen: an embedding row moved
  2.6 lr apart after 3 steps while every other leaf agreed to 1e-6).
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten  # noqa: E402

from repro import checkpoint as jckpt  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.core import aggregation as jagg  # noqa: E402
from repro.core import controller as jctl  # noqa: E402
from repro.core import straggler as jstr  # noqa: E402
from repro.data import TokenStream as JaxTokenStream  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro_torch import checkpoint as tckpt  # noqa: E402
from repro_torch.checkpoint import params_from_jax  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import aggregation as tagg  # noqa: E402
from repro_torch.core import controller as tctl  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core import straggler as tstr  # noqa: E402
from repro_torch.core.tree import leaves_with_path, map_with_index, tree_leaves  # noqa: E402
from repro_torch.data import TokenStream  # noqa: E402
from repro_torch.kernels import forbid_autograd  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.optim import optimizers as topt  # noqa: E402

ARCHS = ["llama3.2-3b", "rwkv6-3b", "qwen1.5-0.5b"]
N_WORKERS, BATCH, SEQ = 4, 8, 32
# Gradients and trained parameters, as a share of each leaf's max: rwkv6-3b's
# smoke model is ill-conditioned (see the module docstring).
GRAD_TOL = {"llama3.2-3b": 1e-4, "rwkv6-3b": 1e-3, "qwen1.5-0.5b": 1e-4, "granite-moe-1b-a400m": 1e-4,
            "qwen3-moe-30b-a3b": 1e-4, "hymba-1.5b": 1e-4, "seamless-m4t-medium": 1e-4, "paligemma-3b": 1e-4}


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype == ml_dtypes.bfloat16 else x


def _jnp_batch(tokens, targets):
    return {"tokens": jnp.asarray(tokens.numpy()), "targets": jnp.asarray(targets.numpy())}


def frontend_inputs(cfg, batch, seed):
    """Seeded random vlm patches or encdec frames, (B, P or F, D) f32 numpy
    ({} for the other families).  Never zeros: zero frames leave the
    encoder's memory 0 and the cross-attention adds exactly 0, so a check
    fed zeros would pass without either."""
    n = {"vlm": cfg.vlm_patches, "encdec": cfg.encoder_frames}.get(cfg.family)
    if n is None:
        return {}
    x = np.random.default_rng(1000 + seed).standard_normal((batch, n, cfg.d_model), dtype=np.float32)
    return {"patches" if cfg.family == "vlm" else "frames": x}


def both_batches(cfg, tokens, targets, seed=0):
    """(JAX batch, port batch): the tokens and targets, and the family's
    `frontend_inputs`."""
    extra = frontend_inputs(cfg, tokens.shape[0], seed)
    return ({**_jnp_batch(tokens, targets), **{k: jnp.asarray(v) for k, v in extra.items()}},
            {"tokens": tokens, "targets": targets, **{k: torch.from_numpy(v) for k, v in extra.items()}})


def _leafwise(jtree, ttree):
    """[(path, jax leaf, port leaf)] in JAX's order."""
    jl = jax.tree.leaves(jtree)
    tl = leaves_with_path(ttree)
    assert len(jl) == len(tl)
    return [(path, _np(a), _np(b)) for a, (path, b) in zip(jl, tl)]


_PAIRS = {}


def _model_pair(arch):
    """(arch, JAX model, JAX params, port model, port params) at smoke size,
    built once per architecture."""
    if arch not in _PAIRS:
        jmodel = jax_build_model(jax_smoke_config(arch))
        jparams = jmodel.init(jax.random.PRNGKey(0))
        tparams = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
        _PAIRS[arch] = (arch, jmodel, jparams, build_model(get_smoke_config(arch), device="cpu"), tparams)
    return _PAIRS[arch]


def _zeros_like(tree):
    return map_with_index(lambda j, leaf: torch.zeros_like(leaf), tree)


# ------------------------------------------------------------- token stream


@pytest.mark.parametrize("vocab,seq,batch,seed,step", [
    (512, 32, 8, 0, 0), (151936, 17, 3, 5, 7), (256, 32, 32, 0, 0), (7, 64, 4, 2**31, 123456)])
def test_token_stream_is_the_reference_bit_for_bit(vocab, seq, batch, seed, step):
    want = JaxTokenStream(vocab, seq, batch, seed).batch_at(step)
    got = TokenStream(vocab, seq, batch, seed, device="cpu").batch_at(step)
    for w, g in zip(want, got):
        assert g.dtype == torch.int32 and tuple(g.shape) == (batch, seq)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# --------------------------------------------------------------- optimizers


def _mixed_tree(rng):
    return {"w": rng.standard_normal((5, 3)).astype(np.float32),
            "b": {"x": rng.standard_normal((4, 6)).astype(ml_dtypes.bfloat16),
                  "y": rng.standard_normal((2, 2)).astype(np.float32)}}


def _assert_opt_close(jtree, ttree):
    for (path, a, b), leaf in zip(_leafwise(jtree, ttree), tree_leaves(ttree)):
        if leaf.dtype == torch.bfloat16:  # within 1 ulp of bf16 (8 bits of mantissa)
            np.testing.assert_allclose(b, a, rtol=2.0**-7, atol=0, err_msg=path)
        else:
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-7, err_msg=path)


OPTIMIZERS = [("sgd", {}), ("sgd", dict(momentum=0.9)), ("sgd", dict(momentum=0.9, nesterov=True)),
              ("adam", {}), ("adamw", {}), ("adam", dict(moments_dtype="bfloat16", weight_decay=0.1))]


@pytest.mark.parametrize("how", ["update", "apply"])
@pytest.mark.parametrize("name,kw", OPTIMIZERS, ids=lambda x: str(x))
def test_optimizer_matches_reference_over_five_updates(name, kw, how):
    rng = np.random.default_rng(0)
    p0, grads = _mixed_tree(rng), [_mixed_tree(rng) for _ in range(5)]
    jo, to = jopt.get_optimizer(name, 1e-2, **kw), topt.get_optimizer(name, 1e-2, **kw)
    jp = jax.tree.map(jnp.asarray, p0)
    js = jo.init(jp)
    tp = params_from_jax(p0, device="cpu")
    ts = to.init(tp)
    for g in grads:
        u, js = jo.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = jopt.apply_updates(jp, u)
        tg = params_from_jax(g, device="cpu")
        if how == "update":
            tu, ts = to.update(tg, ts, tp)
            tp = topt.apply_updates(tp, tu)
        else:
            tp, ts = to.apply(tg, ts, tp)
    _assert_opt_close(jp, tp)
    assert [n for n, _ in leaves_with_path(ts)] == [
        "".join(str(k) for k in path) for path, _ in jax.tree_util.tree_flatten_with_path(js)[0]]
    if name != "sgd" or kw:
        _assert_opt_close(js, ts)


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_chain_clip_matches_reference(max_norm):
    rng = np.random.default_rng(1)
    p0, grads = _mixed_tree(rng), [_mixed_tree(rng) for _ in range(3)]
    jo = jopt.chain_clip(jopt.adamw(1e-2), max_norm)
    to = topt.chain_clip(topt.adamw(1e-2), max_norm)
    jp, tp = jax.tree.map(jnp.asarray, p0), params_from_jax(p0, device="cpu")
    js, ts = jo.init(jp), to.init(tp)
    for g in grads:
        u, js = jo.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = jopt.apply_updates(jp, u)
        tp, ts = to.apply(params_from_jax(g, device="cpu"), ts, tp)
    _assert_opt_close(jp, tp)
    jc, jn = jopt.clip_by_global_norm(jax.tree.map(jnp.asarray, grads[0]), max_norm)
    tc, tn = topt.clip_by_global_norm(params_from_jax(grads[0], device="cpu"), max_norm)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    for _, a, b in _leafwise(jc, tc):
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-7)
    assert tc["b"]["x"].dtype == torch.float32  # JAX promotes bf16 * f32 to f32


# ---------------------------------------------------------------- the loss


def _loss_case(arch, t, vocab=None):
    jcfg, tcfg = jax_smoke_config(arch), get_smoke_config(arch)
    if vocab is not None:
        jcfg, tcfg = jcfg.replace(vocab_size=vocab), tcfg.replace(vocab_size=vocab)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(3))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    tokens, targets = TokenStream(jcfg.vocab_size, t, 2 if t > 512 else BATCH, seed=1, device="cpu").batch_at(0)
    return (jcfg, tcfg, jmodel, jparams, tparams) + both_batches(tcfg, tokens, targets)


def check_per_row_loss(arch, t, vocab):
    jcfg, tcfg, jmodel, jparams, tparams, jbatch, tbatch = _loss_case(arch, t, vocab)
    assert (tcfg.padded_vocab > tcfg.vocab_size) == (vocab is not None)
    want, wmet = jax.jit(jmodel.loss_fn)(jparams, jbatch)
    got, gmet = build_model(tcfg, device="cpu").loss_fn(tparams, tbatch)
    assert tuple(got.shape) == (tbatch["tokens"].shape[0],) and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5)
    np.testing.assert_allclose(float(gmet["ce"]), float(wmet["ce"]), rtol=1e-5)
    # the summed load-balance loss (zero outside moe), folded into each row for moe
    np.testing.assert_allclose(float(gmet["moe_aux"]), float(wmet["moe_aux"]), rtol=1e-6, atol=1e-7)
    assert (float(gmet["moe_aux"]) > 0) == (tcfg.family == "moe")


@pytest.mark.parametrize("arch,t,vocab", [
    ("llama3.2-3b", 32, None), ("rwkv6-3b", 32, None), ("qwen1.5-0.5b", 32, None),
    ("qwen1.5-0.5b", 1024, None),  # the chunked cross-entropy: two chunks of 512
    ("llama3.2-3b", 32, 500),  # a padded vocab: 500 of 512 columns
])
def test_per_row_loss_matches_reference(arch, t, vocab):
    check_per_row_loss(arch, t, vocab)


def check_loss_gradients(arch, t, remat):
    jcfg, tcfg, jmodel, jparams, tparams, jbatch, tbatch = _loss_case(arch, t)
    b = tbatch["tokens"].shape[0]
    n = 2 if b == 2 else N_WORKERS
    mask = np.array([1.0, 0.0, 1.0, 1.0][:n], np.float32)
    k, s = int(mask.sum()), b // n
    jw = jagg.per_example_weights(jnp.asarray(mask), jnp.asarray(k, jnp.int32), s)

    def jloss(p):
        per_row, _ = jmodel.loss_fn(p, jbatch)
        return jnp.sum(jw * per_row)

    want = jax.jit(jax.grad(jloss))(jparams)
    tw = tagg.per_example_weights(torch.from_numpy(mask), torch.tensor(k, dtype=torch.int32), s)
    model = build_model(tcfg.replace(remat=remat, use_kernels=False), device="cpu")
    leaves, spec = tree_flatten(tparams)
    xs = [p.detach().requires_grad_() for p in leaves]
    per_row, _ = model.loss_fn(tree_unflatten(xs, spec), tbatch)
    got = tree_unflatten(list(torch.autograd.grad((tw * per_row).sum(), xs)), spec)
    tol = GRAD_TOL[arch]
    for path, a, g in _leafwise(want, got):
        np.testing.assert_allclose(g, a, rtol=0, atol=tol * max(np.abs(a).max(), 1e-30), err_msg=path)


@pytest.mark.parametrize("arch,t,remat", [
    ("llama3.2-3b", 32, False), ("llama3.2-3b", 32, True), ("rwkv6-3b", 32, False), ("rwkv6-3b", 32, True),
    ("qwen1.5-0.5b", 32, False),
    ("qwen1.5-0.5b", 1024, True),  # remat of every block and of each cross-entropy chunk
])
def test_weighted_loss_gradients_match_jax_grad(arch, t, remat):
    check_loss_gradients(arch, t, remat)


def test_remat_under_a_torch_func_transform_raises():
    model = build_model(get_smoke_config("llama3.2-3b").replace(remat=True), device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    tokens, targets = TokenStream(512, 16, 2, device="cpu").batch_at(0)
    loss = lambda p: model.loss_fn(p, {"tokens": tokens, "targets": targets})[0].mean()  # noqa: E731
    with pytest.raises(RuntimeError, match="torch.func transform"):
        torch.func.grad(loss)(params)
    with torch.no_grad():  # no backward pass, so nothing is recomputed: runs
        assert bool(torch.isfinite(loss(params)))


def test_remat_policy_dots_raises_naming_the_roadmap():
    """remat_policy="dots" is ported (it raised until then, naming the
    roadmap): the loss and its gradients equal full remat's bit for bit on
    the CPU (tests/test_torch_roofline.py holds it to the reference)."""
    cfg = get_smoke_config("llama3.2-3b").replace(remat=True)
    params = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    tokens, targets = TokenStream(512, 16, 2, device="cpu").batch_at(0)
    out = {}
    for policy in ("full", "dots"):
        model = build_model(cfg.replace(remat_policy=policy), device="cpu")
        leaves, spec = tree_flatten(params)
        xs = [p.detach().requires_grad_() for p in leaves]
        loss = model.loss_fn(tree_unflatten(xs, spec), {"tokens": tokens, "targets": targets})[0].mean()
        out[policy] = (loss.detach(), torch.autograd.grad(loss, xs))
    assert torch.equal(out["full"][0], out["dots"][0])
    assert all(torch.equal(a, b) for a, b in zip(out["full"][1], out["dots"][1]))


def test_kernel_guard_raises_under_torch_func_grad():
    """Inside `torch.func.grad` the differentiated inputs are wrapped tensors
    that report requires_grad, so the guard the CUDA wrappers call raises."""
    def f(x):
        forbid_autograd("some_kernel", x * 2.0)
        return x.sum()

    with pytest.raises(RuntimeError, match="no backward kernel"):
        torch.func.grad(f)(torch.ones(3))


# ----------------------------------------------------------- the train step


def _optimizers(name):
    if name == "sgd":
        return jopt.sgd(0.3, momentum=0.9), topt.sgd(0.3, momentum=0.9), None
    return jopt.adamw(3e-3), topt.adamw(3e-3), 2 * 3e-3


PFLUG = dict(k0=1, step=1, thresh=0, burnin=0)


_RUNS = {}


def run_both(arch, mode, n_micro, opt_name, steps=3, overrides=None):
    """Both packages' train steps from the same weights, batches (with the
    family's `frontend_inputs`) and keys (Pflug with thresh 0, so k moves; a
    comm model), the smoke configs with ``overrides`` (fields that change no
    weight); memoised, as the checkpoint tests read the same states."""
    tag = (arch, mode, n_micro, opt_name) + tuple(sorted((overrides or {}).items()))
    if tag in _RUNS:
        return _RUNS[tag]
    _, jmodel, jparams, tmodel, tparams = _model_pair(arch)
    if overrides:
        jmodel = jax_build_model(jmodel.cfg.replace(**overrides))
        tmodel = build_model(tmodel.cfg.replace(**overrides), device="cpu")
    jo, to, _ = _optimizers(opt_name)
    jc, tc = jctl.get_controller("pflug", N_WORKERS, **PFLUG), tctl.get_controller("pflug", N_WORKERS, **PFLUG)
    jstate = jsteps.init_train_state(jmodel, jo, jc, jax.random.PRNGKey(0))._replace(
        params=jparams, opt_state=jo.init(jparams), ctrl_state=jc.init(jparams))
    tstate = tsteps.init_train_state(to, tc, tree_map(torch.clone, tparams))
    jstep = jax.jit(jsteps.make_train_step(jmodel, jo, jc, jstr.Exponential(rate=1.0), N_WORKERS,
                                           jagg.CommModel(0.1, 0.05), n_micro=n_micro, mode=mode))
    tstep = tsteps.make_train_step(tmodel, to, tc, tstr.Exponential(rate=1.0), N_WORKERS, tagg.CommModel(0.1, 0.05),
                                   n_micro=n_micro, mode=mode)
    stream = TokenStream(jmodel.cfg.vocab_size, SEQ, BATCH, seed=0, device="cpu")
    jkey, tkey = jax.random.PRNGKey(7), prng.PRNGKey(7)
    rows = []
    for step in range(steps):
        jbatch, tbatch = both_batches(tmodel.cfg, *stream.batch_at(step), seed=step)
        jkey, jsub = jax.random.split(jkey)
        tkey, tsub = prng.split(tkey).unbind(0)
        jstate, jm = jstep(jstate, jbatch, jsub)
        tstate, tm = tstep(tstate, tbatch, tsub)
        rows.append((jm, tm))
    _RUNS[tag] = jstate, tstate, rows
    return _RUNS[tag]


# (arch, mode, n_micro, optimizer): every mode on llama3.2-3b with SGD, the
# sync and an async mode with AdamW (the other archs' cases, once in sync
# and once in an async mode, are in tests/test_torch_train_steps.py)
STEP_CASES = [("llama3.2-3b", m, n, "sgd") for m, n in (("sync", 1), ("kasync", 1), ("kbatch", 1), ("sync", 2))] + [
    ("llama3.2-3b", "sync", 1, "adamw"), ("llama3.2-3b", "kasync", 1, "adamw")]


def check_train_step(arch, mode, n_micro, opt_name):
    jstate, tstate, rows = run_both(arch, mode, n_micro, opt_name)
    for jm, tm in rows:
        assert int(tm["k"]) == int(jm["k"])
        np.testing.assert_allclose(float(tm["sim_time"]), float(jm["sim_time"]), rtol=1e-6)
        np.testing.assert_allclose(float(tm["ce"]), float(jm["ce"]), rtol=1e-4)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-4)
    assert int(tstate.step) == int(jstate.step) == len(rows)
    adam_atol = _optimizers(opt_name)[2]
    for path, a, b in _leafwise(jstate.params, tstate.params):
        atol = GRAD_TOL[arch] * np.abs(a).max() if adam_atol is None else adam_atol * len(rows)
        np.testing.assert_allclose(b, a, rtol=0, atol=atol, err_msg=path)
    for path, a, b in _leafwise(jstate.ctrl_state, tstate.ctrl_state):
        if a.dtype.kind in "biu":
            np.testing.assert_array_equal(b, a, err_msg=path)
    if mode == "sync":
        assert tstate.exec_async is None
    else:  # the renewal clocks, staleness and pending flags carried across calls
        for path, a, b in _leafwise(jstate.exec_async[1:], tstate.exec_async[1:]):
            np.testing.assert_allclose(b, a, rtol=1e-6, err_msg=path)


@pytest.mark.parametrize("arch,mode,n_micro,opt_name", STEP_CASES)
def test_train_step_matches_reference(arch, mode, n_micro, opt_name):
    check_train_step(arch, mode, n_micro, opt_name)


def test_train_step_refuses_a_ragged_batch_and_async_accumulation():
    _, _, _, tmodel, tparams = _model_pair("llama3.2-3b")
    opt, ctrl = topt.sgd(0.1), tctl.FixedKController(n_workers=3, k=2)
    with pytest.raises(ValueError, match="sync-only"):
        tsteps.make_train_step(tmodel, opt, ctrl, tstr.Exponential(1.0), 3, n_micro=2, mode="kasync")
    step = tsteps.make_train_step(tmodel, opt, ctrl, tstr.Exponential(1.0), 3)
    tokens, targets = TokenStream(512, 8, 4, device="cpu").batch_at(0)
    with pytest.raises(ValueError, match="not divisible"):
        step(tsteps.init_train_state(opt, ctrl, tparams), {"tokens": tokens, "targets": targets}, prng.PRNGKey(0))


# ------------------------------------------------------------- checkpoints


@pytest.mark.parametrize("mode", ["sync", "kasync"])
def test_checkpoints_restore_across_packages(mode, tmp_path):
    """Train states (AdamW, Pflug; kasync's with its renewal state) written
    by each package and restored by the other, leaf for leaf."""
    jstate, tstate, _ = run_both("llama3.2-3b", mode, 1, "adamw")
    tckpt.save(str(tmp_path / "port"), 3, tstate)
    assert jckpt.latest_step(str(tmp_path / "port")) == 3
    back = jckpt.restore(str(tmp_path / "port"), 3, jstate)
    for path, a, b in _leafwise(back, tstate):
        np.testing.assert_array_equal(a, b, err_msg=path)
    jckpt.save(str(tmp_path / "jax"), 3, jstate)
    assert tckpt.latest_step(str(tmp_path / "jax")) == 3
    got = tckpt.restore(str(tmp_path / "jax"), 3, _zeros_like(tstate))
    for path, a, b in _leafwise(jstate, got):
        np.testing.assert_array_equal(b, a, err_msg=path)
    assert [leaf.dtype for leaf in tree_leaves(got)] == [leaf.dtype for leaf in tree_leaves(tstate)]
    with open(tmp_path / "port" / "step_3" / "tree.json") as f, open(tmp_path / "jax" / "step_3" / "tree.json") as g:
        names = json.load(f)["names"]
        assert names == json.load(g)["names"]
    assert ".params/['layers']/['attn']/['wq']" in names


def test_bf16_leaves_restore_across_packages(tmp_path):
    x = np.linspace(-3, 3, 12, dtype=np.float32).reshape(3, 4)
    jtree = {"a": jnp.asarray(x, jnp.bfloat16), "b": jnp.asarray(x)}
    ttree = params_from_jax(jax.tree.map(np.asarray, jtree), device="cpu")
    jckpt.save(str(tmp_path / "jax"), 1, jtree)  # ml_dtypes bfloat16, stored as 2-byte records
    got = tckpt.restore(str(tmp_path / "jax"), 1, _zeros_like(ttree))
    assert got["a"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["a"].view(torch.int16).numpy(), np.asarray(jtree["a"]).view(np.int16))
    tckpt.save(str(tmp_path / "port"), 1, ttree)  # bf16 written as f32, which holds it exactly
    back = jckpt.restore(str(tmp_path / "port"), 1, jtree)
    np.testing.assert_array_equal(np.asarray(back["a"]).view(np.int16), np.asarray(jtree["a"]).view(np.int16))
    with pytest.raises(ValueError, match="tree mismatch"):
        tckpt.restore(str(tmp_path / "port"), 1, {"a": ttree["a"]})


# -------------------------------------------------------------------- CLI


def _json_lines(text):
    return [json.loads(line) for line in text.splitlines() if line.startswith("{")]


CLI = ["--smoke", "--device", "cpu", "--batch", "8", "--seq", "32", "--log-every", "1"]


def test_train_cli_follows_the_reference_loop_and_resumes(tmp_path, capsys):
    ckpt = str(tmp_path / "ckpt")
    ttrain.main(CLI + ["--steps", "3", "--ckpt-dir", ckpt])
    first = _json_lines(capsys.readouterr().out)
    ttrain.main(CLI + ["--steps", "5", "--ckpt-dir", ckpt])
    out = capsys.readouterr().out
    assert "restored step 3" in out
    resumed = _json_lines(out)
    assert [r["step"] for r in first + resumed] == [0, 1, 2, 3, 4]
    assert all(np.isfinite(r["ce"]) for r in first + resumed)
    # the reference CLI's loop (its mesh aside): the same key splits, so the
    # same draws, k and clock; a resumed run restarts the split chain
    cfg = jax_smoke_config("llama3.2-3b")
    jmodel = jax_build_model(cfg)
    opt, ctrl = jopt.adamw(3e-4), jctl.get_controller("pflug", 4, k0=1, step=1, thresh=10, burnin=20)
    jstep = jax.jit(jsteps.make_train_step(jmodel, opt, ctrl, jstr.get_straggler_model("exponential"), 4,
                                           jagg.CommModel(0.0, 0.0)))
    stream = JaxTokenStream(cfg.vocab_size, 32, 8, 0)
    state = jsteps.init_train_state(jmodel, opt, ctrl, jax.random.PRNGKey(0))
    want = []
    for start, stop in ((0, 3), (3, 5)):
        key = jax.random.PRNGKey(0)
        for step in range(start, stop):
            tokens, targets = stream.batch_at(step)
            key, sub = jax.random.split(key)
            state, m = jstep(state, {"tokens": tokens, "targets": targets}, sub)
            want.append((int(m["k"]), round(float(m["sim_time"]), 2), round(float(m["iter_time"]), 3)))
    assert [(r["k"], r["sim_time"], r["iter_time"]) for r in first + resumed] == want
    saved = tckpt.restore(ckpt, 5, tckpt.restore(ckpt, 3, _cli_like()))
    assert int(saved.step) == 5 and round(float(saved.sim_time), 2) == resumed[-1]["sim_time"]


def _cli_like():
    model = build_model(get_smoke_config("llama3.2-3b"), device="cpu")
    opt, ctrl = topt.adamw(3e-4), tctl.get_controller("pflug", 4, k0=1, step=1, thresh=10, burnin=20)
    return tsteps.init_train_state(opt, ctrl, model.init(torch.Generator().manual_seed(0)))


def test_train_cli_async_mode_resumes(tmp_path, capsys):
    ckpt = str(tmp_path / "ckpt")
    ttrain.main(CLI + ["--steps", "2", "--mode", "kbatch", "--ckpt-dir", ckpt])
    ttrain.main(CLI + ["--steps", "3", "--mode", "kbatch", "--ckpt-dir", ckpt])
    out = capsys.readouterr().out
    assert "restored step 2" in out and [r["step"] for r in _json_lines(out)] == [0, 1, 2]


@pytest.mark.parametrize("flag", [["--production-mesh"], ["--distributed"], ["--cache-dir", "x"]])
def test_train_cli_flags_not_ported_raise(flag, tmp_path, capsys):
    """--production-mesh needs a world of 256 ranks and names the world it
    found; --distributed without a process group names the torchrun
    variables it lacks.  --cache-dir is ported (`core/cache.py`): the run
    trains with the kernel build directory re-rooted at DIR."""
    from repro_torch.core import cache

    if flag[0] == "--cache-dir":
        where = tmp_path / flag[1]
        try:
            ttrain.main(CLI + ["--steps", "1", "--cache-dir", str(where)])
            assert cache.persistent_cache_dir() == str(where) and where.is_dir()
        finally:
            cache.disable_persistent_cache()
        assert cache.persistent_cache_dir() is None
        assert len(_json_lines(capsys.readouterr().out)) == 1
        return
    match = {"--production-mesh": "256 ranks; the world has 1", "--distributed": "torchrun environment lacks"}[flag[0]]
    with pytest.raises(SystemExit, match=match):
        ttrain.main(CLI + flag)


def test_checkpointed_is_recomputed_in_the_backward_pass():
    calls = []

    def f(x):
        calls.append(1)
        return (x * 3.0).sin()

    x = torch.ones(4, requires_grad=True)
    transformer.checkpointed(f, x).sum().backward()
    assert len(calls) == 2 and torch.allclose(x.grad, 3.0 * torch.cos(torch.full((4,), 3.0)))
