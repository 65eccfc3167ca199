"""The port's roofline analysis (`roofline/analysis.py`, `roofline/memory.py`)
against the reference's, and `remat_policy="dots"`.

- `count_params` and `model_flops` for all ten archs' full configs: the
  reference's trees by `jax.eval_shape`, the port's under FakeTensorMode;
  exact.
- `roofline_terms` on the same cost dict and hardware: exact.
- `analytic_memory`'s byte fields for all ten archs at train_4k and
  decode_32k on (16, 16) and three of them on (2, 16, 16), on JAX
  `AbstractMesh`es and the port's `MeshAxes` (no device): exact.
- `count_step` on llama3.2-3b's smoke prefill: exactly the hand-derived
  products (the plain attention's two products over every (query, key)
  pair), and the same counts on the fake twin.
- `remat_policy="dots"`: the train step against the reference's with the
  same policy (test_torch_train.py's tolerances); its gradients bitwise
  equal to full remat's; its backward recomputes no product without batch
  dims.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402
from torch.utils._pytree import tree_flatten, tree_leaves, tree_map, tree_unflatten  # noqa: E402

from repro.configs import INPUT_SHAPES as JSHAPES  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.core import controller as jctl  # noqa: E402
from repro.launch import sharding as jsh  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.roofline import analysis as jroof  # noqa: E402
from repro.roofline import memory as jmem  # noqa: E402
from repro_torch.checkpoint import convert, params_from_jax  # noqa: E402
from repro_torch.configs import INPUT_SHAPES, get_config, get_smoke_config, list_archs  # noqa: E402
from repro_torch.core import controller as tctl  # noqa: E402
from repro_torch.core.tree import leaves_with_path  # noqa: E402
from repro_torch.data import TokenStream  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch import sharding as tsh  # noqa: E402
from repro_torch.launch import specs as tspecs  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.roofline import analysis as troof  # noqa: E402
from repro_torch.roofline import memory as tmem  # noqa: E402

_TREES = {}


def _trees(arch):
    """(reference abstract params, port fake params) of the full config."""
    if arch not in _TREES:
        jtree = jax.eval_shape(jax_build_model(jax_config(arch)).init, jax.random.PRNGKey(0))
        with FakeTensorMode():
            ttree = convert.init(get_config(arch), torch.Generator(), "cpu")
        _TREES[arch] = (jtree, ttree)
    return _TREES[arch]


@pytest.mark.parametrize("arch", list_archs())
def test_count_params_and_model_flops_match_the_reference(arch):
    jtree, ttree = _trees(arch)
    assert troof.count_params(ttree) == jroof.count_params(jtree)
    for shape in ("train_4k", "prefill_32k"):
        s = INPUT_SHAPES[shape]
        kind = "train" if s.kind == "train" else "fwd"
        tokens = s.global_batch * s.seq_len
        assert troof.model_flops(get_config(arch), ttree, tokens, kind) == jroof.model_flops(
            jax_config(arch), jtree, tokens, kind)


@pytest.mark.parametrize("cost,coll", [({"flops": 2.5e14, "bytes accessed": 3.1e12}, 1.2e9),
                                       ({"flops": 1e9, "bytes accessed": 4e12}, 0.0),
                                       ({"flops": 1e10, "bytes accessed": 1e9}, 7e10)])
def test_roofline_terms_match_the_reference(cost, coll):
    hw = troof.HW()
    want = jroof.roofline_terms(cost, coll, jroof.HW(peak_flops=hw.peak_flops, hbm_bw=hw.hbm_bw, ici_bw=hw.ici_bw))
    got = troof.roofline_terms(cost, coll, hw)
    for k in ("compute_s", "memory_s", "collective_s", "dominant", "collective_bytes"):
        assert got[k] == want[k], k
    assert (got["flops"], got["bytes_accessed"]) == (want["hlo_flops"], want["hlo_bytes"])


def test_hardware_is_the_h100():
    hw = troof.HW()
    assert (hw.peak_flops, hw.hbm_bw, hw.ici_bw) == (989e12, 3.35e12, 50e9)


_STATES = {}


def _states(arch):
    """(reference train state, port train state) of the full config, the
    reference's Pflug and AdamW as the dry run builds them, abstract."""
    if arch not in _STATES:
        jcfg = jax_config(arch)
        jctrl = jctl.PflugController(n_workers=16, k0=4, step=2, thresh=10, burnin=100)
        jstate = jax.eval_shape(lambda k: jsteps.init_train_state(jax_build_model(jcfg), jadamw(1e-4), jctrl, k),
                                jax.ShapeDtypeStruct((2,), np.uint32))
        tctrl = tctl.PflugController(n_workers=16, k0=4, step=2, thresh=10, burnin=100)
        tstate = tsteps.init_train_state(tadamw(1e-4), tctrl, _trees(arch)[1])
        _STATES[arch] = (jstate, tstate)
    return _STATES[arch]


MEM_CASES = [(a, s, (16, 16)) for a in list_archs() for s in ("train_4k", "decode_32k")] + [
    ("llama3.2-3b", "train_4k", (2, 16, 16)), ("qwen3-moe-30b-a3b", "decode_32k", (2, 16, 16)),
    ("rwkv6-3b", "long_500k", (2, 16, 16))]


@pytest.mark.parametrize("arch,shape,mesh", MEM_CASES, ids=["-".join(map(str, (a, s, "x".join(map(str, m)))))
                                                            for a, s, m in MEM_CASES])
def test_analytic_memory_matches_the_reference(arch, shape, mesh):
    names = ("pod", "data", "model")[-len(mesh):]
    jm, tm = AbstractMesh(mesh, names), tsh.MeshAxes(names, mesh)
    jcfg, tcfg = jax_config(arch), get_config(arch)
    js, ts = JSHAPES[shape], INPUT_SHAPES[shape]
    jparams, tparams = _trees(arch)
    jp_sh, tp_sh = jsh.param_shardings(jparams, jm), tsh.param_shardings(tparams, tm)
    if ts.kind == "train":
        jstate, tstate = _states(arch)
        want = jmem.analytic_memory(jcfg, js, jm, jstate, jsh.param_shardings(jstate, jm), params_sds=jparams,
                                    params_shardings=jp_sh)
        got = tmem.analytic_memory(tcfg, ts, tm, tstate, tsh.param_shardings(tstate, tm), params=tparams,
                                   params_shardings=tp_sh)
    else:
        jcache, tcache = jspecs.input_specs(jcfg, js)["cache"], tspecs.input_specs(tcfg, ts)["cache"]
        want = jmem.analytic_memory(jcfg, js, jm, jparams, jp_sh, params_sds=jparams, params_shardings=jp_sh,
                                    cache_sds=jcache, cache_shardings=jsh.batch_shardings(jcache, jm))
        got = tmem.analytic_memory(tcfg, ts, tm, tparams, tp_sh, params=tparams, params_shardings=tp_sh,
                                   cache=tcache, cache_shardings=tsh.batch_shardings(tcache, tm))
    keys = sorted(k for k in want if k.endswith("_bytes"))
    assert keys == sorted(k for k in got if k.endswith("_bytes"))
    for k in keys:
        assert got[k] == want[k], k
    assert got["fits_80gb"] == (want["total_bytes"] < 80e9)


# --------------------------------------------------------------- counting


def _smoke_prefill_flops(cfg, b, t):
    """The products of a llama smoke prefill on the CPU: per layer the q, k,
    v and o projections, the plain attention's two products over all T x T
    pairs, the three MLP products; then the last position's logits."""
    d, h, kv, hd, f = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim, cfg.d_ff
    per_layer = 2 * b * t * d * (h + 2 * kv) * hd + 2 * b * t * h * hd * d + 4 * b * h * t * t * hd + 6 * b * t * d * f
    return cfg.n_layers * per_layer + 2 * b * d * cfg.padded_vocab


def test_count_step_counts_a_smoke_prefill_exactly_and_its_fake_twin_alike():
    cfg = get_smoke_config("llama3.2-3b")
    model = build_model(cfg, "cpu")
    params = convert.init(cfg, torch.Generator().manual_seed(0), "cpu")
    prompts = serve.random_prompts(cfg, 2, 128, seed=1, device="cpu")
    real = troof.count_step(model.prefill, params, {"tokens": prompts})
    assert real["flops"] == _smoke_prefill_flops(cfg, 2, 128)
    assert real["bytes accessed"] > 0 and real["collectives"]["total"] == 0
    weights = sum(p.numel() * p.element_size() for p in tree_leaves(params))
    assert real["peak_bytes"] > weights
    with FakeTensorMode():
        fparams = convert.init(cfg, torch.Generator(), "cpu")
        fake = troof.count_step(model.prefill, fparams, {"tokens": torch.empty(prompts.shape, dtype=prompts.dtype)})
    assert (fake["flops"], fake["bytes accessed"], fake["peak_bytes"]) == (
        real["flops"], real["bytes accessed"], real["peak_bytes"])


def test_count_step_leaves_views_out_of_the_bytes():
    x = torch.ones(64, 32)
    cost = troof.count_step(lambda a: a.t().reshape(32, 64)[:16].sum(), x)
    # the sum reads the view's 16 x 64 floats and writes one; the views move nothing
    assert cost["bytes accessed"] == 16 * 64 * 4 + 4 and cost["flops"] == 0


def test_collective_kinds_cover_the_functional_collectives():
    assert troof._collective_kind("_c10d_functional::all_gather_into_tensor") == "all-gather"
    assert troof._collective_kind("_c10d_functional::reduce_scatter_tensor") == "reduce-scatter"
    assert troof._collective_kind("_c10d_functional::all_reduce") == "all-reduce"
    assert troof._collective_kind("_c10d_functional::all_to_all_single") == "all-to-all"
    assert troof._collective_kind("c10d::allgather_") == "all-gather"
    assert troof._collective_kind("_c10d_functional::wait_tensor") == "none"
    assert troof._collective_kind("aten::mm") is None
    with pytest.raises(ValueError, match="no known type"):
        troof._collective_kind("c10d::something_new")


# ------------------------------------------------------------ remat "dots"


def _grads(policy, params):
    cfg = get_smoke_config("llama3.2-3b").replace(remat=True, remat_policy=policy)
    model = build_model(cfg, "cpu")
    tokens, targets = TokenStream(cfg.vocab_size, 16, 2, device="cpu").batch_at(0)
    leaves, spec = tree_flatten(params)
    xs = [p.detach().requires_grad_() for p in leaves]

    class Products(TorchDispatchMode):
        """Counts products without batch dims: `mm`, `addmm` and batch-1 `bmm`."""

        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default) or (
                func is torch.ops.aten.bmm.default and args[0].shape[0] == 1)
            return func(*args, **(kwargs or {}))

    with Products() as fwd:
        loss = model.loss_fn(tree_unflatten(xs, spec), {"tokens": tokens, "targets": targets})[0].mean()
    with Products() as bwd:
        grads = torch.autograd.grad(loss, xs)
    return loss, grads, fwd.n, bwd.n


def test_remat_dots_gradients_equal_full_and_recompute_no_product():
    """The same loss and gradients bit for bit (the CPU recomputes
    deterministically); the backward of "dots" runs only the two gradient
    products of each forward product, where "full" recomputes some first."""
    params = convert.init(get_smoke_config("llama3.2-3b"), torch.Generator().manual_seed(0), "cpu")
    full_loss, full_g, full_fwd, full_bwd = _grads("full", params)
    dots_loss, dots_g, dots_fwd, dots_bwd = _grads("dots", params)
    assert torch.equal(full_loss, dots_loss)
    assert all(torch.equal(a, b) for a, b in zip(full_g, dots_g))
    assert full_fwd == dots_fwd
    assert dots_bwd == 2 * dots_fwd
    assert full_bwd > dots_bwd


def test_remat_dots_train_step_matches_the_reference():
    """The sync train step with remat on and policy "dots" in both packages
    (the reference's `dots_with_no_batch_dims_saveable`), three steps with
    AdamW: test_torch_train.py's tolerances (k exact, sim_time 1e-6, ce and
    loss 1e-4, parameters within 2 lr a step)."""
    over = dict(remat=True, remat_policy="dots")
    jcfg, tcfg = jax_smoke_config("llama3.2-3b").replace(**over), get_smoke_config("llama3.2-3b").replace(**over)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    from repro.core import aggregation as jagg
    from repro.core import straggler as jstr
    from repro_torch.core import aggregation as tagg
    from repro_torch.core import prng
    from repro_torch.core import straggler as tstr

    pflug = dict(k0=1, step=1, thresh=0, burnin=0)
    jo, to = jadamw(3e-3), tadamw(3e-3)
    jc, tc = jctl.get_controller("pflug", 4, **pflug), tctl.get_controller("pflug", 4, **pflug)
    jstate = jsteps.init_train_state(jmodel, jo, jc, jax.random.PRNGKey(0))._replace(
        params=jparams, opt_state=jo.init(jparams), ctrl_state=jc.init(jparams))
    tstate = tsteps.init_train_state(to, tc, tree_map(torch.clone, tparams))
    jstep = jax.jit(jsteps.make_train_step(jmodel, jo, jc, jstr.Exponential(rate=1.0), 4, jagg.CommModel(0.1, 0.05)))
    tstep = tsteps.make_train_step(build_model(tcfg, "cpu"), to, tc, tstr.Exponential(rate=1.0), 4,
                                   tagg.CommModel(0.1, 0.05))
    stream = TokenStream(tcfg.vocab_size, 32, 8, seed=0, device="cpu")
    jkey, tkey = jax.random.PRNGKey(7), prng.PRNGKey(7)
    for step in range(3):
        tokens, targets = stream.batch_at(step)
        jkey, jsub = jax.random.split(jkey)
        tkey, tsub = prng.split(tkey).unbind(0)
        jstate, jm = jstep(jstate, {"tokens": jax.numpy.asarray(tokens.numpy()),
                                    "targets": jax.numpy.asarray(targets.numpy())}, jsub)
        tstate, tm = tstep(tstate, {"tokens": tokens, "targets": targets}, tsub)
        assert int(tm["k"]) == int(jm["k"])
        np.testing.assert_allclose(float(tm["sim_time"]), float(jm["sim_time"]), rtol=1e-6)
        np.testing.assert_allclose(float(tm["ce"]), float(jm["ce"]), rtol=1e-4)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-4)
    jl = jax.tree.leaves(jstate.params)
    tl = leaves_with_path(tstate.params)  # in JAX's order
    assert len(jl) == len(tl)
    for a, (path, b) in zip(jl, tl):
        np.testing.assert_allclose(b.float().numpy(), np.asarray(a, np.float32), rtol=0, atol=2 * 3e-3 * 3,
                                   err_msg=path)


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_recomputation_reenters_the_forward_layout_on_another_thread(policy):
    """The backward of CUDA tensors runs on autograd's device thread, where
    the thread-local activation resolver is unset; a checkpointed region's
    recomputation re-enters the forward pass's (found by the dry run on
    fake CUDA tensors: the chunked cross-entropy recomputed its logits
    replicated, not batch-sharded).  Here the backward runs on a thread of
    its own."""
    import threading

    from repro_torch import shardctx
    from repro_torch.models import transformer

    seen = []

    def f(x):
        seen.append(shardctx._resolver())
        return (x @ x.T).sin()

    def resolver(*args, **kwargs):
        return None

    x = torch.ones(3, 3, requires_grad=True)
    with shardctx.activation_sharding(resolver):
        y = transformer.checkpointed(f, x, policy=policy).sum()
    worker = threading.Thread(target=y.backward)
    worker.start()
    worker.join()
    assert seen == [resolver, resolver] and x.grad is not None
