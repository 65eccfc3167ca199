"""The port's MoE layer (`repro_torch/models/moe.py`) against the JAX
package's, on the CPU, at the smoke width of granite-moe-1b-a400m (4
experts, top-2), with the same weights through `params_from_jax` and the
same seeded numpy inputs.

The reference keeps its routing inside `moe_layer`; the test reads it from
the arguments `moe_layer` hands its dispatch functions.

Tolerances: the routing (expert indices, queue positions, kept flags)
exactly equal; the gates within 1e-6 (f32 softmax and normalisation, ~1
ulp seen); y within rtol = atol = 1e-5 (XLA and torch sum the expert
products in other orders: ~1e-7 seen); the load-balance loss within 1e-6.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.checkpoint import params_from_jax  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import moe  # noqa: E402

ARCH = "granite-moe-1b-a400m"
DISPATCHES = ["einsum", "gather", "hybrid", "scatter"]
TOL = dict(rtol=1e-5, atol=1e-5)


def _configs(**kw):
    return jax_smoke_config(ARCH).replace(**kw), get_smoke_config(ARCH).replace(**kw)


def _params(jcfg, seed=0):
    jp = jmoe.moe_init(jax.random.PRNGKey(seed), jcfg)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def _inputs(shape, seed=1, scale=0.5):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _jax_moe_with_routing(monkeypatch, jp, jcfg, x):
    """The reference's (y, aux) and the routing (idxs, gates, positions) its
    `moe_layer` hands the dispatch."""
    seen = {}
    real_gather, real_einsum = jmoe._dispatch_gather, jmoe._dispatch_einsum

    def record(idxs, gates, positions):
        seen.update(idxs=np.asarray(idxs), gates=np.asarray(gates), positions=np.asarray(positions))

    def gather(params, cfg, x, idxs, gates, positions, c, combine="gather"):
        record(idxs, gates, positions)
        return real_gather(params, cfg, x, idxs, gates, positions, c, combine=combine)

    def einsum(params, cfg, x, idxs, gates, positions, c):
        record(idxs, gates, positions)
        return real_einsum(params, cfg, x, idxs, gates, positions, c)

    monkeypatch.setattr(jmoe, "_dispatch_gather", gather)
    monkeypatch.setattr(jmoe, "_dispatch_einsum", einsum)
    y, aux = jmoe.moe_layer(jp, jcfg, jnp.asarray(x))
    return np.asarray(y), float(aux), seen


def _assert_routing_equal(tcfg, tp, x, seen):
    idxs, gates, positions, _ = moe.route(tp, tcfg, torch.from_numpy(x))
    np.testing.assert_array_equal(idxs.numpy(), seen["idxs"])
    np.testing.assert_array_equal(positions.numpy(), seen["positions"])
    np.testing.assert_array_equal(gates.numpy() > 0, seen["gates"] > 0)
    np.testing.assert_allclose(gates.numpy(), seen["gates"], rtol=0, atol=1e-6)
    return gates.numpy()


@pytest.mark.parametrize("cf", [0.5, 1.25, 8.0])
@pytest.mark.parametrize("dispatch", DISPATCHES)
def test_moe_layer_matches_reference(monkeypatch, dispatch, cf):
    jcfg, tcfg = _configs(capacity_factor=cf, moe_dispatch=dispatch)
    jp, tp = _params(jcfg)
    x = _inputs((2, 16, jcfg.d_model))
    jy, jaux, seen = _jax_moe_with_routing(monkeypatch, jp, jcfg, x)
    gates = _assert_routing_equal(tcfg, tp, x, seen)
    y, aux = moe.moe_layer(tp, tcfg, torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), jy, **TOL)
    np.testing.assert_allclose(float(aux), jaux, rtol=0, atol=1e-6)
    dropped = int((gates == 0).sum())
    assert (dropped > 0) == (cf == 0.5 or cf == 1.25) and (cf != 8.0 or dropped == 0)


@pytest.mark.parametrize("dispatch", DISPATCHES)
def test_gelu_experts_match_reference(monkeypatch, dispatch):
    """The non-GLU expert MLP (tanh gelu, no w_gate)."""
    jcfg, tcfg = _configs(activation="gelu", moe_dispatch=dispatch)
    jp, tp = _params(jcfg)
    assert "w_gate" not in tp
    x = _inputs((2, 16, jcfg.d_model), seed=4)
    jy, jaux, seen = _jax_moe_with_routing(monkeypatch, jp, jcfg, x)
    _assert_routing_equal(tcfg, tp, x, seen)
    y, aux = moe.moe_layer(tp, tcfg, torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), jy, **TOL)
    np.testing.assert_allclose(float(aux), jaux, rtol=0, atol=1e-6)


@pytest.mark.parametrize("dispatch", DISPATCHES)
def test_tied_router_picks_lowest_experts_first(monkeypatch, dispatch):
    """A zero router ties every expert: `lax.top_k` takes the lowest
    indices, so every token goes to experts 0 and 1 and the queues fill in
    sequence order; the port follows."""
    jcfg, tcfg = _configs(moe_dispatch=dispatch)
    jp, tp = _params(jcfg)
    jp = {**jp, "router": jnp.zeros_like(jp["router"])}
    tp = {**tp, "router": torch.zeros_like(tp["router"])}
    x = _inputs((2, 16, jcfg.d_model), seed=2)
    jy, _, seen = _jax_moe_with_routing(monkeypatch, jp, jcfg, x)
    assert (seen["idxs"][0] == 0).all() and (seen["idxs"][1] == 1).all()
    _assert_routing_equal(tcfg, tp, x, seen)
    y, _ = moe.moe_layer(tp, tcfg, torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), jy, **TOL)


def test_decode_group_of_one_token_has_capacity_one(monkeypatch):
    """One token a group (decode): C = max(int(1.25 * 1 * 2 / 4), 1) = 1."""
    jcfg, tcfg = _configs()
    assert moe._capacity(tcfg, 1) == jmoe._capacity(jcfg, 1) == 1
    for s in (1, 7, 16, 1024):
        for cf in (0.5, 1.25, 4.0):
            assert moe._capacity(tcfg.replace(capacity_factor=cf), s) == jmoe._capacity(
                jcfg.replace(capacity_factor=cf), s)
    jp, tp = _params(jcfg)
    x = _inputs((3, 1, jcfg.d_model), seed=3)
    jy, jaux, seen = _jax_moe_with_routing(monkeypatch, jp, jcfg, x)
    _assert_routing_equal(tcfg, tp, x, seen)
    y, aux = moe.moe_layer(tp, tcfg, torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), jy, **TOL)


def test_moe_capacity_drops_and_aux_loss():
    """The port's counterpart of tests/test_models.py's test of the same name."""
    cfg = get_smoke_config(ARCH).replace(capacity_factor=0.5)
    p = moe.moe_init(torch.Generator().manual_seed(0), cfg, "cpu")
    x = torch.randn((2, 16, cfg.d_model), generator=torch.Generator().manual_seed(1)) * 0.1
    y, aux = moe.moe_layer(p, cfg, x)
    assert y.shape == x.shape
    assert float(aux) >= 1.0 - 1e-3  # load-balance loss >= 1 (perfect balance = 1)
    assert bool((moe.route(p, cfg, x)[1] == 0).any())  # capacity 4 of 16 tokens x 2 slots / 4 experts drops


@pytest.mark.parametrize("dispatch", DISPATCHES)
def test_moe_full_capacity_matches_dense_expert_mixture(dispatch):
    """The port's counterpart of tests/test_models.py's test of the same name:
    with capacity >= tokens (no drops) the capacity dispatch equals
    computing every expert densely and mixing the top-k."""
    cfg = get_smoke_config(ARCH).replace(capacity_factor=8.0, moe_dispatch=dispatch)
    p = moe.moe_init(torch.Generator().manual_seed(0), cfg, "cpu")
    x = torch.randn((2, 8, cfg.d_model), generator=torch.Generator().manual_seed(1)) * 0.1
    y, _ = moe.moe_layer(p, cfg, x)

    probs = torch.softmax(x @ p["router"], -1)
    top_p, top_i = torch.topk(probs, cfg.moe_top_k)
    top_p = top_p / top_p.sum(-1, keepdim=True)
    dense = torch.nn.functional.silu(torch.einsum("gsd,edf->gsef", x, p["w_gate"]))
    dense = dense * torch.einsum("gsd,edf->gsef", x, p["w_in"])
    dense = torch.einsum("gsef,efd->gsed", dense, p["w_out"])
    mix = torch.zeros_like(x)
    for kk in range(cfg.moe_top_k):
        sel = torch.gather(dense, 2, top_i[..., kk][..., None, None].expand(-1, -1, 1, x.shape[-1]))[:, :, 0]
        mix = mix + top_p[..., kk][..., None] * sel
    np.testing.assert_allclose(y.numpy(), mix.numpy(), atol=1e-4)


@pytest.mark.parametrize("dispatch", DISPATCHES)
def test_gradients_match_jax_grad(dispatch):
    """d(sum(y * w) + aux)/d(params, x), through autograd, against jax.grad:
    within 1e-5 of each leaf's max |g|."""
    jcfg, tcfg = _configs(moe_dispatch=dispatch)
    jp, tp = _params(jcfg)
    x = _inputs((2, 16, jcfg.d_model), seed=5)
    w = _inputs((2, 16, jcfg.d_model), seed=6, scale=1.0)

    def jloss(p, xx):
        y, aux = jmoe.moe_layer(p, jcfg, xx)
        return jnp.sum(y * w) + aux

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    leaves = {k: v.detach().requires_grad_() for k, v in tp.items()}
    xt = torch.from_numpy(x).requires_grad_()
    y, aux = moe.moe_layer(leaves, tcfg, xt)
    grads = torch.autograd.grad((y * torch.from_numpy(w)).sum() + aux, [*leaves.values(), xt])
    for (name, g), want in zip(list(zip(leaves, grads[:-1])) + [("x", grads[-1])], [*(jg[k] for k in leaves), jgx]):
        want = np.asarray(want)
        np.testing.assert_allclose(g.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max(), err_msg=name)


def test_moe_layer_maps_under_vmap():
    """`torch.func.vmap` over a leading axis (the engines' lanes) gives each
    slice's own result: the scatters are out of place."""
    _, tcfg = _configs(moe_dispatch="hybrid")
    p = moe.moe_init(torch.Generator().manual_seed(0), tcfg, "cpu")
    xs = torch.from_numpy(_inputs((3, 2, 16, tcfg.d_model), seed=7))
    ys, auxs = torch.func.vmap(lambda x: moe.moe_layer(p, tcfg, x))(xs)
    for i in range(3):
        y, aux = moe.moe_layer(p, tcfg, xs[i])
        np.testing.assert_allclose(ys[i].numpy(), y.numpy(), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(float(auxs[i]), float(aux), rtol=1e-6)
