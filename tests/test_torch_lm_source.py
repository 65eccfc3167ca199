"""The port's LMSource (a registered LM's loss as the engines' gradient
source) on the CPU: its closures against the reference's `LMSource`, fig_lm's
grid against the reference's `run_sweep_source(..., partition="none")`, and
`quickstart --setup lm` as one grid against its looped run.  Weights cross
from the JAX package through `params_from_jax`; the token batch is
`TokenStream`'s, the same bits in both packages.

Tolerances:
- the closures: gradients within 1e-5 of each leaf's max |g|, losses within
  1e-5 relative (the shrunk qwen1.5-0.5b of fig_lm, f32);
- the grid against the reference, those of tests/test_torch_sweep.py: k
  equal, `time` within 1e-5 relative, loss within 1e-4 relative, a Pflug
  cell allowed to fork in k in at most 2 replicas (a near-zero inner
  product of consecutive gradients flips its sign event);
- one grid against the looped engine: `time` and k bitwise, loss within
  1e-6 relative (tests/test_torch_sweep.py).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import controller as jctl  # noqa: E402
from repro.core import straggler as jstr  # noqa: E402
from repro.core import sweep as jsw  # noqa: E402
from repro.launch.lm_source import LMSource as JaxLMSource  # noqa: E402
from repro_torch.core import controller as tctl  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core import straggler as tstr  # noqa: E402
from repro_torch.core import sweep as tsw  # noqa: E402
from repro_torch.core.tree import leaves_with_path  # noqa: E402
from repro_torch.launch import quickstart  # noqa: E402
from repro_torch.launch.lm_source import LMSource  # noqa: E402

OVERRIDES = quickstart.LM["overrides"]
N, ROWS, SEQ = quickstart.LM["n"], quickstart.LM["rows"], quickstart.LM["seq"]
TIME_RTOL, LOSS_RTOL, MAX_FORKS = 1e-5, 1e-4, 2


@pytest.fixture(scope="module")
def sources():
    """(JAX source, its params and data, port source, its params and data)."""
    jsrc, tsrc = JaxLMSource(overrides=OVERRIDES), LMSource(overrides=OVERRIDES)
    jparams = jsrc.init_params(jax.random.PRNGKey(0))
    tparams = tsrc.params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    jdata, tdata = jsrc.make_data(ROWS, SEQ, seed=0), tsrc.make_data(ROWS, SEQ, seed=0, device="cpu")
    for a, b in zip(jdata, tdata):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    return jsrc, jparams, jdata, tsrc, tparams, tdata


def _assert_tree_close(jtree, ttree, tol=1e-5):
    jl = jax.tree.leaves(jtree)
    tl = leaves_with_path(ttree)
    assert len(jl) == len(tl)
    for a, (path, b) in zip(jl, tl):
        a, b = np.asarray(a), b.detach().numpy()
        np.testing.assert_allclose(b, a, rtol=0, atol=tol * max(np.abs(a).max(), 1e-30), err_msg=path)


def test_source_identity_and_validation(sources):
    jsrc, _, _, tsrc, _, tdata = sources
    assert tsrc.cache_token() == jsrc.cache_token() == ("lm", "qwen1.5-0.5b", True, OVERRIDES)
    assert LMSource(overrides=OVERRIDES).model is tsrc.model  # memoised per configuration
    assert tsrc.model.cfg.use_kernels is False
    tsrc.check(tdata, N)
    with pytest.raises(ValueError, match="disagree"):
        tsrc.check((tdata[0], tdata[1][:, :-1]), N)
    with pytest.raises(ValueError, match="not divisible"):
        tsrc.check(tdata, 5)


def test_build_grad_and_eval_match_reference(sources):
    jsrc, jparams, jdata, tsrc, tparams, tdata = sources
    jfns, tfns = jsrc.build(jdata, N), tsrc.build(tdata, N)
    mask = (np.arange(N) % 3 != 1).astype(np.float32)
    k = int(mask.sum())
    jg = jfns.grad(jparams, jnp.asarray(mask), jnp.asarray(k, jnp.int32))
    tg = tfns.grad(tparams, torch.from_numpy(mask), torch.tensor(k, dtype=torch.int32))
    _assert_tree_close(jg, tg)
    np.testing.assert_allclose(float(tfns.eval_loss(tparams)), float(jfns.eval_loss(jparams)), rtol=1e-5)
    n_active = torch.tensor(10, dtype=torch.int32)
    np.testing.assert_allclose(float(tfns.eval_loss_active(tparams, n_active)),
                               float(jfns.eval_loss_active(jparams, jnp.asarray(10, jnp.int32))), rtol=1e-5)


def test_build_stale_matches_reference(sources):
    """The async modes' closures at per-worker snapshots (every slot's own
    perturbation of the parameters)."""
    jsrc, jparams, jdata, tsrc, tparams, tdata = sources
    rng = np.random.default_rng(5)
    noise = jax.tree.map(lambda a: rng.standard_normal((N,) + a.shape).astype(np.float32) * 1e-2, jparams)
    jwp = jax.tree.map(lambda a, z: a[None] + z, jparams, noise)
    twp = tsrc.params_from_jax(jax.tree.map(np.asarray, jwp), device="cpu")
    (jstale, jshard), (tstale, tshard) = jsrc.build_stale(jdata, N), tsrc.build_stale(tdata, N)
    mask = (np.arange(N) % 4 == 0).astype(np.float32)
    k = int(mask.sum())
    _assert_tree_close(jstale(jwp, jnp.asarray(mask), jnp.asarray(k, jnp.int32)),
                       tstale(twp, torch.from_numpy(mask), torch.tensor(k, dtype=torch.int32)))
    _assert_tree_close(jshard(jwp, jnp.asarray(5, jnp.int32)), tshard(twp, torch.tensor(5)))


def _fig_lm_cells(ctl, strag, sw):
    cfg = quickstart.LM
    return [
        sw.SweepCase(ctl.PflugController(n_workers=N, k0=cfg["k0"], step=cfg["k_step"], k_max=cfg["k_cap"],
                                         **cfg["adaptive"]), strag.Exponential(rate=1.0), eta=cfg["eta"],
                     label="adaptive"),
        sw.SweepCase(ctl.FixedKController(n_workers=N, k=cfg["k0"]), strag.Exponential(rate=1.0), eta=cfg["eta"],
                     label="fixed_k4"),
    ]


def test_fig_lm_grid_matches_reference(sources):
    """Two of fig_lm's cells (adaptive, fixed k = 4), R = 2, 60 iterations,
    the loss every 15."""
    jsrc, jparams, jdata, tsrc, tparams, tdata = sources
    keys = jax.random.split(jax.random.PRNGKey(1), 2)
    want = jsw.run_sweep_source(jsrc, jparams, jdata, n_workers=N, cases=_fig_lm_cells(jctl, jstr, jsw),
                                num_iters=60, keys=keys, eval_every=15, partition="none")
    got = tsw.run_sweep_source(tsrc, tparams, tdata, n_workers=N, cases=_fig_lm_cells(tctl, tstr, tsw),
                               num_iters=60, keys=np.asarray(keys), eval_every=15, device="cpu")
    assert got.labels == tuple(want.labels)
    np.testing.assert_array_equal(got.iteration, np.asarray(want.iteration))
    wk, gk = np.asarray(want.k), got.k.numpy()
    for g, label in enumerate(got.labels):
        forked = [r for r in range(wk.shape[1]) if not np.array_equal(gk[g, r], wk[g, r])]
        assert len(forked) <= (MAX_FORKS if label == "adaptive" else 0), (label, forked)
        held = [r for r in range(wk.shape[1]) if r not in forked]
        np.testing.assert_allclose(got.time.numpy()[g, held], np.asarray(want.time)[g, held], rtol=TIME_RTOL)
        np.testing.assert_allclose(got.loss.numpy()[g, held], np.asarray(want.loss)[g, held], rtol=LOSS_RTOL)


def test_setup_lm_grid_equals_its_looped_run():
    grid = quickstart.run_lm(iters=30, replicas=2, device="cpu")
    looped = quickstart.run_lm(iters=30, replicas=2, device="cpu", looped=True)
    assert list(grid["cases"]) == list(looped["cases"]) == ["adaptive", "fixed_k4", "fixed_k16", "schedule_t1"]
    assert grid["t1_times"] == looped["t1_times"] and len(grid["t1_times"]) == 3
    for label, r in grid["results"].items():
        w = looped["results"][label]
        assert torch.equal(r.time, w.time) and torch.equal(r.k, w.k), label
        np.testing.assert_allclose(r.loss.numpy(), w.loss.numpy(), rtol=1e-6, err_msg=label)
        assert bool(torch.isfinite(r.loss).all()) and r.loss.shape == (2, 1)


def test_setup_lm_prints_fig_lms_derived_line(capsys):
    quickstart.main(["--setup", "lm", "--device", "cpu", "--iters", "30", "--replicas", "2"])
    out = capsys.readouterr().out
    assert "final_ce_adaptive=" in out and "final_ce_fixed_k16=" in out and "k_final=" in out
    assert "t1_switches=" in out and "as one grid" in out


def test_init_params_from_a_key_is_deterministic():
    src = LMSource(overrides=OVERRIDES)
    a, b = src.init_params(prng.PRNGKey(3), device="cpu"), src.init_params(prng.PRNGKey(3), device="cpu")
    c = src.init_params(torch.Generator().manual_seed(5), device="cpu")
    assert all(torch.equal(x, y) for (_, x), (_, y) in zip(leaves_with_path(a), leaves_with_path(b)))
    assert not torch.equal(a["embed"], c["embed"])


def test_moe_source_grid_matches_reference():
    """granite-moe-1b-a400m's smoke config as the source (router, capacity
    drops and the load-balance term in every row's loss, under the
    engine's `vmap` over lanes): adaptive and fixed k = 2 cells, n = 4,
    R = 2, 20 iterations, the loss every 10, against the reference's
    `run_sweep_source(..., partition="none")` at the engine's tolerances."""
    n, rows, seq = 4, 8, 16
    jsrc, tsrc = JaxLMSource(arch="granite-moe-1b-a400m"), LMSource(arch="granite-moe-1b-a400m")
    assert tsrc.cache_token() == jsrc.cache_token() and tsrc.model.cfg.family == "moe"
    jparams = jsrc.init_params(jax.random.PRNGKey(0))
    tparams = tsrc.params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    jdata, tdata = jsrc.make_data(rows, seq, seed=0), tsrc.make_data(rows, seq, seed=0, device="cpu")

    def cells(ctl, strag, sw):
        return [sw.SweepCase(ctl.PflugController(n_workers=n, k0=1, step=1, thresh=0, burnin=0),
                             strag.Exponential(rate=1.0), eta=0.05, label="adaptive"),
                sw.SweepCase(ctl.FixedKController(n_workers=n, k=2), strag.Exponential(rate=1.0), eta=0.05,
                             label="fixed_k2")]

    keys = jax.random.split(jax.random.PRNGKey(2), 2)
    want = jsw.run_sweep_source(jsrc, jparams, jdata, n_workers=n, cases=cells(jctl, jstr, jsw), num_iters=20,
                                keys=keys, eval_every=10, partition="none")
    got = tsw.run_sweep_source(tsrc, tparams, tdata, n_workers=n, cases=cells(tctl, tstr, tsw), num_iters=20,
                               keys=np.asarray(keys), eval_every=10, device="cpu")
    assert got.labels == tuple(want.labels)
    wk, gk = np.asarray(want.k), got.k.numpy()
    for g, label in enumerate(got.labels):
        forked = [r for r in range(wk.shape[1]) if not np.array_equal(gk[g, r], wk[g, r])]
        assert len(forked) <= (MAX_FORKS if label == "adaptive" else 0), (label, forked)
        held = [r for r in range(wk.shape[1]) if r not in forked]
        np.testing.assert_allclose(got.time.numpy()[g, held], np.asarray(want.time)[g, held], rtol=TIME_RTOL)
        np.testing.assert_allclose(got.loss.numpy()[g, held], np.asarray(want.loss)[g, held], rtol=LOSS_RTOL)
    assert np.isfinite(got.loss.numpy()).all()
