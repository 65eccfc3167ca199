"""The train step of rwkv6-3b and qwen1.5-0.5b against the JAX package, once
in sync and once in an async mode, through tests/test_torch_train.py's
`check_train_step` and with its tolerances (k equal, sim_time 1e-6 and ce
1e-4 relative, SGD's parameters 1e-4 of each leaf's max, rwkv6-3b's 1e-3),
and Pflug adapting k on the LM as the reference does.  A file of its own,
so that tier-1's workers, which take a file each, share the training cases.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from torch.utils._pytree import tree_map  # noqa: E402

from repro.core import controller as jctl  # noqa: E402
from repro.core import straggler as jstr  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro_torch.core import controller as tctl  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core import straggler as tstr  # noqa: E402
from repro_torch.data import TokenStream  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.optim import optimizers as topt  # noqa: E402
from test_torch_train import BATCH, N_WORKERS, _jnp_batch, _model_pair, check_train_step  # noqa: E402


@pytest.mark.parametrize("arch,mode,n_micro,opt_name", [
    ("rwkv6-3b", "sync", 2, "sgd"), ("rwkv6-3b", "kbatch", 1, "sgd"),
    ("qwen1.5-0.5b", "sync", 1, "sgd"), ("qwen1.5-0.5b", "kasync", 1, "sgd")])
def test_train_step_matches_reference(arch, mode, n_micro, opt_name):
    check_train_step(arch, mode, n_micro, opt_name)


def test_pflug_adapts_k_on_the_lm_as_the_reference_does():
    """tests/test_system.py's run (qwen1.5-0.5b smoke, SGD at lr 0.5, Pflug
    thresh 1 burn-in 2, 25 steps) without its mesh: the port moves k at the
    same steps as the reference."""
    _, jmodel, jparams, tmodel, tparams = _model_pair("qwen1.5-0.5b")
    ctrl = ("pflug", dict(k0=1, step=1, thresh=1, burnin=2))
    jo, to = jopt.sgd(0.5), topt.sgd(0.5)
    jc, tc = jctl.get_controller(*ctrl[:1], N_WORKERS, **ctrl[1]), tctl.get_controller(*ctrl[:1], N_WORKERS,
                                                                                        **ctrl[1])
    jstate = jsteps.init_train_state(jmodel, jo, jc, jax.random.PRNGKey(0))._replace(params=jparams)
    tstate = tsteps.init_train_state(to, tc, tree_map(torch.clone, tparams))
    jstep = jax.jit(jsteps.make_train_step(jmodel, jo, jc, jstr.Exponential(rate=1.0), N_WORKERS))
    tstep = tsteps.make_train_step(tmodel, to, tc, tstr.Exponential(rate=1.0), N_WORKERS)
    tokens, targets = TokenStream(512, 32, BATCH, seed=1, device="cpu").batch_at(0)
    jkey, tkey = jax.random.PRNGKey(2), prng.PRNGKey(2)
    jks, tks = [], []
    for _ in range(25):
        jkey, jsub = jax.random.split(jkey)
        tkey, tsub = prng.split(tkey).unbind(0)
        jstate, jm = jstep(jstate, _jnp_batch(tokens, targets), jsub)
        tstate, tm = tstep(tstate, {"tokens": tokens, "targets": targets}, tsub)
        jks.append(int(jm["k"]))
        tks.append(int(tm["k"]))
        assert bool(torch.isfinite(tm["ce"]))
    assert tks == jks and max(tks) > 1, (tks, jks)
