"""The MoE and hybrid archs' training cases (granite-moe-1b-a400m,
qwen3-moe-30b-a3b, hymba-1.5b) against the JAX package: the per-row loss,
the eq.-(2) gradients and the train step, through tests/test_torch_train.py's
`check_*` helpers and with its tolerances (per-row losses 1e-5 relative,
gradients 1e-4 of each leaf's max, the train step's k equal, sim_time 1e-6
and ce 1e-4 relative, SGD's parameters 1e-4 of each leaf's max, AdamW's 2 lr
a step).  A file of their own, so that tier-1's workers, which take a file
each, share the training cases.
"""

import pytest

pytest.importorskip("torch")

from test_torch_train import check_loss_gradients, check_per_row_loss, check_train_step  # noqa: E402


@pytest.mark.parametrize("arch,t,vocab", [
    ("granite-moe-1b-a400m", 32, None), ("qwen3-moe-30b-a3b", 32, None), ("hymba-1.5b", 32, None),
])
def test_per_row_loss_matches_reference(arch, t, vocab):
    check_per_row_loss(arch, t, vocab)


@pytest.mark.parametrize("arch,t,remat", [
    ("granite-moe-1b-a400m", 32, False), ("qwen3-moe-30b-a3b", 32, True), ("hymba-1.5b", 32, False),
])
def test_weighted_loss_gradients_match_jax_grad(arch, t, remat):
    check_loss_gradients(arch, t, remat)


@pytest.mark.parametrize("arch,mode,n_micro,opt_name", [
    ("granite-moe-1b-a400m", "sync", 1, "adamw"), ("qwen3-moe-30b-a3b", "kbatch", 1, "sgd"),
    ("hymba-1.5b", "sync", 2, "sgd")])
def test_train_step_matches_reference(arch, mode, n_micro, opt_name):
    check_train_step(arch, mode, n_micro, opt_name)
