"""The per-row loss and the eq.-(2) weighted gradients of llama3.2-3b,
rwkv6-3b and qwen1.5-0.5b against the JAX package, through
tests/test_torch_train.py's `check_per_row_loss` and `check_loss_gradients`
and with their tolerances (the loss 1e-5 relative, the gradients at
`GRAD_TOL` of each leaf's max).  A file of its own, so that tier-1's
workers, which take a file each, share test_torch_train.py's cases.
"""

import pytest

torch = pytest.importorskip("torch")

from test_torch_train import check_loss_gradients, check_per_row_loss  # noqa: E402


@pytest.mark.parametrize("arch,t,vocab", [
    ("llama3.2-3b", 32, None), ("rwkv6-3b", 32, None), ("qwen1.5-0.5b", 32, None),
    ("qwen1.5-0.5b", 1024, None),  # the chunked cross-entropy: two chunks of 512
    ("llama3.2-3b", 32, 500),  # a padded vocab: 500 of 512 columns
])
def test_per_row_loss_matches_reference(arch, t, vocab):
    check_per_row_loss(arch, t, vocab)


@pytest.mark.parametrize("arch,t,remat", [
    ("llama3.2-3b", 32, False), ("llama3.2-3b", 32, True), ("rwkv6-3b", 32, False), ("rwkv6-3b", 32, True),
    ("qwen1.5-0.5b", 32, False),
    ("qwen1.5-0.5b", 1024, True),  # remat of every block and of each cross-entropy chunk
])
def test_weighted_loss_gradients_match_jax_grad(arch, t, remat):
    check_loss_gradients(arch, t, remat)
