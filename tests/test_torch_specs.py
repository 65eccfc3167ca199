"""`launch/specs.py` and `launch/steps.py::make_prefill_step` and
`make_decode_step` against the JAX package: the window policy, the cache
length, and the input stand-ins (meta tensors where the reference gives
`jax.ShapeDtypeStruct`s), mirroring tests/test_distribution.py's cases,
then every arch's stand-ins shape for shape and dtype for dtype.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import INPUT_SHAPES as JAX_INPUT_SHAPES  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro_torch.configs import INPUT_SHAPES, InputShape, get_smoke_config, list_archs  # noqa: E402
from repro_torch.launch import specs, steps  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from test_torch_train import frontend_inputs  # noqa: E402


def test_input_shapes_are_the_reference_shapes():
    assert {k: vars(v) for k, v in INPUT_SHAPES.items()} == {k: vars(v) for k, v in JAX_INPUT_SHAPES.items()}


def test_window_policy():
    cfg_ssm = get_smoke_config("rwkv6-3b")
    cfg_dense = get_smoke_config("llama3.2-3b")
    long_shape = INPUT_SHAPES["long_500k"]
    assert specs.window_for(cfg_ssm, long_shape) == 0  # SSM needs nothing
    assert specs.window_for(cfg_dense, long_shape) == cfg_dense.long_context_window
    assert specs.window_for(cfg_dense, INPUT_SHAPES["train_4k"]) == 0
    assert specs.cache_len_for(cfg_dense, long_shape) == cfg_dense.long_context_window


def test_input_specs_shapes():
    cfg = get_smoke_config("paligemma-3b")
    sds = specs.input_specs(cfg, INPUT_SHAPES["train_4k"])
    assert sds["tokens"].shape == (256, 4096)
    assert sds["patches"].shape == (256, cfg.vlm_patches, cfg.d_model)
    dec = specs.input_specs(cfg, INPUT_SHAPES["decode_32k"])
    assert dec["token"].shape == (128, 1)
    assert "patches" not in dec  # already inside the cache
    assert dec["cache"]["k"].shape[0] == cfg.n_layers


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v for k, sub in tree.items() for k2, v in _flat(sub, f"{prefix}/{k}").items()}
    return {prefix: tree}


@pytest.mark.parametrize("shape", list(INPUT_SHAPES))
@pytest.mark.parametrize("arch", list_archs())
def test_every_arch_matches_the_reference_specs(arch, shape):
    """Each stand-in has the reference's shape and dtype, lies on the meta
    device and holds no storage; the window policy and cache length agree."""
    cfg, jcfg = get_smoke_config(arch), jax_smoke_config(arch)
    got = _flat(specs.input_specs(cfg, INPUT_SHAPES[shape]))
    want = _flat(jspecs.input_specs(jcfg, JAX_INPUT_SHAPES[shape]))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert tuple(got[k].shape) == tuple(w.shape), k
        assert str(got[k].dtype).removeprefix("torch.") == np.dtype(w.dtype).name, k
        assert got[k].device.type == "meta"
    assert specs.window_for(cfg, INPUT_SHAPES[shape]) == jspecs.window_for(jcfg, JAX_INPUT_SHAPES[shape])
    assert specs.cache_len_for(cfg, INPUT_SHAPES[shape]) == jspecs.cache_len_for(jcfg, JAX_INPUT_SHAPES[shape])


def test_stub_inputs_are_the_reference_clis_zeros():
    """What the serve and train CLIs feed: f32 zeros of the stubs' shapes."""
    for arch, key in (("paligemma-3b", "patches"), ("seamless-m4t-medium", "frames")):
        cfg = get_smoke_config(arch)
        stubs = specs.stub_inputs(cfg, 3, "cpu")
        assert list(stubs) == [key] and stubs[key].dtype == torch.float32 and not stubs[key].any()
        assert tuple(stubs[key].shape) == tuple(specs.input_specs(cfg, InputShape("s", 8, 3, "prefill"))[key].shape)
    assert specs.stub_inputs(get_smoke_config("llama3.2-3b"), 3, "cpu") == {}


@pytest.mark.parametrize("arch", ["llama3.2-3b", "seamless-m4t-medium"])
def test_prefill_and_decode_steps_run_at_the_shapes_window(arch):
    """long_500k switches an attention arch to its sliding window: the step
    makers pass it to prefill and decode (here a 16-token window over a
    32-token prompt, so the window changes the result); encdec's decode step
    takes its memory as an extra."""
    cfg = get_smoke_config(arch).replace(long_context_window=16)
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    shape = InputShape("long_500k", 32, 2, "prefill")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 32)))
    batch = {"tokens": tokens, **{k: torch.from_numpy(v) for k, v in frontend_inputs(cfg, 2, 0).items()}}
    got, cache = steps.make_prefill_step(model, cfg, shape)(params, batch)
    want, _ = model.prefill(params, batch, window=16)
    full, _ = model.prefill(params, batch, window=0)
    assert torch.equal(got, want) and not torch.equal(got, full) and cache["k"].shape[2] == 16
    extras = {"enc_out": model.encode(params, batch["frames"])} if cfg.family == "encdec" else {}
    token = got.argmax(-1)[:, None]
    step, _ = steps.make_decode_step(model, cfg, shape)(params, token, {k: v.clone() for k, v in cache.items()}, 32,
                                                        **extras)
    plain, _ = model.decode_step(params, token, {k: v.clone() for k, v in cache.items()}, 32, window=16, **extras)
    assert torch.equal(step, plain)
