"""The port's figure functions against the reference's figure scripts, the
grids of `launch.quickstart` that fig2, fig_async, fig_byzantine and fig_lm
run: each CSV's header, labels and numbers, each row's name and `derived`
keys, and fig_lm's bench section, on the CPU at reduced sizes.  The
reference's scripts, the helpers and the tolerances are those of
tests/test_torch_figures.py.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro_torch.launch import figures  # noqa: E402
from test_torch_figures import _assert_csv, _derived_keys, _eta, one_thread, reference  # noqa: E402,F401


@pytest.mark.parametrize("fig,kw,text_cols,decimals", [
    ("fig2", dict(iters=100, n_replicas=2), {0, 1}, {2: 2, 3: 3, 6: 2}),
    ("fig_async", dict(iters=40, n_replicas=2, eval_every=20), {0, 1, 2}, {3: 2, 4: 3, 7: 2}),
    ("fig_byzantine", dict(iters=50, n_replicas=2, eval_every=25), {0, 1, 2, 3, 4}, {5: 2, 6: 3, 9: 2}),
])
def test_grid_figure_csv_matches_reference(reference, tmp_path, fig, kw, text_cols, decimals):
    if fig == "fig_async":
        kw_ref, kw_port = dict(kw, bench_iters=None), dict(kw, bench_iters=None, eta=_eta(400, 20, 0.5))
    elif fig == "fig_byzantine":
        kw_ref, kw_port = kw, dict(kw, eta=_eta(400, 20, 1.5))
    else:
        kw_ref, kw_port = kw, dict(kw, eta=_eta(2000, 100, 0.5))
    want = reference(fig).run(str(tmp_path / "ref.csv"), **kw_ref)
    got = getattr(figures, f"run_{fig}")(str(tmp_path / "port.csv"), device="cpu", **kw_port)
    assert got["name"] == want["name"] and _derived_keys(got) == _derived_keys(want)
    _assert_csv(tmp_path / "port.csv", tmp_path / "ref.csv", text_cols=text_cols, decimals=decimals)


def test_fig_lm_csv_and_bench_section_match_reference(reference, tmp_path):
    from repro.launch.lm_source import LMSource as JaxLMSource
    from repro_torch.launch.lm_source import LMSource

    cfg = figures.quickstart.LM
    jparams = JaxLMSource(arch=cfg["arch"], smoke=True, overrides=cfg["overrides"]).init_params(jax.random.PRNGKey(0))
    params0 = LMSource(arch=cfg["arch"], smoke=True, overrides=cfg["overrides"]).params_from_jax(
        jax.tree.map(np.asarray, jparams), device="cpu")
    kw = dict(iters=15, n_replicas=2, eval_every=15, smoke=True)
    want = reference("fig_lm").run(str(tmp_path / "ref.csv"), bench_json=str(tmp_path / "ref.json"), **kw)
    got = figures.run_fig_lm(str(tmp_path / "port.csv"), bench_json=str(tmp_path / "port.json"), device="cpu",
                             params0=params0, **kw)
    assert got["name"] == want["name"] and _derived_keys(got) == _derived_keys(want)
    _assert_csv(tmp_path / "port.csv", tmp_path / "ref.csv", text_cols={0, 1}, decimals={2: 2, 3: 3})
    a, b = (json.loads((tmp_path / f).read_text())["lm"] for f in ("port.json", "ref.json"))
    assert set(a) == set(b) and {k: a[k] for k in ("cells", "replicas", "iters", "smoke")} == \
        {k: b[k] for k in ("cells", "replicas", "iters", "smoke")}
