"""The figure scripts' numbers (``bipk_tpu_torch/scripts/figures.py``,
``publication_figures.py``) against the JAX ``scripts/figures.py`` and
``scripts/publication_figures.py`` (imported by path), on the same ``.mat``
files (``tests/_figure_cases.py``): the running-mean posteriors over the
Gibbs iterations, the final offline and the online posteriors, and the
predictive means and standard deviations on the stored grids, float64 to
rtol 1e-10. ``tests/test_torch_figure_pdfs.py`` renders the PDFs.
"""

import os

import numpy as np
import pytest
import torch

import _figure_cases as cases
from bipk_tpu_torch.scripts import figures, publication_figures

RTOL = 1e-10
CPU = torch.device("cpu")
SUFFIXES = {"SingleMassOscillator": [""], "Vehicle": ["_f", "_r"], "EMPS": [""]}


@pytest.fixture(scope="module")
def jfigures():
    return cases.jax_figures()


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return cases.results(tmp_path_factory)


def _close(got, want):
    """Equal to rtol 1e-10 where finite, and infinite where the JAX value is
    (a standard deviation at ``df <= 2``)."""
    got, want = np.asarray(got), np.asarray(want)
    finite = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), finite)
    np.testing.assert_array_equal(got[~finite], want[~finite])
    scale = max([1.0, *np.abs(want[finite]).ravel()])
    np.testing.assert_allclose(got[finite], want[finite], rtol=RTOL, atol=RTOL * scale)


@pytest.mark.parametrize("name", list(cases.RUNS))
def test_posteriors_and_predictives_match_jax(jfigures, results, name):
    jfig, jpub = jfigures
    data = results[1][name]
    for sfx in SUFFIXES[name]:
        prior = [data[f"prior_T{i}{sfx}"] for i in range(4)]
        offline = [data[f"offline_T{i}{sfx}"] for i in range(4)]
        nats = figures.running_mean_posteriors(prior, *offline)
        jnats = jfig.running_mean_posteriors(prior, *offline)
        for got, want in zip(nats, jnats):
            _close(got, want)
        mean_it, var_it = figures.predictive_series_on_grid(nats, data["basis_plot"], CPU)
        jmean_it, jvar_it = jfig.predictive_series_on_grid(jnats, data["basis_plot"])
        assert mean_it.shape == (np.size(offline[3]), data["basis_plot"].shape[0])
        _close(mean_it, jmean_it)
        _close(var_it, jvar_it)
        keys = [[f"prior_T{i}{sfx}" for i in range(4)], [f"offline_T{i}{sfx}" for i in range(4)]]
        for got, want in (
            (figures.final_offline_posterior(data, *keys),
             jfig._final_offline_posterior(data, *keys)),
            (publication_figures.online_posterior(
                data, keys[0], [f"online_T{i}{sfx}" for i in range(4)]),
             jpub._online_posterior(data, keys[0], [f"online_T{i}{sfx}" for i in range(4)])),
        ):
            for a, b in zip(got, want):
                _close(a, b)
            mean, std = figures.predictive_on_grid(got, data["basis_plot"], CPU)
            jmean, jstd = jfig.predictive_on_grid(want, data["basis_plot"])
            _close(mean, jmean)
            _close(std, jstd)


def test_figure_scripts_run_on_the_card_unless_asked(results, monkeypatch, tmp_path):
    tmp, _ = results
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        figures.main([str(tmp / "plots" / "Vehicle_torch.mat"), "--outdir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA"):
        publication_figures.main(["--plots-dir", str(tmp / "plots"),
                                  "--out", str(tmp_path / "P.pdf")])
    assert not os.listdir(tmp_path)
    assert figures.result_name("plots/Vehicle_torch.mat") == "Vehicle"
