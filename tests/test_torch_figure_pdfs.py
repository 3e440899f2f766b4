"""The figure scripts' PDFs (``bipk_tpu_torch/scripts/figures.py``,
``publication_figures.py``): every PDF that the JAX ``scripts/figures.py``
and ``scripts/publication_figures.py`` write from the same ``.mat`` files
(``tests/_figure_cases.py``) the port's write too, non-empty, under the
same names."""

import sys
from pathlib import Path

import pytest
import scipy.io

import _figure_cases as cases
from bipk_tpu_torch.scripts import figures, publication_figures


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return cases.results(tmp_path_factory)


def _pdfs(directory):
    return {p.name: p.stat().st_size for p in Path(directory).glob("*.pdf")}


def test_every_pdf_jax_renders_the_port_renders(results, tmp_path, monkeypatch):
    jfig, jpub = cases.jax_figures()
    tmp, _ = results
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jdir.mkdir()
    for name in cases.RUNS:
        jfig.RENDERERS[name](scipy.io.loadmat(tmp / "jax_plots" / f"{name}.mat"), str(jdir))
        figures.main([str(tmp / "plots" / f"{name}_torch.mat"), "--outdir", str(tdir), "--cpu"])
    monkeypatch.setattr(sys, "argv", ["publication_figures.py", "--plots-dir",
                                      str(tmp / "jax_plots"), "--out",
                                      str(jdir / "Publication_Figure.pdf")])
    jpub.main()
    publication_figures.main(["--plots-dir", str(tmp / "plots"), "--out",
                              str(tdir / "Publication_Figure.pdf"), "--cpu"])
    want, got = _pdfs(jdir), _pdfs(tdir)
    assert len(want) == 12 and set(got) == set(want), (sorted(got), sorted(want))
    assert all(size > 0 for size in got.values())
