"""The result files of the figure scripts' CPU tests
(``tests/test_torch_figures.py``, ``test_torch_figure_pdfs.py``): the
oscillator's, the vehicle's and EMPS's ``.mat`` files written by the port's
entry scripts at tiny sizes on the CPU, and the JAX ``scripts/figures.py``
and ``scripts/publication_figures.py`` imported by path."""

import importlib.util
import shutil
import sys
from pathlib import Path

import scipy.io

from bipk_tpu_torch.scripts import emps
from bipk_tpu_torch.scripts import single_mass_oscillator as smo
from bipk_tpu_torch.scripts import vehicle

REPO = Path(__file__).resolve().parent.parent
RUNS = {  # experiment -> (script, flags)
    "SingleMassOscillator": (smo, ["--particles", "8", "--gibbs-iters", "4", "--t-end", "0.3",
                                   "--plot-grid", "12"]),
    "Vehicle": (vehicle, ["--particles", "8", "--gibbs-iters", "4", "--t-end", "0.3"]),
    "EMPS": (emps, ["--particles", "16", "--gibbs-iters", "4", "--max-steps", "40",
                    "--skip-baseline"]),
}


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", REPO / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def jax_figures():
    """The JAX ``figures`` and ``publication_figures`` modules (the second
    imports the first by its name, from the scripts' directory)."""
    sys.path.insert(0, str(REPO / "scripts"))
    try:
        return _jax_script("figures"), _jax_script("publication_figures")
    finally:
        sys.path.remove(str(REPO / "scripts"))


def results(tmp_path_factory):
    """The port's result files in ``plots/`` (``<Name>_torch.mat``) and the
    same files under the JAX scripts' names in ``jax_plots/``."""
    tmp = tmp_path_factory.mktemp("figures")
    (tmp / "jax_plots").mkdir()
    data = {}
    for name, (script, flags) in RUNS.items():
        out = tmp / "plots" / f"{name}_torch.mat"
        script.run(script.parse_args(["--cpu", *flags, "--data-dir", str(tmp), "--out", str(out)]
                                     if script is emps else ["--cpu", *flags, "--out", str(out)]))
        shutil.copy(out, tmp / "jax_plots" / f"{name}.mat")
        data[name] = scipy.io.loadmat(out)
    return tmp, data
