"""A configuration of a new model, its reference model, a traffic mix with
a new driver, a cell and a per-layer metric added as new files and entries
alone, in a temporary copy, and run with no file of the benchmark changed."""

import json

from portbench import _tiny

# the reference's model of the new configuration: the oscillator observed
# through its velocity instead of its position
REFERENCE_MODEL = '''
from portbench.reference.models.oscillator import Oscillator


class Velocity(Oscillator):
    def output(self, x, u, g):
        return x[1:]


def build(cfg):
    return Velocity(cfg)
'''

# the measured package's program of the same model, and its record
BUILDER = '''
import dataclasses
from pathlib import Path
from types import SimpleNamespace

import torch

from portbench.harness import load_module

_base = load_module(Path(__file__).with_name("oscillator.py"), "oscillator_v_base")


def program(cfg, device):
    prog = _base.program(cfg, device)
    ssm = dataclasses.replace(prog.ssm, output=lambda x, u, *iv: x[1:2])
    return SimpleNamespace(**{**vars(prog), "ssm": ssm})


def record(cfg, seed, device):
    rec = _base.record(cfg, seed, device)
    gen = torch.Generator().manual_seed(seed % (1 << 62) + 1)
    noise = torch.randn((rec.X.shape[0], 1), generator=gen) * cfg["output_noise"][0][0] ** 0.5
    return SimpleNamespace(X=rec.X, Y=rec.X[:, 1:] + noise.to(rec.X), U=rec.U, G=rec.G)
'''

# a driver under a new name: the APF driver's loop
DRIVER = '''
from portbench.drivers.apf import readings, run  # noqa: F401
'''

CELL = "oscillator_v-apf-tiny"


def _add_cell(root, model):
    bench = root / "portbench"
    (bench / "reference" / "models" / "oscillator_v.py").write_text(REFERENCE_MODEL)
    (bench / "configs" / "oscillator_v.py").write_text(BUILDER)
    (bench / "drivers" / "apf_again.py").write_text(DRIVER)
    cfg = json.loads((bench / "configs" / "oscillator.json").read_text())
    cfg["model"] = model
    (bench / "configs" / "oscillator_v.json").write_text(json.dumps(cfg))
    traffic = json.loads((bench / "traffic" / "online_32k.json").read_text())
    traffic.update(algorithm="apf_again", particles=128)
    (bench / "traffic" / "online_tiny.json").write_text(json.dumps(traffic))
    limits = json.loads((bench / "limits" / "oscillator-apf-32k.json").read_text())
    limits["log_weight"] = 1e-3  # the new model's observation weighs each particle
    (bench / "limits" / f"{CELL}.json").write_text(json.dumps(limits))
    (bench / "metrics" / "probe_steps.py").write_text(
        "def read(run):\n    return len(run.host_ms) or None\n")
    man = json.loads((root / "BENCHMARK.json").read_text())
    man["configs"].append({"name": "oscillator_v", "source": man["configs"][1]["source"],
                           "file": "portbench/configs/oscillator_v.json", "reduced": [],
                           "why": "the oscillator observed through its velocity"})
    man["workloads"].append({"name": CELL, "config": "oscillator_v", "traffic": "online_tiny",
                             "chips": 1, "why": "a test"})
    for m in man["end_to_end"]:
        if m["name"] in ("apf_particle_steps_per_s.m41", "apf_step_ms_p95.m41"):
            m["workloads"].append(CELL)
    man["per_layer"].append({"name": "probe_steps.apf_m41", "unit": "steps", "better": "higher",
                             "source": "host_clock", "layer": "sweep drivers",
                             "moves": "apf_particle_steps_per_s.m41", "workloads": [CELL]})
    (root / "BENCHMARK.json").write_text(json.dumps(man))


def test_added_by_files(tmp_path):
    root = _tiny.tiny_root(tmp_path)
    _add_cell(root, "oscillator_v")
    out = _tiny.run(root, CELL, trace=0)
    assert set(out["metrics"]) == {"apf_particle_steps_per_s.m41", "setup_s"}
    assert out["attempted"] > 0
    # the reference follows the new model: its observation's log weights
    # agree with the program's to float32's rounding
    assert out["checks"]["log_weight"]["value"] < 1e-3
    out = _tiny.run(root, CELL, trace=1)
    assert out["metrics"]["probe_steps.apf_m41"]["value"] == 2


def test_the_reference_model_is_the_configurations(tmp_path):
    """The same cell judged by the oscillator's reference model, which
    observes the position, is not correct: the check reads the model the
    configuration names."""
    root = _tiny.tiny_root(tmp_path)
    _add_cell(root, "oscillator")
    out = _tiny.run(root, CELL, trace=0)
    assert not out["correct"] and out["checks"]["log_weight"]["value"] > 0.1
