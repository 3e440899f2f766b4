"""The command's refusals: no result without a card, and none where JAX
or the JAX package is loaded once the window has closed (top-level names
compared whole), whatever loaded it: the check and the metric readers run
after the window too."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import _tiny, harness

ROOT = Path(__file__).resolve().parent.parent


def _run(cwd):
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "vehicle-apf-1m",
                          "--seed", "2200000011", "--seconds", "1", "--trace", "0"],
                         cwd=cwd, capture_output=True, text=True, timeout=300)
    return out.returncode, out.stdout


def _has_result(stdout):
    for line in stdout.splitlines():
        try:
            if isinstance(json.loads(line), dict):
                return True
        except ValueError:
            pass
    return False


def test_fails_without_a_card():
    import torch

    if torch.cuda.is_available():
        return  # the refusal is for a machine without a card
    rc, stdout = _run(ROOT)
    assert rc != 0 and not _has_result(stdout)


def test_fails_with_the_benchmark_alone(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    rc, stdout = _run(tmp_path)
    assert rc != 0 and not _has_result(stdout)


def test_forbidden_modules(monkeypatch):
    monkeypatch.setitem(sys.modules, "bipk_tpu_torch_probe", object())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    monkeypatch.setitem(sys.modules, "bipk_tpu.ops", object())
    assert harness.forbidden_modules() == ["bipk_tpu", "jax"]


def test_refused_when_a_reader_loads_jax(tmp_path):
    """A metric reader that loads a module named ``jax`` (a stub) after the
    window: the run gives no result."""
    root = _tiny.tiny_root(tmp_path)
    (root / "portbench" / "metrics" / "setup_s.py").write_text(
        "import sys\nimport types\n\n\ndef read(run):\n"
        "    sys.modules['jax'] = types.ModuleType('jax')\n    return run.setup_s\n")
    saved = sys.modules.pop("jax", None)
    try:
        assert harness.forbidden_modules() == []
        with pytest.raises(harness.Refused, match="jax"):
            _tiny.run(root, "vehicle-apf-1m")
    finally:
        sys.modules.pop("jax", None)
        if saved is not None:
            sys.modules["jax"] = saved


def test_judge():
    ok, checks, readings = harness.judge({"a": 1.0, "b": 0.0, "c": 5.0}, {"a": 2.0, "b": 0.0})
    assert ok and checks["a"] == {"value": 1.0, "limit": 2.0} and readings == {"c": 5.0}
    assert not harness.judge({"a": 3.0}, {"a": 2.0})[0]
    assert not harness.judge({"a": 1.0}, {"a": 2.0, "b": 1.0})[0]
    assert not harness.judge({"a": float("nan")}, {"a": 2.0})[0]
    assert not harness.judge({"a": 1.0}, {"a": None})[0]
    assert not harness.judge({"a": 1.0, "c": float("inf")}, {"a": 2.0})[0]
