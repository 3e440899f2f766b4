"""Build the port's CUDA kernels into one shared library.

One ``nvcc -c`` per ``bipk_tpu_torch/csrc/*.cu`` (with the headers beside
them, ``*.cuh``), all started together, compiles for ``sm_90a``; one more
``nvcc`` links the objects into one ``.so`` with a plain C interface,
loaded with ``ctypes``. The sources include no PyTorch
header: a file that does takes minutes to compile where this takes
seconds, and PyTorch's extension loader also needs ``ninja``. The
library's file name carries a hash of the sources, headers and flags, so
a stale build is never loaded. The build runs at first use, inside the
checkout (``bipk_tpu_torch/_build/``, ignored by git); a failed build
raises with nvcc's output.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
GENCODE = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*GENCODE, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def sources() -> list[Path]:
    """The translation units nvcc compiles."""
    return sorted(CSRC_DIR.glob("*.cu"))


def headers() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME/bin")


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources() + headers():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libbipk_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels if needed; return the library's path.

    The compiler's register and spill report (``-Xptxas -v``) is kept
    beside the library as ``<name>.ptxas.txt``."""
    out = library_path()
    if out.exists():
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / f"{src.stem}.o" for src in sources()]
        cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                for src, obj in zip(sources(), objs)]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for cmd in cmds]
        outputs = [proc.communicate() for proc in procs]  # every compile ends here
        lib = Path(tmp) / "lib.so"
        link = [nvcc, *GENCODE, "-shared", "-o", str(lib), *map(str, objs)]
        for cmd, proc, (stdout, stderr) in zip(cmds, procs, outputs):
            _raise_on_failure(cmd, proc.returncode, stdout, stderr)
        proc = subprocess.run(link, capture_output=True, text=True)
        _raise_on_failure(link, proc.returncode, proc.stdout, proc.stderr)
        out.with_suffix(".ptxas.txt").write_text("".join(o + e for o, e in outputs))
        os.replace(lib, out)
    return out


def _raise_on_failure(cmd, returncode, stdout, stderr):
    if returncode != 0:
        raise RuntimeError(f"nvcc failed (exit {returncode}): {' '.join(cmd)}\n"
                           f"{stdout}\n{stderr}")
