"""Periodic checkpoint and resume for long Gibbs runs (port of
``bipk_tpu/utils/checkpoint.py``).

A checkpoint holds ``(iteration, rng state, payload)``: the generator
state is ``torch.Generator.get_state()`` (a CPU byte tensor, for a CUDA
generator too), or a list of them, one per chain; the payload is a tree
of tensors (tuples, lists, dicts and NamedTuples) stored on the host as
numpy arrays, so it loads on any device. The file is written atomically:
a ``.tmp`` file first, then ``os.replace``.
"""

from __future__ import annotations

import os
import pickle
from typing import Any

import numpy as np
import torch

from bipk_tpu_torch.utils.matio import to_host


def _host(tree):
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    return to_host(tree)


def save(path: str, step: int, rng_state, payload: Any) -> None:
    """Atomically write a checkpoint: ``rng_state`` a generator's
    ``get_state()`` or a list of them, ``payload`` a tree of tensors."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    state = {"step": int(step), "rng_state": _host(rng_state), "payload": _host(payload)}
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        pickle.dump(state, fh)
    os.replace(tmp, path)


def load(path: str):
    """Load a checkpoint that :func:`save` wrote; returns ``(step,
    rng_state, payload)`` or None if there is no file. ``rng_state`` is a
    CPU byte tensor (or a list of them) for ``Generator.set_state``; the
    payload's leaves are numpy arrays on the host, which the caller moves
    onto its device."""
    if not os.path.exists(path):
        return None
    with open(path, "rb") as fh:
        state = pickle.load(fh)
    rng = state["rng_state"]
    rng = (torch.from_numpy(np.array(rng)) if isinstance(rng, np.ndarray)
           else [torch.from_numpy(np.array(r)) for r in rng])
    return state["step"], rng, state["payload"]


class PeriodicCheckpointer:
    """Callback for host-loop samplers: saves every ``every`` iterations.

    The current generator state must be passed on every call: a state
    taken once at construction would make a resumed run replay the random
    stream from the start of the chain instead of continuing it. Either
    argument may be a function of no arguments instead, called only on an
    iteration that saves, so that a loop does not build what it does not
    write. With ``write=False`` (the ranks of a mesh but rank 0) the
    functions still run on those iterations, since they may gather over
    the mesh, and nothing is written."""

    def __init__(self, path: str, every: int = 50, write: bool = True):
        if every <= 0:
            raise ValueError(f"checkpoint_every must be positive, got {every}")
        self.path = path
        self.every = every
        self.write = write

    def __call__(self, step: int, rng_state, payload: Any) -> None:
        if step % self.every == 0:
            rng_state = rng_state() if callable(rng_state) else rng_state
            payload = payload() if callable(payload) else payload
            if self.write:
                save(self.path, step, rng_state, payload)
