"""Checkpointing in the reference's npz format: one archive entry per
leaf, keyed by its "/"-joined key path (src/repro/checkpoint/ckpt.py),
with stacked super-blocks as the reference stores them. An archive
written by either package restores into the other."""
from __future__ import annotations

import dataclasses
import os
import types

import numpy as np

from repro_torch.checkpoint.convert import (flatten_tree, params_from_jax,
                                            params_to_jax,
                                            train_state_from_jax,
                                            unflatten_tree)
from repro_torch.kernels.common import resolve_device

RING = ".ring/"  # the actor-param ring of a reference Trainer archive


def save_checkpoint(path, params, step=None):
    """Write the port's flat params with the reference's keys."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = flatten_tree(params_to_jax(params))
    if step is not None:
        flat["__step__"] = np.asarray(step)
    np.savez(path, **flat)
    return path


def _read(path):
    with np.load(path if path.endswith(".npz") else path + ".npz") as z:
        data = {k: z[k] for k in z.files}
    step = data.pop("__step__", None)
    return data, (int(step) if step is not None else None)


def _match(params, example):
    """`params` restricted to the keys of `example`, cast to each
    example leaf's dtype and device."""
    out = {}
    for key, ref in example.items():
        if key not in params:
            raise KeyError(f"checkpoint has no entry for {key!r}")
        out[key] = params[key].to(dtype=ref.dtype, device=ref.device)
    return out


def load_checkpoint(path, example):
    """Restore flat params shaped like `example` (e.g. `policy.init(g)`).
    Returns (params, step)."""
    data, step = _read(path)
    return _match(params_from_jax(unflatten_tree(data)), example), step


def load_actor_policy(path, example, delay=0):
    """The behaviour params a reference Trainer archive serves: slot
    `delay` (clamped to the ring depth) of its `.ring/<policy path>`
    arrays, as `agent.actor_policy(state, delay)` reads them."""
    data, _ = _read(path)
    ring = {k[len(RING):]: v[min(delay, v.shape[0] - 1)]
            for k, v in data.items() if k.startswith(RING)}
    if not ring:
        raise KeyError(f"{path}: no {RING!r} entries; not a Trainer "
                       f"archive")
    return _match(params_from_jax(unflatten_tree(ring)), example)


def _ring_to_jax(ring):
    """The port's actor-param ring -> the reference's: each slot through
    `params_to_jax` (restacking super-blocks), then restacked."""
    n = next(iter(ring.values())).shape[0]
    slots = [flatten_tree(params_to_jax({k: v[d] for k, v in ring.items()}))
             for d in range(n)]
    return {k: np.stack([s[k] for s in slots]) for k in slots[0]}


def save_train_state(path, state):
    """Write a TrainState in the reference Trainer's archive layout
    (`.params/`, `.opt_state/`, `.extra/`, `.ring/` and `.steps`), the
    inverse of `load_train_state`: a fit's plan-independent state, saved
    here, restores into either package. Returns the path."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arr = lambda t: t.detach().cpu().numpy()
    flat = {f".params/{k}": v
            for k, v in flatten_tree(params_to_jax(state.params)).items()}
    for name, v in (state.opt_state or {}).items():
        if isinstance(v, dict):
            flat.update({f".opt_state/{name}/{k}": a for k, a in
                         flatten_tree(params_to_jax(v)).items()})
        elif v is not None:
            flat[f".opt_state/{name}"] = arr(v)
    flat.update({f".extra/{k}": arr(v)
                 for k, v in flatten_tree(state.extra or {}).items()
                 if v is not None})
    flat.update({f"{RING}{k}": v
                 for k, v in _ring_to_jax(state.ring).items()})
    flat[".steps"] = arr(state.steps)
    np.savez(path, **flat)
    return path


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return None if tree is None else tree.to(device)


def load_train_state(path, device="cuda"):
    """A reference Trainer archive (its `.params/`, `.opt_state/`,
    `.extra/`, `.ring/` and `.steps` entries) as the port's TrainState on
    `device` (convert.train_state_from_jax): the card by default,
    RuntimeError without one."""
    device = resolve_device(device)
    data, _ = _read(path)
    if ".steps" not in data:
        raise KeyError(f"{path}: no '.steps' entry; not a Trainer archive")
    tree = unflatten_tree(data)
    fields = {f: tree.get("." + f, {}) for f in ("params", "opt_state",
                                                  "extra", "ring")}
    state = train_state_from_jax(types.SimpleNamespace(
        steps=tree[".steps"], **fields))
    return dataclasses.replace(state, **{
        f: _to(getattr(state, f), device) for f in (
            "params", "opt_state", "extra", "ring", "steps")})
