"""Weights and train states carried between the reference's pytrees and
the port's flat params.

The reference keeps a LanguageModel's repeated super-blocks stacked:
every leaf under `.../stack/t<t>/...` has a leading (repeats,) dim from a
vmapped init. The port runs the repeats as a ModuleList, so its flat
params hold one entry per block, `.../stack/<r>/t<t>/...`. Everything
else keeps its key path: a list in the tree (an MoE model's `prefix` of
dense blocks, a `tail`) becomes `prefix/<i>/...` and goes back as a
list, and an MoE FFN's expert weights (E, d, f) keep their expert dim.
A KV cache converts the same way (`stack/<r>/t<t>/k`). Params a mode
does not use (e.g. `embed` in feature mode) are carried too, so
templates and checkpoints match the reference leaf for leaf.
"""
from __future__ import annotations

import numpy as np
import torch


def flatten_tree(tree, prefix=""):
    """Nested dicts/lists/tuples of arrays -> {"a/0/b": leaf}."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(flatten_tree(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def unflatten_tree(flat):
    """Inverse of `flatten_tree`: dicts, with lists where the keys are
    0..n-1."""
    root = {}
    for key, leaf in flat.items():
        node = root
        *parents, last = key.split("/")
        for part in parents:
            node = node.setdefault(part, {})
        node[last] = leaf

    def listify(node):
        if not isinstance(node, dict):
            return node
        node = {k: listify(v) for k, v in node.items()}
        if node and sorted(node) == sorted(map(str, range(len(node)))):
            return [node[str(i)] for i in range(len(node))]
        return node

    return listify(root)


def _stack_split(parts):
    """Position just after a stacked `stack` segment (one whose next
    segment is a block name, not a block index), else None."""
    for i, part in enumerate(parts[:-1]):
        if part == "stack" and not parts[i + 1].isdigit():
            return i + 1
    return None


def params_from_jax(tree) -> dict:
    """Reference param tree (numpy leaves, as `tree_map(np.asarray, ·)`
    gives it) -> the port's flat params (CPU tensors, JAX key paths,
    stacked super-blocks split per block)."""
    out = {}
    for key, leaf in flatten_tree(tree).items():
        arr = np.asarray(leaf)
        parts = key.split("/")
        i = _stack_split(parts)
        if i is None:
            out[key] = torch.tensor(arr)
            continue
        for r in range(arr.shape[0]):
            out["/".join(parts[:i] + [str(r)] + parts[i:])] = \
                torch.tensor(arr[r])
    return out


def params_to_jax(params) -> dict:
    """Inverse of `params_from_jax`: the port's flat params -> the
    reference's nested tree of numpy arrays, super-blocks restacked."""
    flat, stacked = {}, {}
    for key, t in params.items():
        arr = t.detach().cpu().numpy()
        parts = key.split("/")
        i = next((j + 1 for j, p in enumerate(parts[:-2])
                  if p == "stack" and parts[j + 1].isdigit()
                  and not parts[j + 2].isdigit()), None)
        if i is None:
            flat[key] = arr
            continue
        jkey = "/".join(parts[:i] + parts[i + 1:])
        stacked.setdefault(jkey, {})[int(parts[i])] = arr
    for jkey, blocks in stacked.items():
        flat[jkey] = np.stack([blocks[r] for r in range(len(blocks))])
    return unflatten_tree(flat)


def _tensors(tree):
    """Nested dicts of arrays -> the same dicts of CPU tensors."""
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree))


def train_state_from_jax(state):
    """A reference `TrainState` with numpy leaves (`tree_map(np.asarray,
    ·)`) -> the port's TrainState on the CPU: params, the optimizer state
    (the adamw `step`, `m` and `v`, or any dict of such trees), the
    algorithm state in `extra` (the DQN replay: its store, `prio`, `ptr`
    and `size`, as nested dicts), the actor-param ring (`ring_from_jax`)
    and the `steps` counter, key paths as `params_from_jax` gives them."""
    from repro_torch.core.agent import TrainState

    def leaf_or_tree(v):
        if v is None:
            return None
        if isinstance(v, (dict, list, tuple)):
            return params_from_jax(v)
        return torch.tensor(np.asarray(v))

    opt_state = {k: leaf_or_tree(v) for k, v in state.opt_state.items()}
    return TrainState(params_from_jax(state.params), opt_state,
                      _tensors(state.extra), ring_from_jax(state.ring),
                      torch.tensor(np.asarray(state.steps)))


def ring_from_jax(ring) -> dict:
    """A reference actor-param ring (every leaf with a leading (ring_size,)
    dim) -> the port's: each slot converted by `params_from_jax` (which
    splits stacked super-blocks along their own leading dim), then
    restacked."""
    flat = {k: np.asarray(v) for k, v in flatten_tree(ring).items()}
    if not flat:
        return {}
    slots = [params_from_jax(unflatten_tree({k: v[r]
                                             for k, v in flat.items()}))
             for r in range(next(iter(flat.values())).shape[0])]
    return {k: torch.stack([s[k] for s in slots]) for k in slots[0]}
