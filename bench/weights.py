"""Weights made by the benchmark from `--seed`, on the device, in a few
large calls, and handed to both the program and the reference.

The keys and shapes are the program's parameter names (its flat,
slash-separated layout); the values follow one rule of the benchmark's
own: norm scales 1, biases 0, every matrix N(0, 1) over the square root
of its fan-in (the dims it contracts), the policy head 100 times smaller
so that a fresh policy is near uniform. One `torch.randn` fills each
group of consecutive leaves of at most `GROUP` elements, and the leaves
are views of it.
"""
from __future__ import annotations

import math

import torch

GROUP = 1 << 30


def fan_in(key, shape):
    """The dims a matrix leaf contracts in the forward, by its name."""
    leaf = key.rsplit("/", 1)[-1]
    if len(shape) == 3:
        if "/mixer/" in key and leaf == "wo":       # (H, D, d)
            return shape[0] * shape[1]
        if "/mixer/" in key:                        # (d, H, D)
            return shape[0]
        return shape[1]                             # experts (E, in, out)
    return shape[0]


def init_scale(key, shape):
    """(value, constant): a constant leaf's value, or a matrix's scale."""
    leaf = key.rsplit("/", 1)[-1]
    if leaf == "scale":
        return 1.0, True
    if leaf in ("b", "bias"):
        return 0.0, True
    if key.endswith("embed/tok") or key.endswith("feat/w"):
        return 1.0, False
    s = fan_in(key, shape) ** -0.5
    return (0.01 * s if key.endswith("pi/w") else s), False


def draw(shapes, seed, device, dtype=torch.float32):
    """{key: tensor} for `shapes` ({key: shape}, in order) from `seed`."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    out, group, size = {}, [], 0
    keys = list(shapes)

    def flush():
        n = sum(math.prod(shapes[k]) for k in group)
        flat = torch.randn(n, generator=gen, device=device, dtype=dtype)
        off = 0
        for k in group:
            shape = shapes[k]
            m = math.prod(shape)
            v = flat[off:off + m].view(shape)
            off += m
            value, const = init_scale(k, shape)
            if const:
                v.fill_(value)
            elif value != 1.0:
                v.mul_(value)
            out[k] = v

    for k in keys:
        m = math.prod(shapes[k])
        if group and size + m > GROUP:
            flush()
            group, size = [], 0
        group.append(k)
        size += m
    if group:
        flush()
    return out


def program_shapes(module):
    """{key: shape} of a module's parameter templates, in the program's
    flat layout (dots become slashes)."""
    return {name.replace(".", "/"): tuple(p.shape)
            for name, p in module.named_parameters()}
