"""Policy/value networks: MLP actor-critic + transformer-trunk adapter.

Both policies are `nn.Module` templates whose weights arrive as a flat
dict of tensors named by the JAX key path (`init` makes one; checkpoint/
convert.py carries the reference's across); `apply` runs the module on
them through torch.func.functional_call.

Sampling takes its noise as a tensor instead of a PRNG key: Gumbel noise
for categorical heads (action = argmax(logits + gumbel), the draw
`jax.random.categorical` makes) and standard normal noise for the
tanh-Gaussian head. `request_noise` derives a request's noise from
(seed, request id) alone, so a served response depends only on (engine
seed, request id, params), as `fold_in(base_key, id)` gives the
reference.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from repro_torch.kernels.common import resolve_device
from repro_torch.models.layers import (Params, add_param, apply_norm,
                                       apply_params, const, dense,
                                       embed_tokens, init_params, zeros)

_M64 = np.uint64(0xFFFFFFFFFFFFFFFF)


def splitmix64(x):
    """SplitMix64 finalizer over a uint64 array (wrapping arithmetic)."""
    x = x + np.uint64(0x9E3779B97F4A7C15)
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


def stream_seed(seed: int, *ids: int) -> int:
    """A 63-bit generator seed that is a pure function of (seed, *ids)."""
    with np.errstate(over="ignore"):
        x = splitmix64(np.array([int(seed) & int(_M64)], np.uint64))
        for i in ids:
            x = splitmix64(x ^ np.uint64(int(i) & int(_M64)))
    return int(x[0]) >> 1


def request_uniforms(seed: int, ids, n: int) -> np.ndarray:
    """(len(ids), n) float64 uniforms in (0, 1), each a pure function of
    (seed, request id, column): a counter-based hash, vectorized."""
    with np.errstate(over="ignore"):
        key = splitmix64(np.array([int(seed) & int(_M64)], np.uint64))
        ids = np.asarray(ids, np.int64).astype(np.uint64)[:, None]
        cols = np.arange(n, dtype=np.uint64)[None, :]
        bits = splitmix64(splitmix64(key ^ ids) ^ cols)
    return ((bits >> np.uint64(11)).astype(np.float64) + 0.5) * 2.0 ** -53


class _ActorCritic(nn.Module):
    """Shared heads: categorical logits or tanh-Gaussian (state-independent
    log-std) squashed into `act_mid ± act_scale`."""

    discrete: bool
    n_actions: int
    act_dim: int
    act_mid: float
    act_scale: float
    device: torch.device

    def init(self, generator) -> dict:
        """Fresh params on the policy's device from a CPU torch.Generator."""
        return init_params(self, generator, self.device)

    def apply(self, params, obs):
        """-> (pi_out, value). pi_out: logits (discrete) or mean."""
        return apply_params(self, params, obs)

    @property
    def noise_dim(self) -> int:
        return self.n_actions if self.discrete else self.act_dim

    def request_noise(self, seed: int, ids) -> np.ndarray:
        """Per-request sampling noise, (len(ids), noise_dim) float32:
        Gumbel for a categorical head, standard normal (Box–Muller) for
        the Gaussian head."""
        w = self.noise_dim
        if self.discrete:
            u = request_uniforms(seed, ids, w)
            return (-np.log(-np.log(u))).astype(np.float32)
        u = request_uniforms(seed, ids, 2 * w)
        z = np.sqrt(-2.0 * np.log(u[:, :w])) * np.cos(2 * np.pi * u[:, w:])
        return z.astype(np.float32)

    def sample_noise(self, generator, n) -> torch.Tensor:
        """(n, noise_dim) f32 sampling noise drawn from `generator` on its
        device: Gumbel for a categorical head, standard normal for the
        Gaussian head (the rollout's per-step draw)."""
        shape, dev = (n, self.noise_dim), generator.device
        if self.discrete:
            u = torch.rand(shape, generator=generator, device=dev)
            tiny = torch.finfo(torch.float32).tiny
            return -torch.log(-torch.log(u.clamp_min(tiny)))
        return torch.randn(shape, generator=generator, device=dev)

    def _dist_sample(self, params, pi, noise):
        """Draw (action, log_prob) from the head output `pi` with `noise`
        (shaped like `pi`)."""
        if self.discrete:
            a = torch.argmax(pi + noise, dim=-1)
            logp = torch.log_softmax(pi, -1).gather(-1, a[..., None])[..., 0]
            return a.to(torch.int32), logp
        std = torch.exp(params["log_std"])
        a = pi + std * noise
        logp = (-0.5 * ((a - pi) / std) ** 2
                - torch.log(std) - 0.5 * math.log(2 * math.pi)).sum(-1)
        return torch.tanh(a) * self.act_scale + self.act_mid, logp

    def sample(self, params, obs, noise):
        """-> (action, log_prob)."""
        pi, _ = self.apply(params, obs)
        return self._dist_sample(params, pi, noise)

    def sample_value(self, params, obs, noise):
        """-> (action, log_prob, value) from ONE forward pass."""
        pi, v = self.apply(params, obs)
        a, logp = self._dist_sample(params, pi, noise)
        return a, logp, v

    def log_prob(self, params, obs, action):
        pi, v = self.apply(params, obs)
        if self.discrete:
            lsm = torch.log_softmax(pi, -1)
            lp = lsm.gather(-1, action[..., None].long())[..., 0]
            ent = -(torch.softmax(pi, -1) * lsm).sum(-1)
            return lp, v, ent
        # invert the tanh squashing into the action box
        raw = torch.atanh(torch.clamp((action - self.act_mid)
                                      / self.act_scale, -0.999, 0.999))
        std = torch.exp(params["log_std"])
        lp = (-0.5 * ((raw - pi) / std) ** 2
              - torch.log(std) - 0.5 * math.log(2 * math.pi)).sum(-1)
        ent = (0.5 + 0.5 * math.log(2 * math.pi)
               + torch.log(std)).sum() * torch.ones_like(v)
        return lp, v, ent


class MLPPolicy(_ActorCritic):
    """Actor-critic MLP (tanh hidden layers); construct with `for_spec`
    so the head width and action bounds come from the env's EnvSpec."""

    def __init__(self, obs_dim, n_actions=0, act_dim=1, hidden=(64, 64),
                 act_mid=0.0, act_scale=1.0, device="cuda"):
        super().__init__()
        self.device = resolve_device(device)
        self.obs_dim = obs_dim
        self.n_actions = n_actions
        self.act_dim = act_dim
        self.hidden = tuple(hidden)
        self.discrete = n_actions > 0
        self.act_mid = act_mid
        self.act_scale = act_scale
        sizes = (obs_dim,) + self.hidden
        self.layers = nn.ModuleList(
            Params(w=((sizes[i], sizes[i + 1]), dense()),
                   b=((sizes[i + 1],), zeros))
            for i in range(len(sizes) - 1))
        out = n_actions if self.discrete else act_dim
        self.pi = Params(w=((sizes[-1], out), dense(0.01)), b=((out,), zeros))
        self.v = Params(w=((sizes[-1], 1), dense(1.0)), b=((1,), zeros))
        if not self.discrete:
            add_param(self, "log_std", (act_dim,), const(-0.5))

    @classmethod
    def for_spec(cls, spec, hidden=(64, 64), device="cuda"):
        a = spec.action
        if a.discrete:
            return cls(spec.obs_dim, a.n, hidden=hidden, device=device)
        return cls(spec.obs_dim, 0, a.size, hidden=hidden,
                   act_mid=a.midpoint, act_scale=a.half_range, device=device)

    def trunk(self, obs):
        h = obs
        for lay in self.layers:
            h = torch.tanh(h @ lay.w + lay.b)
        return h

    def forward(self, obs):
        h = self.trunk(obs)
        pi = h @ self.pi.w + self.pi.b
        v = (h @ self.v.w + self.v.b)[..., 0]
        return pi, v


class TrunkPolicy(_ActorCritic):
    """Any registry architecture as a policy trunk: observation ->
    transformer -> policy/value heads, with attention routed through
    `repro_torch.core.attention` (the flash-attention dispatcher) when
    `use_kernels` is on.

    Two observation modes, chosen by `for_spec` off the EnvSpec:
      * token mode (integer obs, `obs_dim=None`): the (..., ctx) int
        history embeds through the model's token table;
      * feature mode (float obs, `obs_dim=F`): each scalar feature
        becomes one sequence position via a learned per-feature affine
        lift `obs[..., i] * w[i] + b[i]` into d_model.
    The trunk runs in float32."""

    def __init__(self, arch="paper-drl-trunk", n_actions=4, ctx=8,
                 reduced=True, obs_dim=None, act_dim=1, act_mid=0.0,
                 act_scale=1.0, use_kernels=False, device="cuda"):
        super().__init__()
        from repro_torch.models.model import ModelOpts, build_model
        self.device = resolve_device(device)
        self.lm = build_model(arch, ModelOpts(dtype="float32", remat=False,
                                              use_kernels=use_kernels),
                              reduced=reduced)
        self.n_actions = n_actions
        self.discrete = n_actions > 0
        self.features = obs_dim          # None => token-obs mode
        self.ctx = ctx if obs_dim is None else obs_dim
        self.obs_dim = self.ctx
        self.act_dim = act_dim
        self.act_mid = act_mid
        self.act_scale = act_scale
        d = self.lm.cfg.d_model
        out = n_actions if self.discrete else act_dim
        self.pi = Params(w=((d, out), dense(0.01)), b=((out,), zeros))
        self.v = Params(w=((d, 1), dense()), b=((1,), zeros))
        if self.features is not None:
            self.feat = Params(w=((self.features, d), dense()),
                               b=((self.features, d), zeros))
        if not self.discrete:
            add_param(self, "log_std", (act_dim,), const(-0.5))

    @classmethod
    def for_spec(cls, spec, arch="paper-drl-trunk", reduced=True,
                 use_kernels=True, device="cuda"):
        """Integer obs run in token mode, float obs in feature mode; head
        width and continuous action bounds read off the spec."""
        a, o = spec.action, spec.observation
        kw = dict(arch=arch, reduced=reduced, use_kernels=use_kernels,
                  device=device)
        if o.dtype.is_floating_point:
            kw["obs_dim"] = spec.obs_dim
        else:
            kw["ctx"] = spec.obs_dim
        if a.discrete:
            return cls(n_actions=a.n, **kw)
        return cls(n_actions=0, act_dim=a.size, act_mid=a.midpoint,
                   act_scale=a.half_range, **kw)

    def forward(self, obs):
        """obs: (..., ctx) int token history or (..., F) float features
        -> (pi_out, value), taken at the last position after the final
        norm."""
        squeeze = obs.ndim == 1
        if squeeze:
            obs = obs[None]
        cfg = self.lm.cfg
        if self.features is None:
            tok = obs.long() % cfg.vocab
            x = embed_tokens(self.lm.embed, tok, cfg, torch.float32)
        else:
            x = obs.float()[..., None] * self.feat.w + self.feat.b
        x = self.lm.run_blocks(x, 0)[0]
        h = apply_norm(self.lm.final_norm, x)[:, -1]
        pi = h @ self.pi.w + self.pi.b
        v = (h @ self.v.w + self.v.b)[..., 0]
        if squeeze:
            pi, v = pi[0], v[0]
        return pi, v

    # -- layer-wise ZeRO-3 partition hooks -----------------------------
    # The params already hold one entry per block (`lm/stack/<r>/...`),
    # so an entry is one block's keys. The reference's lazy list form of
    # the stack and its `_sequence_barrier` only keep XLA from hoisting
    # every block's gather ahead of the loop; eager PyTorch runs in
    # program order, so they have no counterpart here.
    def partition_list(self, params):
        """A params dict (or any dict keyed like it) split into per-block
        ZeRO-3 entries: one per super-block of the stack, then the
        remainder (embed, final_norm, heads, feat, log_std). None when
        the trunk has no stack (repeats == 0)."""
        if not self.lm.repeats:
            return None
        heads = [f"lm/stack/{r}/" for r in range(self.lm.repeats)]
        blocks = [{k: v for k, v in params.items() if k.startswith(h)}
                  for h in heads]
        rest = {k: v for k, v in params.items()
                if not k.startswith("lm/stack/")}
        return blocks + [rest]

    def merge_partition_list(self, entries):
        """Inverse of `partition_list`: one dict again, blocks first. The
        reference's `materialize` switch between its lazy list and its
        stacked layout has no counterpart: the per-block keys are both."""
        out = {}
        for e in entries:
            out.update(e)
        return out


def make_policy(spec, policy="mlp", hidden=(64, 64), device="cuda",
                **trunk_kwargs):
    """`policy="mlp"` (the house actor-critic MLP, `hidden` widths) or
    `policy="trunk"` (TrunkPolicy.for_spec; `trunk_kwargs` forwards
    arch/reduced/use_kernels)."""
    if policy == "trunk":
        return TrunkPolicy.for_spec(spec, device=device, **trunk_kwargs)
    if policy != "mlp":
        raise ValueError(f"unknown policy {policy!r}: expected 'mlp' "
                         f"or 'trunk'")
    return MLPPolicy.for_spec(spec, hidden, device=device)
