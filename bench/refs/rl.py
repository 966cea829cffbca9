"""Plain PyTorch reference of the RL training cells, in float32.

Written from the published algorithms and the configuration, importing
nothing of the program:

  * CartPole-v1's Euler step (Barto, Sutton and Anderson 1983, gym's
    constants): done when |x| > 2.4, |theta| > 12 degrees or at step 200,
    reward 1 every step;
  * the policy trunk in feature mode: each of the F observation scalars
    lifted to one position, obs_i * w_i + b_i, the decoder stack of
    `refs.transformer` (no final logits), the final RMSNorm, the policy
    and value heads at the last position;
  * PPO (Schulman et al. 2017) with GAE (lambda 0.95, gamma 0.99), the
    advantages normalised per minibatch by their population std, the
    clipped ratio at 0.2, value coefficient 0.5, entropy 0.01, each
    epoch's minibatches cut from a uniform random permutation;
  * IMPALA's V-trace (Espeholt et al. 2018), rho-bar = c-bar = 1, with
    the same coefficients, one gradient step on the whole batch;
  * the gradients clipped to a global norm, then Adam (Kingma and Ba,
    bias-corrected, eps 1e-8, no weight decay).

`follow` runs the learner's first optimizer steps over the trajectories
the program collected, from the same initial weights, and records what
the check compares: each step's loss, the optimizer's first moment after
the first step and the weights after the last. The behaviour log-probabilities and
values are computed again from the reference's own weights; the program
only supplies what it was asked to produce (observations, actions,
rewards, dones).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from bench.refs.transformer import mm, rms_norm, run_blocks

GRAVITY, MASSCART, MASSPOLE, LENGTH, FORCE_MAG, TAU = (9.8, 1.0, 0.1, 0.5,
                                                      10.0, 0.02)
X_LIM, THETA_LIM, MAX_STEPS = 2.4, 12 * math.pi / 180, 200


def cartpole_step(s, t, action):
    """s: (B, 4) [x, x_dot, theta, theta_dot]; t: (B,) steps taken; action:
    (B,) in {0, 1} -> (next s, reward, done, next t)."""
    x, x_dot, th, th_dot = s.unbind(-1)
    force = torch.where(action > 0, FORCE_MAG, -FORCE_MAG)
    total = MASSCART + MASSPOLE
    pml = MASSPOLE * LENGTH
    cos, sin = torch.cos(th), torch.sin(th)
    temp = (force + pml * th_dot ** 2 * sin) / total
    th_acc = (GRAVITY * sin - cos * temp) / (
        LENGTH * (4.0 / 3.0 - MASSPOLE * cos ** 2 / total))
    x_acc = temp - pml * th_acc * cos / total
    nxt = torch.stack([x + TAU * x_dot, x_dot + TAU * x_acc,
                       th + TAU * th_dot, th_dot + TAU * th_acc], -1)
    t = t + 1
    done = ((nxt[:, 0].abs() > X_LIM) | (nxt[:, 2].abs() > THETA_LIM)
            | (t >= MAX_STEPS))
    return nxt, torch.ones_like(x), done, t


def policy(params, obs, cfg, precision="float32"):
    """obs: (N, F) float -> (logits (N, A), value (N,))."""
    x = obs[..., None] * params["feat/w"] + params["feat/b"]
    x = run_blocks(params, x, cfg, "lm/", precision)
    h = rms_norm(x[:, -1], params["lm/final_norm/scale"])
    logits = mm("nd,da->na", h, params["pi/w"], precision) + params["pi/b"]
    value = mm("nd,da->na", h, params["v/w"], precision)[:, 0] \
        + params["v/b"][0]
    return logits, value


def log_prob(logits, action):
    """(log-probability of `action`, entropy) under softmax(logits)."""
    lsm = torch.log_softmax(logits, -1)
    lp = lsm.gather(-1, action[:, None].long())[:, 0]
    return lp, -(torch.softmax(logits, -1) * lsm).sum(-1)


def reverse_scan(base, coef, init):
    """out_t = base_t + coef_t * out_{t+1}, out_T = init; (T, B)."""
    acc, outs = init, []
    for t in range(base.shape[0] - 1, -1, -1):
        acc = base[t] + coef[t] * acc
        outs.append(acc)
    return torch.stack(outs[::-1])


def gae(reward, value, done, boot, gamma, lam):
    nonterm = 1.0 - done.float()
    v_next = torch.cat([value[1:], boot[None]], 0)
    delta = reward + gamma * nonterm * v_next - value
    adv = reverse_scan(delta, gamma * lam * nonterm, torch.zeros_like(boot))
    return adv, adv + value


def vtrace(log_rhos, discounts, reward, value, boot, clip_rho, clip_c):
    rhos = torch.clamp(torch.exp(log_rhos), max=clip_rho)
    cs = torch.clamp(torch.exp(log_rhos), max=clip_c)
    v_next = torch.cat([value[1:], boot[None]], 0)
    delta = rhos * (reward + discounts * v_next - value)
    vs = value + reverse_scan(delta, discounts * cs, torch.zeros_like(boot))
    vs_next = torch.cat([vs[1:], boot[None]], 0)
    return vs, rhos * (reward + discounts * vs_next - value)


def stream_seed(seed, *ids):
    """A 63-bit generator seed that is a pure function of (seed, *ids):
    SplitMix64's finaliser folded over the ids, the rule by which the
    training loop draws every per-iteration stream."""
    m64 = np.uint64(0xFFFFFFFFFFFFFFFF)

    def mix(x):
        x = x + np.uint64(0x9E3779B97F4A7C15)
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return x ^ (x >> np.uint64(31))

    with np.errstate(over="ignore"):
        x = mix(np.array([int(seed) & int(m64)], np.uint64))
        for i in ids:
            x = mix(x ^ np.uint64(int(i) & int(m64)))
    return int(x[0]) >> 1


LEARN_STREAM = 1   # the learner's per-iteration stream id


def minibatch_perms(seed, it, n_epochs, n, device):
    """Each epoch's sample order at iteration `it`: a stable argsort of
    uniforms from the learner's stream, as the training loop draws it."""
    g = torch.Generator(device=device).manual_seed(
        stream_seed(seed, it, LEARN_STREAM))
    return torch.rand((n_epochs, n), generator=g,
                      device=device).argsort(dim=-1, stable=True)


class Adam:
    """Global-norm clipping, then bias-corrected Adam, leaf by leaf."""

    def __init__(self, params, lr, max_norm, b1=0.9, b2=0.999, eps=1e-8):
        self.lr, self.max_norm = lr, max_norm
        self.b1, self.b2, self.eps = b1, b2, eps
        self.step = 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    def apply(self, params, grads):
        norm = torch.sqrt(sum(g.square().sum() for g in grads.values()))
        scale = torch.clamp(self.max_norm / norm.clamp_min(1e-9), max=1.0)
        self.step += 1
        bc1 = 1 - self.b1 ** self.step
        bc2 = 1 - self.b2 ** self.step
        out = {}
        for k, p in params.items():
            g = grads[k] * scale
            self.m[k] = self.b1 * self.m[k] + (1 - self.b1) * g
            self.v[k] = self.b2 * self.v[k] + (1 - self.b2) * g * g
            u = (self.m[k] / bc1) / (torch.sqrt(self.v[k] / bc2) + self.eps)
            out[k] = p - self.lr * u
        return out


def _grad(loss_fn, params):
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    with torch.enable_grad():
        loss = loss_fn(leaves)
    used = [k for k in leaves]
    grads = torch.autograd.grad(loss, [leaves[k] for k in used],
                                allow_unused=True)
    return loss.detach(), {k: torch.zeros_like(leaves[k]) if g is None else g
                           for k, g in zip(used, grads)}


def _flat(a):
    return a.reshape((-1,) + a.shape[2:])


def ppo_steps(params, opt, traj, boot_obs, it, cfg, hp, seed, precision):
    """PPO's learner over one trajectory, optimizer step by optimizer step:
    yields (params, minibatch loss) after each."""
    T, B = traj["reward"].shape
    with torch.no_grad():
        logits, value = policy(params, _flat(traj["obs"]), cfg, precision)
        logp_b, _ = log_prob(logits, _flat(traj["action"]))
        _, boot = policy(params, boot_obs, cfg, precision)
        adv, ret = gae(traj["reward"], value.reshape(T, B), traj["done"],
                       boot, hp["gamma"], hp["lam"])
    batch = {"obs": _flat(traj["obs"]), "action": _flat(traj["action"]),
             "logp": logp_b, "adv": _flat(adv), "ret": _flat(ret)}

    def loss_fn(p, mb):
        lg, v = policy(p, mb["obs"], cfg, precision)
        lp, ent = log_prob(lg, mb["action"])
        ratio = torch.exp(lp - mb["logp"])
        a = mb["adv"]
        a = (a - a.mean()) / (a.std(correction=0) + 1e-8)
        clipped = torch.clamp(ratio, 1 - hp["clip_eps"], 1 + hp["clip_eps"])
        pg = -torch.mean(torch.minimum(ratio * a, clipped * a))
        vf = torch.mean(torch.square(v - mb["ret"]))
        return pg + hp["vf_coef"] * vf - hp["ent_coef"] * ent.mean()

    n = T * B
    perms = minibatch_perms(seed, it, hp["n_epochs"], n,
                            traj["reward"].device)
    mb = n // hp["n_minibatch"]
    for perm in perms:
        for i in range(hp["n_minibatch"]):
            idx = perm[i * mb:(i + 1) * mb]
            part = {k: v[idx] for k, v in batch.items()}
            loss, grads = _grad(lambda p: loss_fn(p, part), params)
            params = opt.apply(params, grads)
            yield params, loss


def impala_steps(params, opt, traj, boot_obs, it, cfg, hp, seed, precision):
    """IMPALA's one learner step over one trajectory: yields (params,
    loss)."""
    T, B = traj["reward"].shape
    obs, act = _flat(traj["obs"]), _flat(traj["action"])
    with torch.no_grad():
        logits, _ = policy(params, obs, cfg, precision)
        logp_b = log_prob(logits, act)[0].reshape(T, B)
    discounts = hp["gamma"] * (1.0 - traj["done"].float())

    def loss_fn(p):
        lg, v = policy(p, obs, cfg, precision)
        lp, ent = log_prob(lg, act)
        lp, v, ent = lp.reshape(T, B), v.reshape(T, B), ent.reshape(T, B)
        _, boot = policy(p, boot_obs, cfg, precision)
        with torch.no_grad():
            vs, pg_adv = vtrace(lp - logp_b, discounts, traj["reward"], v,
                                boot, hp["clip_rho"], hp["clip_c"])
        pg = -torch.mean(lp * pg_adv)
        vf = torch.mean(torch.square(v - vs))
        return pg + hp["vf_coef"] * vf - hp["ent_coef"] * ent.mean()

    loss, grads = _grad(loss_fn, params)
    yield opt.apply(params, grads), loss


STEPS = {"ppo": ppo_steps, "impala": impala_steps}


def follow(algo, params, trajs, cfg, hp, seed, steps, precision="float32",
           half=False):
    """The learner's first `steps` optimizer steps over the program's
    trajectories (in order, as many as those steps use), from `params`.

    trajs: [(traj, boot_obs)] of iterations 0, 1, ...; `half` keeps only
    the first half of the envs (a fault: half of the batch left out, the
    mean taken over the rest). Returns {"loss": [per step], "m": Adam's
    first moment after the first step, "params": after the last}."""
    opt = Adam(params, hp["lr"], hp["max_grad_norm"])
    losses, m1 = [], None
    for it, (traj, boot) in enumerate(trajs):
        if half:
            B = traj["reward"].shape[1] // 2
            traj = {k: v[:, :B] for k, v in traj.items()}
            boot = boot[:B]
        for params, loss in STEPS[algo](params, opt, traj, boot, it, cfg, hp,
                                        seed, precision):
            losses.append(float(loss))
            if m1 is None:
                m1 = {k: v.clone() for k, v in opt.m.items()}
            if len(losses) == steps:
                return {"loss": losses, "m": m1, "params": params}
    raise ValueError(f"the trajectories hold fewer than {steps} steps")


@torch.no_grad()
def env_gap(trajs):
    """The largest error of the env's transitions over the trajectories,
    time-major and in order: each step's successor observation, reward and
    done against `cartpole_step`, and each next step's observation against
    the successor where the episode went on. A done or a reward that
    differs reads 1."""
    gap = 0.0
    t = None
    prev = None
    for traj, _ in trajs:
        for i in range(traj["reward"].shape[0]):
            obs = traj["obs"][i]
            if t is None:
                t = torch.zeros(obs.shape[0], dtype=torch.int64,
                                device=obs.device)
            if prev is not None:
                nxt, done = prev
                go = ~done
                if go.any():
                    gap = max(gap, float((obs[go] - nxt[go]).abs().max()))
            nxt, reward, done, t = cartpole_step(obs, t, traj["action"][i])
            gap = max(gap, float((traj["next_obs"][i] - nxt).abs().max()))
            if not torch.equal(traj["done"][i], done) or not torch.equal(
                    traj["reward"][i], reward):
                gap = max(gap, 1.0)
            t = torch.where(done, 0, t)
            prev = (traj["next_obs"][i], traj["done"][i])
    return gap


def _leaf_norms(tree):
    return {k: float(v.double().norm()) for k, v in tree.items()}


def worst_leaf_gap(got, want, moving):
    """max over the `moving` leaves of |‖got‖ - ‖want‖| / max(‖want‖, the
    median leaf's ‖want‖)."""
    g, w = _leaf_norms(got), _leaf_norms(want)
    med = float(np.median([w[k] for k in moving]))
    return max(abs(g[k] - w[k]) / max(w[k], med) for k in moving)


def moving_leaves(grad_like):
    """The leaves whose reference gradient is at least a thousandth of the
    median leaf's: the others move under Adam by round-off alone."""
    n = _leaf_norms(grad_like)
    med = float(np.median([v for v in n.values() if v > 0]))
    return sorted(k for k, v in n.items() if v >= 1e-3 * med)


@torch.no_grad()
def behaviour(params, traj, cfg, precision="float32"):
    """The trunk's log-probabilities of the trajectory's actions and its
    values, flat over (T, B)."""
    logits, value = policy(params, _flat(traj["obs"]), cfg, precision)
    return log_prob(logits, _flat(traj["action"]))[0], value


def policy_gap(params, traj, logp, value, cfg):
    """The rollout's log-probabilities and values (`logp`, `value`, (T, B))
    against the float32 trunk's on the same observations and actions: the
    largest log-prob error, and the largest value error over the values'
    RMS."""
    lp, v = behaviour(params, traj, cfg)
    d_lp = float((lp - logp.reshape(-1)).abs().max())
    rms = float(v.square().mean().sqrt())
    return max(d_lp, float((v - value.reshape(-1)).abs().max())
               / max(rms, 1e-12))
