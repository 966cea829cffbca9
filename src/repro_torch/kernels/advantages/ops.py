"""GAE and n-step returns on top of the discounted-return kernel (the port
of src/repro/kernels/advantages/ops.py). The elementwise prologues are
plain PyTorch; the serial recursion runs in the kernel. The reference pads
B to 128; the CUDA kernel masks b < B instead, so nothing is padded or
copied."""
import torch

from repro_torch.kernels.advantages.kernel import DiscountedReturn


def discounted_return(base, coef, init):
    """out_t = base_t + coef_t * out_{t+1}, out_T = init; time-major
    (T, B), differentiable in all three inputs."""
    f32 = torch.float32
    return DiscountedReturn.apply(base.to(f32), coef.to(f32), init.to(f32))


def gae(rewards, values, dones, bootstrap, gamma=0.99, lam=0.95):
    """Time-major (T, B). Returns (advantages, returns)."""
    values_tp1 = torch.cat([values[1:], bootstrap[None]], dim=0)
    nonterm = 1.0 - dones.to(torch.float32)
    deltas = rewards + gamma * nonterm * values_tp1 - values
    adv = discounted_return(deltas, gamma * lam * nonterm,
                            torch.zeros_like(bootstrap))
    return adv, adv + values


def nstep_return(rewards, dones, bootstrap, gamma=0.99):
    discounts = gamma * (1.0 - dones.to(torch.float32))
    return discounted_return(rewards, discounts, bootstrap)
