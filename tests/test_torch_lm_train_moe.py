"""The port's LM training on the CPU against the JAX package for the
reduced() MoE archs: deepseek-moe-16b (a dense layer 0 in the prefix,
then one MoE super-block), jamba-v0.1-52b (seven Mamba layers and one
attention layer, MoE on every other) and llama4-maverick-400b-a17b (a MoE
layer with a shared expert, then a dense one). A file of its own, so
that `--dist loadfile` runs it beside tests/test_torch_lm_train.py (its
JAX gradients are the slowest). tests/lm_train_parity.py says how and
within what:

  * loss (the CE plus the routers' aux loss) and every gradient leaf in
    f32, against `jax.value_and_grad(model.loss)`;
  * one optimizer step of the launcher's optimizer on deepseek-moe-16b
    (expert leaves (E, d, f) included);
  * remat on deepseek-moe-16b: its prefix block keeps its activations,
    its stack super-block is recomputed;
  * bf16 compute on f32 master weights on deepseek-moe-16b against the
    reference's bf16 model: loss within 2^-10 relative (measured 5.7e-6),
    every gradient leaf within 2^-5 x max|g_ref| (measured 1.7e-2).
"""
import pytest

from lm_train_parity import (check_bf16, check_loss_and_grad,  # noqa: F401
                             check_optimizer_step, check_remat,
                             deterministic)

ARCHS = ["deepseek-moe-16b", "jamba-v0.1-52b", "llama4-maverick-400b-a17b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grad_match_jax(arch):
    check_loss_and_grad(arch)


def test_optimizer_step_matches_jax():
    check_optimizer_step("deepseek-moe-16b")


def test_remat_keeps_the_prefix_and_matches_jax():
    check_remat("deepseek-moe-16b")


def test_bf16_trains_on_f32_master_weights():
    check_bf16("deepseek-moe-16b")
