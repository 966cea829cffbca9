"""The output check's control and faults on the CPU, at sizes a test run
holds: a run is driven past the card check with the timed path broken
underneath, and `correct` has to come out false; the control (the
reference in TF32 put in the program's place) has to fail the cell's
limits. The sound run of the same small cell comes out correct.

Each cell's faults: a learner step that returns its state unchanged, half
of the batch left out (the mean taken over the rest), an answer altered
where it is produced (an env's reward, a served token). The cells take
one chip, so there is no exchange between chips to leave out.
"""
import pytest
import torch

from bench import calibrate, harness
from bench.drivers import lm_prefill, rl_train
from bench.tests.test_bench_harness import tiny_ppo_cell


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def ppo_run():
    return rl_train.run(tiny_ppo_cell(), seed=2 ** 31 + 21, seconds=0.1,
                        trace=False, device="cpu", t_start=0.0)


def test_sound_ppo_run_is_correct():
    assert ppo_run()["correct"]


def test_a_step_that_returns_its_state_unchanged_is_caught(monkeypatch):
    from repro_torch.optim.optimizers import Optimizer
    monkeypatch.setattr(Optimizer, "apply",
                        lambda self, params, state, grads: (params, state))
    out = ppo_run()
    assert not out["correct"]
    assert out["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_half_the_batch_left_out_is_caught(monkeypatch):
    from repro_torch.core.algos.ppo import PPOAgent
    whole = PPOAgent.learner_step

    def half(self, state, traj, boot_obs, generator, grad_tx=None,
             param_tx=None):
        B = traj["reward"].shape[1] // 2
        return whole(self, state, {k: v[:, :B] for k, v in traj.items()},
                     boot_obs[:B], generator, grad_tx, param_tx)

    monkeypatch.setattr(PPOAgent, "learner_step", half)
    assert not ppo_run()["correct"]


def test_a_reward_altered_where_the_env_produces_it_is_caught(monkeypatch):
    from repro_torch.envs.cartpole import CartPole
    step = CartPole.step

    def altered(self, state, action):
        new, obs, reward, done = step(self, state, action)
        return new, obs, reward.index_add(0, torch.tensor([0]),
                                          torch.ones(1)), done

    monkeypatch.setattr(CartPole, "step", altered)
    out = ppo_run()
    assert not out["correct"] and out["checks"]["env_gap"]["value"] == 1.0


def test_ppo_tf32_control_fails_the_cells_limits():
    cell = tiny_ppo_cell()
    got = calibrate.rl_seed(cell, 2 ** 31 + 23, True, device="cpu")
    _, ok = harness.checks(got["tf32"], cell.limits)
    assert not ok
    _, ok = harness.checks(got["program"], cell.limits)
    assert ok


def tiny_lm_cell(layers=3):
    config = dict(name="tiny-moe", family="moe", n_layers=layers,
                  d_model=128, n_heads=4, n_kv_heads=4, head_dim=32,
                  d_ff=256, vocab=2048, layer_pattern=["attn"],
                  norm="rmsnorm", rope_theta=10000.0,
                  moe=dict(n_experts=8, top_k=2, d_ff=64, n_shared=1,
                           every=1, first_dense=1, capacity_factor=1.25,
                           aux_loss_coef=0.01),
                  dtype="float32", use_kernels=True)
    traffic = dict(driver="lm_prefill", min_len=64, max_len=256,
                   n_lengths=8, strata=4, checked=5)
    return harness.Cell.of(
        "tiny-lm", config, traffic,
        harness.Cell("deepseek-moe-16b-f32-prefill").limits)


def lm_run():
    return lm_prefill.run(tiny_lm_cell(), seed=2 ** 31 + 25, seconds=0.2,
                          trace=False, device="cpu", t_start=0.0)


def test_sound_prefill_run_is_correct():
    out = lm_run()
    assert out["correct"] and list(out)[-1] == "checks"
    assert set(out["metrics"]) == {"prefill_tok_per_s", "ttft_p90_ms",
                                   "peak_mem_gib", "setup_s"}


def test_a_served_token_altered_where_it_is_produced_is_caught(monkeypatch):
    import repro_torch.launch.serve as serve
    pick = serve._next_token

    def altered(logits, temperature, generator):
        return (pick(logits, temperature, generator) + 1) % logits.shape[-1]

    monkeypatch.setattr(serve, "_next_token", altered)
    assert not lm_run()["correct"]


def test_prefill_tf32_control_fails_the_cells_limit():
    got = calibrate.lm_seed(tiny_lm_cell(layers=12), 2 ** 31 + 27, True,
                            0.2, device="cpu")
    _, ok = harness.checks(got["tf32"], tiny_lm_cell().limits)
    assert not ok
