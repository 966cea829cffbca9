"""The port's LM training (repro_torch.models.model `loss` and remat,
repro_torch.data, repro_torch.launch.train) on the CPU against the JAX
package, for the reduced() dense, recurrent, frontend and MLA archs:
smollm-360m, paper-drl-trunk, gemma3-1b, rwkv6-1.6b, stablelm-1.6b,
minicpm3-4b, whisper-base and paligemma-3b (the MoE archs are in
tests/test_torch_lm_train_moe.py, so that `--dist loadfile` runs the two
files on different workers). tests/lm_train_parity.py says how and
within what:

  * loss and every gradient leaf in f32, against
    `jax.value_and_grad(model.loss)` on the same params and tokens;
  * one optimizer step of the launcher's optimizer on smollm-360m;
  * remat (bitwise the port without it; JAX's remat=True) on smollm-360m,
    two stacked super-blocks;
  * bf16 compute on f32 master weights on smollm-360m against the
    reference's bf16 model: loss within 2^-10 relative (measured 7e-8),
    every gradient leaf within 2^-5 x max|g_ref| (measured 9.4e-3);
  * `TokenStream`: the law, the shapes, determinism, `optimal_ce`;
  * `launch/train.py`: the reference's learning bar
    (tests/test_system.py), `n_params`, checkpoints that restore in both
    packages, the CLI's last line and the card default.
"""
import contextlib
import io
import json

import jax
import numpy as np
import pytest
import torch

from lm_train_parity import (check_bf16, check_loss_and_grad,  # noqa: F401
                             check_optimizer_step, check_remat,
                             deterministic, jax_params)
from repro.checkpoint import load_checkpoint as jax_load_checkpoint
from repro.data import TokenStream as JaxTokenStream
from repro_torch.checkpoint import (load_checkpoint, params_from_jax,
                                    params_to_jax)
from repro_torch.data import TokenStream
from repro_torch.launch import train as tt

ARCHS = ["smollm-360m", "paper-drl-trunk", "gemma3-1b", "rwkv6-1.6b",
         "stablelm-1.6b", "minicpm3-4b", "whisper-base", "paligemma-3b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grad_match_jax(arch):
    check_loss_and_grad(arch)


def test_optimizer_step_matches_jax():
    check_optimizer_step("smollm-360m")


def test_remat_matches_jax_and_itself():
    check_remat("smollm-360m")


def test_bf16_trains_on_f32_master_weights():
    check_bf16("smollm-360m")


# ------------------------------------------------------------ the stream
def test_token_stream_is_deterministic_with_the_reference_shapes():
    s = TokenStream(97, 32, 8, seed=3)
    a, b = s.batch_at(5)["tokens"], s.batch_at(5)["tokens"]
    assert torch.equal(a, b)
    assert a.shape == (8, 33) and a.dtype == torch.int32
    assert int(a.min()) >= 0 and int(a.max()) < 97
    assert not torch.equal(a, s.batch_at(6)["tokens"])
    assert not torch.equal(a, TokenStream(97, 32, 8, seed=4).batch_at(5)[
        "tokens"])
    jshape = JaxTokenStream(97, 32, 8).batch_at(5)["tokens"].shape
    assert tuple(a.shape) == tuple(jshape)
    shards = [s.shard_at(5, i, 4)["tokens"] for i in range(4)]
    assert all(t.shape == (2, 33) for t in shards)
    assert tuple(JaxTokenStream(97, 32, 8).shard_at(5, 1, 4)[
        "tokens"].shape) == (2, 33)
    assert torch.equal(shards[1], s.shard_at(5, 1, 4)["tokens"])


def test_token_stream_follows_the_plus_one_law():
    t = TokenStream(97, 256, 4, seed=1).batch_at(0)["tokens"].long()
    frac = float(((t[:, 1:] - t[:, :-1]) % 97 == 1).float().mean())
    # p + (1 - p) / vocab = 0.901 expected
    assert 0.8 < frac < 0.97


@pytest.mark.parametrize("vocab,p", [(97, 0.9), (512, 0.9), (65536, 0.5),
                                     (2, 0.99)])
def test_optimal_ce_equals_the_reference(vocab, p):
    got = TokenStream(vocab, 8, 2, p_predictable=p).optimal_ce()
    assert got == JaxTokenStream(vocab, 8, 2, p_predictable=p).optimal_ce()


# ---------------------------------------------------------- the launcher
def test_train_loss_descends_as_the_reference_bar():
    """tests/test_system.py::test_lm_training_loss_descends, the port's
    launcher on the CPU; n_params is the reference's count. Two torch
    threads: beside the other test processes more only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        out = tt.train("paper-drl-trunk", reduced=True, steps=120,
                       batch=16, seq=64, lr=3e-3, log_every=20,
                       device="cpu")
    finally:
        torch.set_num_threads(threads)
    first, last = out["history"][0]["ce"], out["history"][-1]["ce"]
    assert last < first * 0.6, (first, last)
    assert last < 4.0
    assert [h["step"] for h in out["history"]] == [0, 20, 40, 60, 80, 100,
                                                  119]
    assert out["n_params"] == sum(
        x.size for x in jax.tree_util.tree_leaves(
            jax_params("paper-drl-trunk")))
    assert out["optimal_ce"] == JaxTokenStream(512, 64, 16).optimal_ce()


def test_checkpoints_restore_in_both_packages(tmp_path):
    """The port's archive restores through the reference's
    load_checkpoint with its template, leaf for leaf; the reference's
    `train` archive restores into the port as the reference restores
    it."""
    from repro.launch.train import train as jax_train
    arch = "paper-drl-trunk"
    path = str(tmp_path / "port.npz")
    out = tt.train(arch, steps=2, batch=2, seq=8, ckpt=path, log_every=1,
                   device="cpu", return_state=True)
    restored, step = jax_load_checkpoint(path, {"params": jax_params(arch)})
    assert step == 2
    want = params_to_jax(out["params"])
    got = jax.tree_util.tree_map(np.asarray, restored["params"])
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(g, w)

    jpath = str(tmp_path / "jax.npz")
    jax_train(arch, steps=2, batch=2, seq=8, ckpt=jpath, log_every=1)
    template = {f"params/{k}": torch.zeros_like(v)
                for k, v in out["params"].items()}
    tparams, tstep = load_checkpoint(jpath, template)
    jrestored, _ = jax_load_checkpoint(jpath, {"params": jax_params(arch)})
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jrestored))
    assert tstep == 2 and sorted(tparams) == sorted(want)
    for k in want:
        assert torch.equal(tparams[k], want[k]), k


def test_cli_last_line_and_card_default():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        tt.main(["--arch", "paper-drl-trunk", "--reduced", "--steps", "3",
                 "--batch", "2", "--seq", "8", "--device", "cpu"])
    lines = buf.getvalue().strip().splitlines()
    assert [json.loads(x)["step"] for x in lines[:-1]] == [0, 2]
    last = json.loads(lines[-1])
    assert last["arch"] == "paper-drl-trunk"
    assert last["n_params"] > 0
    assert last["optimal_ce"] == TokenStream(512, 8, 2).optimal_ce()
    assert "history" not in last and last["device"] == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tt.main(["--arch", "paper-drl-trunk", "--reduced", "--steps",
                     "1"])
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tt.train("paper-drl-trunk", steps=1)
