"""Host-pipeline wrapper (survey Fig. 5a baseline; the port of
src/repro/envs/host_env.py).

A `Wrapper` whose `step` copies the batched env state and the actions to
the host, steps the inner env there, and copies the result back to the
device the actions came from: the CPU-simulation pipeline where
intermediate data crosses host and device every step. It is a
measurement baseline, not an environment, so it takes no registry name.

It stays queue-free while the Trainer has a pipelined mode
(core/pipeline.py): the trajectory queue decouples experience generation
from learning, but not the env from itself. Stepping is closed-loop (step
t + 1 reads step t's output), and here that loop detours through host
memory every step, so no queue depth can prefetch across it. Under
``pipeline=True`` the wrapper runs inside the producer unchanged: the
same numbers as the on-device env, none of its cost hidden.
"""
from __future__ import annotations

from repro_torch.envs.api import tree_map
from repro_torch.envs.wrappers import Wrapper


class HostPipelined(Wrapper):
    def step(self, state, action):
        dev = action.device
        to_host = lambda a: a.cpu()
        back = lambda a: a.to(dev)
        s, o, r, d = self.inner.step(tree_map(to_host, state["inner"]),
                                     action.cpu())
        return ({"inner": tree_map(back, s), "wrap": state["wrap"]},
                back(o), back(r), back(d))
