from repro_torch.checkpoint.ckpt import (load_actor_policy,  # noqa: F401
                                         load_checkpoint, load_train_state,
                                         save_checkpoint, save_train_state)
from repro_torch.checkpoint.convert import (params_from_jax,  # noqa: F401
                                            params_to_jax)
