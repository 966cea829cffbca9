"""Architecture registry of the port; `load_all` registers every config
the port has (so far the survey's policy trunk)."""
from repro_torch.configs.base import (ATTN, ModelConfig,  # noqa: F401
                                      get_config, register)


def load_all():
    from repro_torch.configs import paper_drl  # noqa: F401
