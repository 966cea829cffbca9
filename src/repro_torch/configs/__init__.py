"""Architecture registry of the port; `load_all` registers every config
the port has (the survey's policy trunk and the LM serving configs)."""
from repro_torch.configs.base import (ATTN, RWKV,  # noqa: F401
                                      ModelConfig, MoESpec, get_config,
                                      register)


def load_all():
    from repro_torch.configs import (deepseek_moe_16b,  # noqa: F401
                                     paper_drl, rwkv6_1_6b, smollm_360m)
