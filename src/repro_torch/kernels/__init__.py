"""The port's hand-written CUDA kernels, one package each beside its
plain version; every wrapper counts its launches in `.launches`."""


def wrappers() -> dict:
    """Every kernel wrapper of the port, by name."""
    from repro_torch.kernels.advantages.kernel import (
        discounted_return_adjoint_tb, discounted_return_tb)
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_bwd, flash_attention_fwd_lse, flash_attention_hsd)
    from repro_torch.kernels.gmm.kernel import gmm_ecd
    from repro_torch.kernels.replay_sample.kernel import (
        prioritized_sample_c, shard_topk_c)
    from repro_torch.kernels.vtrace.kernel import vtrace_tb
    from repro_torch.kernels.wkv6.kernel import wkv6_btHN
    return {f.__name__: f for f in (
        discounted_return_tb, discounted_return_adjoint_tb, vtrace_tb,
        prioritized_sample_c, shard_topk_c, flash_attention_hsd,
        flash_attention_fwd_lse, flash_attention_bwd, gmm_ecd, wkv6_btHN)}


def launch_counts() -> dict:
    """{wrapper name: launches} of this process."""
    return {name: f.launches for name, f in wrappers().items()}
