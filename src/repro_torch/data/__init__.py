from repro_torch.data.tokens import TokenStream  # noqa: F401
