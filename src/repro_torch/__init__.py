"""PyTorch/CUDA port of the `repro` package (src/repro), slice by slice.

It imports torch and never jax or `repro`; the tests hold it against the
reference. Entry points run on the card unless the caller passes
`device="cpu"`.
"""
