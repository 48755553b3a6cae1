"""PyTorch/CUDA port of api_ratelimit_tpu for one NVIDIA H100.

The JAX package stays the reference; this package mirrors its module paths
and never imports it (or JAX). Entry points run on the card by default
(`device="cuda"`) and raise when there is none; pass `device="cpu"` to run
the kernels' plain PyTorch versions.
"""
