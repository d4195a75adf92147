"""Runnable twins of the JAX package's examples (``python -m
gossipy_tpu_torch.examples.<name>``)."""
