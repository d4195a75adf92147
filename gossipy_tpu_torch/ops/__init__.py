"""Hand-written kernels and their plain PyTorch versions."""

from .merge import (LAUNCHES, gather_merge_multi, gather_merge_multi_cuda,
                    gather_merge_multi_pytree, gather_merge_multi_reference,
                    reset_launch_counts)

__all__ = ["LAUNCHES", "gather_merge_multi", "gather_merge_multi_cuda",
           "gather_merge_multi_pytree", "gather_merge_multi_reference",
           "reset_launch_counts"]
