"""The port's kernel tier: each TPU kernel of the JAX package becomes a
kernel written by hand for Hopper, registered in :mod:`.registry` with
its plain PyTorch version.  Call surfaces live in their own modules
(``kernels.paged_attention``, ``kernels.fused_bn_relu``,
``kernels.flash_attention``, ``kernels.layernorm``,
``kernels.optimizer_update``)."""
from .registry import (KernelSpec, count_launch, describe, dispatch, get,
                       launch_dtypes, launches, list_kernels,
                       register_kernel, remedy_for, reset_launches)

__all__ = ["KernelSpec", "count_launch", "describe", "dispatch", "get",
           "launch_dtypes", "launches", "list_kernels", "register_kernel",
           "remedy_for", "reset_launches"]
