"""``mx.mod``: the legacy Module API (counterpart of
``mxnet_tpu/module``; reference ``python/mxnet/module/``)."""
from .base_module import BaseModule
from .bucketing_module import BucketingModule
from .module import Module

__all__ = ["BaseModule", "BucketingModule", "Module"]
