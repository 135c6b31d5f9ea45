"""``mx.dataio`` (counterpart of ``mxnet_tpu/dataio``): the device
feed.

Overlapped host->device staging for any batch source: a background
thread fills a ring of pinned host slots and issues each batch's copy
to the card on a side stream, so the copy hides behind training
compute; batches cross in compact dtypes, and an on-device
:class:`DeviceTransform` expands them after landing.
"""
from .feed import DeviceBatch, DeviceFeed
from .transforms import DeviceTransform

__all__ = ["DeviceBatch", "DeviceFeed", "DeviceTransform"]
