"""The sharding sanitizer's names, not yet ported (counterpart of
``mxnet_tpu/analysis/sharding.py``).

The JAX module audits meshes, ``shard_map`` specs, donation and the
GSPMD collectives of compiled programs (``--collective-diff``,
``MXNET_TPU_SHARD_CHECK``, ``MXNET_TPU_TRANSFER_GUARD``).  The port has
no mesh, ``shard_map`` or in-graph collective yet: they come with
ROADMAP item 9b (in-graph collectives across cards), and the sanitizer
with them.  Until then each name exists and raises ``MXNetError``
naming that item, so code written against the JAX package fails loudly
instead of finding the name missing.
"""
from __future__ import annotations

from ..base import MXNetError

__all__ = ["audit_sharding", "declared_axes", "collective_profile",
           "collective_contract", "save_contract", "load_contract",
           "diff_contract", "CONTRACT_SCHEMA", "transfer_guard",
           "install_transfer_guard", "shard_check_enabled"]

CONTRACT_SCHEMA = "mxshard.collectives.v1"


def _not_ported(name):
    def fn(*args, **kwargs):
        raise MXNetError(
            "analysis.%s: the sharding sanitizer audits meshes, "
            "shard_map and in-graph collectives, which the port gets "
            "with ROADMAP item 9b (in-graph collectives across cards); "
            "not ported yet" % name)
    fn.__name__ = name
    fn.__doc__ = "Not ported yet (ROADMAP item 9b): raises MXNetError."
    return fn


audit_sharding = _not_ported("audit_sharding")
declared_axes = _not_ported("declared_axes")
collective_profile = _not_ported("collective_profile")
collective_contract = _not_ported("collective_contract")
save_contract = _not_ported("save_contract")
load_contract = _not_ported("load_contract")
diff_contract = _not_ported("diff_contract")
transfer_guard = _not_ported("transfer_guard")
install_transfer_guard = _not_ported("install_transfer_guard")
shard_check_enabled = _not_ported("shard_check_enabled")
