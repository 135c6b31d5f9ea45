"""Block/paged KV cache manager (counterpart of
``mxnet_tpu/serving/decode/kvcache.py``).

At construction the cache allocates ONE per-layer slab pair on the
device -- keys and values, shape ``(layers, num_blocks, block_size,
heads, head_dim)`` -- and carves it into fixed-size blocks.  A request
is admitted by handing it a **block table**, the ordered block ids its
tokens map onto: token position ``p`` lives at ``(table[p //
block_size], p % block_size)``.  Prefill and decode write the slabs in
place, so the cache never allocates again after construction.

The whole ``prompt_len + max_new_tokens`` budget is allocated at
admission, and :class:`KVCacheExhausted` is raised when the free list
cannot cover it, so a running sequence never fails for cache space.
EOS, completion, cancel and timeout return blocks through :meth:`free`.

Block 0 is the **scratch block**: padded decode slots write there, so
it is never handed to a request and holds garbage by design.

Allocations, frees and refused allocations count under the JAX
package's ``kvcache.*`` telemetry (blocks in use, internal
fragmentation).
"""
from __future__ import annotations

import numpy as np
import torch

from ... import sync as _sync
from ... import telemetry as _telemetry
from ...base import MXNetError
from ...context import resolve_device

__all__ = ["PagedKVCache", "BlockTable", "KVCacheExhausted",
           "SCRATCH_BLOCK"]

# block id 0 is the write sink of padded slots; never allocated
SCRATCH_BLOCK = 0

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _torch_dtype(dtype):
    try:
        return _DTYPES[str(dtype).replace("torch.", "")]
    except KeyError:
        raise MXNetError("unsupported KV cache dtype %r (one of %s)"
                         % (dtype, ", ".join(_DTYPES))) from None


class KVCacheExhausted(MXNetError):
    """Admission-time allocation failed: the free list cannot cover the
    request's ``prompt + max_new`` block budget."""


class BlockTable:
    """One request's ordered block ids plus its token-capacity bound."""

    __slots__ = ("blocks", "capacity", "freed")

    def __init__(self, blocks, capacity):
        self.blocks = list(blocks)
        self.capacity = int(capacity)   # tokens the table can hold
        self.freed = False

    def __len__(self):
        return len(self.blocks)

    def __repr__(self):
        return "BlockTable(blocks=%r, capacity=%d%s)" % (
            self.blocks, self.capacity, ", freed" if self.freed else "")


class PagedKVCache:
    """Fixed-size block allocator over preallocated per-layer K/V slabs.

    Parameters
    ----------
    layers, heads, head_dim : model geometry of the cached K/V
    block_size : tokens per block
    num_blocks : total blocks in the slab (block 0 is scratch, so the
        allocatable pool is ``num_blocks - 1``)
    dtype : cache dtype (``"float32"``, ``"bfloat16"`` or a torch dtype)
    device : where the slabs live (CUDA unless ``"cpu"``)
    """

    def __init__(self, layers, heads, head_dim, block_size, num_blocks,
                 dtype="float32", device=None):
        if block_size < 1 or num_blocks < 2:
            raise MXNetError(
                "PagedKVCache needs block_size >= 1 and num_blocks >= 2 "
                "(block 0 is the reserved scratch block), got "
                "block_size=%r num_blocks=%r" % (block_size, num_blocks))
        self.layers = int(layers)
        self.heads = int(heads)
        self.head_dim = int(head_dim)
        self.block_size = int(block_size)
        self.num_blocks = int(num_blocks)
        self.dtype = _torch_dtype(dtype)
        self.device = resolve_device(device)
        shape = (self.layers, self.num_blocks, self.block_size,
                 self.heads, self.head_dim)
        self.keys = torch.zeros(shape, dtype=self.dtype, device=self.device)
        self.values = torch.zeros(shape, dtype=self.dtype,
                                  device=self.device)
        self._lock = _sync.Lock(name="serving.kvcache")
        self._free = list(range(1, self.num_blocks))  # 0 = scratch
        self._used_tokens = {}          # id(table) -> tokens written

    # -- sizing ---------------------------------------------------------
    def blocks_for(self, n_tokens):
        """Blocks needed to hold ``n_tokens`` (ceil)."""
        return max(1, -(-int(n_tokens) // self.block_size))

    @property
    def total_blocks(self):
        """Allocatable pool size (scratch excluded)."""
        return self.num_blocks - 1

    def free_blocks(self):
        with self._lock:
            return len(self._free)

    def blocks_in_use(self):
        with self._lock:
            return self.total_blocks - len(self._free)

    def can_admit(self, n_tokens):
        """Whether :meth:`allocate` for ``n_tokens`` would succeed now."""
        with self._lock:
            return self.blocks_for(n_tokens) <= len(self._free)

    # -- allocate / free ------------------------------------------------
    def allocate(self, n_tokens):
        """Carve a :class:`BlockTable` holding ``n_tokens`` from the
        free list, or raise :class:`KVCacheExhausted` without partial
        allocation."""
        need = self.blocks_for(n_tokens)
        with self._lock:
            if need > len(self._free):
                shortfall = len(self._free)
            else:
                blocks = [self._free.pop() for _ in range(need)]
                table = BlockTable(blocks, capacity=need * self.block_size)
                self._used_tokens[id(table)] = int(n_tokens)
                in_use = self.total_blocks - len(self._free)
                frag = self._fragmentation_locked()
                shortfall = None
        if shortfall is not None:
            if _telemetry._ENABLED:
                _telemetry.hooks.kvcache_alloc_failure()
            raise KVCacheExhausted(
                "kv cache exhausted: need %d blocks for %d tokens, "
                "%d free (of %d)" % (need, n_tokens, shortfall,
                                     self.total_blocks))
        if _telemetry._ENABLED:
            _telemetry.hooks.kvcache_alloc(in_use, frag)
        return table

    def free(self, table):
        """Return a table's blocks to the free list.  Idempotent: the
        EOS/timeout/cancel paths may race a drain."""
        with self._lock:
            if table.freed:
                return
            table.freed = True
            self._free.extend(table.blocks)
            self._used_tokens.pop(id(table), None)
            in_use = self.total_blocks - len(self._free)
            frag = self._fragmentation_locked()
        if _telemetry._ENABLED:
            _telemetry.hooks.kvcache_free(in_use, frag)

    # -- introspection --------------------------------------------------
    def _fragmentation_locked(self):
        """Share of allocated token slots not (yet) holding a token."""
        in_use = self.total_blocks - len(self._free)
        if in_use == 0:
            return 0.0
        used = sum(self._used_tokens.values())
        return max(0.0, 1.0 - used / float(in_use * self.block_size))

    def note_tokens(self, table, n_tokens):
        """Update the written-token count for ``table`` (fragmentation
        accounting only; capacity is fixed at admission)."""
        with self._lock:
            if not table.freed:
                self._used_tokens[id(table)] = int(n_tokens)

    def stats(self):
        with self._lock:
            in_use = self.total_blocks - len(self._free)
            return {
                "block_size": self.block_size,
                "total_blocks": self.total_blocks,
                "blocks_in_use": in_use,
                "free_blocks": len(self._free),
                "fragmentation": round(self._fragmentation_locked(), 4),
            }

    def padded_table(self, table, width):
        """The table as a fixed-width int32 row: real ids first,
        scratch-block padding after (reads there are masked by context
        length)."""
        if len(table.blocks) > width:
            raise MXNetError(
                "block table %d wider than compiled width %d"
                % (len(table.blocks), width))
        row = np.full((width,), SCRATCH_BLOCK, np.int32)
        row[:len(table.blocks)] = table.blocks
        return row

    def __repr__(self):
        return "PagedKVCache(%s)" % (self.stats(),)
