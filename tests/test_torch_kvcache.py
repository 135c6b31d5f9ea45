"""The PyTorch port's paged KV cache, mirroring the JAX package's cache
tests (block lifecycle, exhaustion without debris, fragmentation,
padded tables) and holding its bookkeeping equal to the JAX cache's
over the same operations."""
import numpy as np
import pytest
import torch

from mxnet_tpu.serving.decode import PagedKVCache as JaxPagedKVCache
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.serving.decode import (SCRATCH_BLOCK, KVCacheExhausted,
                                            PagedKVCache)


def _cache(*args, **kw):
    return PagedKVCache(*args, device="cpu", **kw)


def test_kvcache_alloc_free_cycle():
    c = _cache(2, 2, 8, block_size=4, num_blocks=16)
    assert c.total_blocks == 15          # block 0 reserved as scratch
    t = c.allocate(10)                   # ceil(10/4) = 3 blocks
    assert len(t.blocks) == 3
    assert SCRATCH_BLOCK not in t.blocks
    assert c.blocks_in_use() == 3
    assert c.free_blocks() == 12
    c.free(t)
    assert c.blocks_in_use() == 0
    c.free(t)                            # idempotent
    assert c.blocks_in_use() == 0


def test_kvcache_exhaustion_and_can_admit():
    c = _cache(1, 1, 4, block_size=4, num_blocks=5)  # 4 usable
    t = c.allocate(12)                   # 3 of 4
    assert c.can_admit(4) and not c.can_admit(5)
    with pytest.raises(KVCacheExhausted):
        c.allocate(8)
    assert c.blocks_in_use() == 3        # failed alloc left no debris
    c.free(t)
    c.allocate(16)                       # the whole cache fits again


def test_kvcache_fragmentation_and_padded_table():
    c = _cache(1, 1, 4, block_size=4, num_blocks=16)
    t = c.allocate(6)                    # 2 blocks for 6 tokens
    c.note_tokens(t, 5)                  # 5 live of 8 allocated slots
    assert c.stats()["fragmentation"] == pytest.approx(3 / 8)
    padded = c.padded_table(t, 6)
    assert padded.shape == (6,) and padded.dtype == np.int32
    assert list(padded[:2]) == list(t.blocks)
    assert all(b == SCRATCH_BLOCK for b in padded[2:])
    with pytest.raises(MXNetError, match="wider"):
        c.padded_table(t, 1)
    c.free(t)


@pytest.mark.parametrize("dtype,want", [("float32", torch.float32),
                                        ("bfloat16", torch.bfloat16),
                                        (torch.bfloat16, torch.bfloat16)])
def test_kvcache_slabs_on_device(dtype, want):
    c = _cache(3, 2, 8, block_size=4, num_blocks=6, dtype=dtype)
    assert c.keys.shape == (3, 6, 4, 2, 8) == c.values.shape
    assert c.keys.dtype == want and c.keys.device.type == "cpu"
    assert not c.keys.any()


def test_kvcache_rejects_bad_geometry_and_dtype():
    with pytest.raises(MXNetError):
        _cache(1, 1, 4, block_size=4, num_blocks=1)
    with pytest.raises(MXNetError):
        _cache(1, 1, 4, block_size=0, num_blocks=4)
    with pytest.raises(MXNetError, match="dtype"):
        _cache(1, 1, 4, block_size=4, num_blocks=4, dtype="int8")


def test_kvcache_bookkeeping_matches_jax():
    mine = _cache(1, 1, 4, block_size=4, num_blocks=12)
    ref = JaxPagedKVCache(1, 1, 4, block_size=4, num_blocks=12)
    tables = []
    for n in (3, 9, 4, 17):
        tables.append((mine.allocate(n), ref.allocate(n)))
        assert mine.stats() == ref.stats()
    for (a, b), n in zip(tables, (2, 7, 4, 11)):
        mine.note_tokens(a, n)
        ref.note_tokens(b, n)
        assert a.blocks == b.blocks
        np.testing.assert_array_equal(mine.padded_table(a, 6),
                                      ref.padded_table(b, 6))
    assert mine.stats() == ref.stats()
    for a, b in tables[::2]:
        mine.free(a)
        ref.free(b)
    assert mine.stats() == ref.stats()
    assert mine.allocate(12).blocks == ref.allocate(12).blocks
