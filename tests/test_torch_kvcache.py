"""Block pool + prefix cache of the PyTorch port against the JAX package's.

One script of alloc_n / retain / release / insert / match / peek / probe
/ evict runs against both packages' ``BlockPool`` + ``PrefixCache``; every
block id, refcount, match, eviction and counter movement it observes must
be identical.
"""

import pytest

from paddle_tpu.profiler import counters as jcounters
from paddle_tpu.serving import kvcache as jkv
from paddle_tpu_torch.profiler import counters as tcounters
from paddle_tpu_torch.serving import kvcache as tkv


def _script(kv, counters):
    log = []
    pool = kv.BlockPool(12, 4)
    cache = kv.PrefixCache(pool)
    before = counters.snapshot()

    def state(tag):
        log.append((tag, pool.free_blocks, pool.used_blocks,
                    tuple(pool.ref(b) for b in range(pool.n_blocks)),
                    cache.nodes))

    a = pool.alloc_n(3)
    b = pool.alloc_n(2)
    log.append(("alloc", a, b))
    state("alloc")
    seq_a = list(range(10))                       # 2 full blocks + 2 tokens
    seq_b = list(range(8)) + [50, 51, 52]         # shares 2 blocks with a
    log.append(("insert_a", cache.insert(seq_a, a)))
    log.append(("insert_b", cache.insert(seq_b, a[:2] + b[1:])))
    for blk in a + b:
        pool.release(blk)
    state("donated")
    for prompt, limit in ((seq_a + [99], 10), (seq_a, 9), (seq_b + [7], 11),
                          ([0, 1, 2, 3, 9, 9, 9], 6), ([42] * 9, 8)):
        blocks, cached, pn, p = cache.match(prompt, limit)
        log.append(("match", prompt, blocks, cached,
                    None if pn is None else (pn.block, pn.chunk), p))
        log.append(("peek", cache.peek(prompt, limit)))
        log.append(("probe", cache.probe(prompt, limit)))
        for blk in blocks:
            pool.release(blk)
        if pn is not None:
            pool.release(pn.block)
        state("after_match")
    c = pool.alloc_n(pool.free_blocks - 1)
    log.append(("alloc_rest", c))
    held = cache.match(seq_a, 8)[0]               # pin a's full blocks
    log.append(("evict", cache.evict(3)))
    state("evicted")
    for blk in held + c:
        pool.release(blk)
    log.append(("evict_all", cache.evict(100)))
    state("empty")
    with pytest.raises(kv.BlockPoolExhausted):
        pool.alloc_n(pool.capacity + 1)
    with pytest.raises(ValueError):
        pool.retain(kv.TRASH_BLOCK)
    state("end")
    moved = counters.delta(before)
    log.append(("counters", {k: v for k, v in moved.items()
                             if k.startswith("serving.kv.")}))
    return log


def test_same_behaviour_as_jax_package():
    got = _script(tkv, tcounters)
    want = _script(jkv, jcounters)
    assert got == want
    # the script exercised what it claims to
    assert any(e[0] == "match" and e[4] is not None for e in got)
    assert dict(got[-1][1])["serving.kv.blocks_evicted"] > 0


@pytest.mark.parametrize("n,bs,want", [(1, 4, 1), (4, 4, 1), (5, 4, 2),
                                       (16, 4, 4), (0, 16, 0)])
def test_blocks_for_tokens(n, bs, want):
    assert tkv.blocks_for_tokens(n, bs) == jkv.blocks_for_tokens(n, bs) \
        == want
