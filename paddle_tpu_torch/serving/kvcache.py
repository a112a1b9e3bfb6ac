"""Host-side bookkeeping for the paged KV cache (port of
``paddle_tpu/serving/kvcache.py``, without the host-RAM tier).

The device side of paging is the pool pair ``[L, n_blocks, block_size,
nh, hd]`` plus fixed-shape per-slot int32 block tables (see
``serving.paged``).  Everything that decides *which* physical block holds
*which* logical tokens lives here, in plain Python:

* :class:`BlockPool` — the free list + per-block reference counts over
  the physical blocks.  Block 0 is reserved as the *trash block*: rows
  that have nothing to write (idle decode rows, padded prefill tokens)
  are pointed at it so every launch can write unconditionally with fixed
  shapes.  Allocation is all-or-nothing (:meth:`BlockPool.alloc_n`), so
  a request that cannot be admitted never leaves a torn block table.
* :class:`PrefixCache` — a radix tree over block-sized token chunks.
  Finished sequences donate their blocks to the tree; later requests
  whose prompts share a prefix reuse those blocks (read-only,
  ref-counted) instead of re-prefilling them.  A terminal block may be
  partial; adopting one is a **copy-on-write**: the engine copies it
  into a private block before extending it, so shared blocks are never
  mutated.  Unreferenced tree blocks are reclaimed in LRU order when the
  pool runs dry.

Thread safety: the owning engine serialises access under its own lock;
these classes are deliberately lock-free.
"""

from __future__ import annotations

import itertools

from ..profiler import counters

__all__ = ["TRASH_BLOCK", "BlockPoolExhausted", "BlockPool", "PrefixCache",
           "blocks_for_tokens"]

#: Physical block id every "nowhere" table entry points at.  Never
#: allocated, never read by a live query (attention masks trash
#: positions out before the softmax).
TRASH_BLOCK = 0


class BlockPoolExhausted(RuntimeError):
    """Allocation refused: not enough free blocks (after LRU eviction of
    every unreferenced prefix-cache block)."""

    def __init__(self, msg="", needed=0, free=0):
        super().__init__(msg)
        self.needed = int(needed)
        self.free = int(free)


def blocks_for_tokens(n_tokens, block_size):
    """Physical blocks needed to hold ``n_tokens`` KV positions."""
    return -(-int(n_tokens) // int(block_size))


class BlockPool:
    """Free list + ref counts over ``n_blocks`` physical KV blocks.

    Block ids index the pools' block axis.  Block 0
    (:data:`TRASH_BLOCK`) is reserved; ``capacity`` is therefore
    ``n_blocks - 1``.  A block's refcount is the number of holders —
    each admitted request holds one ref per table entry, and the
    :class:`PrefixCache` holds one ref per cached node — and the block
    returns to the free list when the count reaches zero.
    """

    def __init__(self, n_blocks, block_size, kv_dtype=None):
        if int(n_blocks) < 2:
            raise ValueError(
                f"n_blocks must be >= 2 (one trash block + one usable), "
                f"got {n_blocks}")
        if int(block_size) < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        if kv_dtype not in (None, "int8", "fp8"):
            raise ValueError(
                f"kv_dtype must be None, 'int8' or 'fp8', got {kv_dtype!r}")
        self.n_blocks = int(n_blocks)
        self.block_size = int(block_size)
        #: pool storage precision: None keeps the model dtype; "int8"/
        #: "fp8" store 1 byte/value + one fp32 scale per (block, position)
        #: (the device tensors live in the engine; this is metadata).
        self.kv_dtype = kv_dtype
        # LIFO free list, lowest ids handed out first (determinism)
        self._free = list(range(self.n_blocks - 1, 0, -1))
        self._ref = [0] * self.n_blocks

    @property
    def capacity(self):
        return self.n_blocks - 1

    @property
    def free_blocks(self):
        return len(self._free)

    @property
    def used_blocks(self):
        return self.capacity - len(self._free)

    def ref(self, block):
        return self._ref[block]

    def alloc(self):
        """One free block with refcount 1."""
        if not self._free:
            raise BlockPoolExhausted("block pool exhausted", needed=1,
                                     free=0)
        b = self._free.pop()
        self._ref[b] = 1
        return b

    def alloc_n(self, n):
        """``n`` blocks, all-or-nothing: either every block is allocated
        or none is (no torn tables on exhaustion)."""
        n = int(n)
        if len(self._free) < n:
            raise BlockPoolExhausted(
                f"need {n} blocks, {len(self._free)} free",
                needed=n, free=len(self._free))
        return [self.alloc() for _ in range(n)]

    def retain(self, block):
        if block == TRASH_BLOCK:
            raise ValueError("cannot retain the trash block")
        if self._ref[block] <= 0:
            raise ValueError(f"retain of free block {block}")
        self._ref[block] += 1

    def release(self, block):
        """Drop one reference; returns True when the block was freed."""
        if self._ref[block] <= 0:
            raise ValueError(f"release of free block {block}")
        self._ref[block] -= 1
        if self._ref[block] == 0:
            self._free.append(block)
            return True
        return False


class _Node:
    """One cached block of a sequence: ``chunk`` is the tuple of token
    ids whose K/V the block holds (``len(chunk) == block_size`` except
    for a terminal partial block)."""

    __slots__ = ("chunk", "block", "children", "partials", "parent",
                 "last_use")

    def __init__(self, chunk, block, parent):
        self.chunk = chunk
        self.block = block
        self.children = {}   # full-block chunk tuple -> _Node
        self.partials = {}   # partial chunk tuple -> _Node (leaves)
        self.parent = parent
        self.last_use = 0

    def is_leaf(self):
        return not self.children and not self.partials


class PrefixCache:
    """Radix tree over block-sized token chunks, ref-counting blocks in
    a :class:`BlockPool`.

    * :meth:`match` — walk the prompt; every matched FULL block is
      retained for the caller (shared read-only) and an optionally
      matched terminal PARTIAL block is returned for copy-on-write
      adoption.  At most ``limit`` tokens are matched (the engine
      passes ``T - 1``: the last prompt token is always recomputed so
      prefill still produces first-token logits).
    * :meth:`insert` — donate a finished sequence's blocks.  Each newly
      cached block gains one tree reference; chunks already cached keep
      the existing block (the donor's copy is simply released by the
      caller afterwards).
    * :meth:`evict` — reclaim unreferenced (tree-only, refcount 1) leaf
      blocks in LRU order, counted under ``serving.kv.blocks_evicted``.
    """

    def __init__(self, pool):
        self.pool = pool
        self._root = _Node((), TRASH_BLOCK, None)
        self._tick = itertools.count(1)
        self.nodes = 0

    # -- lookup --------------------------------------------------------------
    def _walk_full(self, tokens, limit, touch):
        """Longest full-block descent: returns (node, blocks, cached)."""
        bs = self.pool.block_size
        node, blocks, cached = self._root, [], 0
        while cached + bs <= limit:
            child = node.children.get(tuple(tokens[cached:cached + bs]))
            if child is None:
                break
            if touch:
                child.last_use = next(self._tick)
            node = child
            blocks.append(child.block)
            cached += bs
        return node, blocks, cached

    def _best_partial(self, node, tokens, cached, limit, touch):
        """Longest-usable terminal partial under ``node``: returns
        ``(node, n_usable)`` or ``(None, 0)``.  Usable means the
        partial's leading tokens match the prompt's next tokens."""
        best, best_p = None, 0
        for chunk, pn in node.partials.items():
            p = min(len(chunk), limit - cached)
            if p <= 0 or p <= best_p:
                continue
            if chunk[:p] == tuple(tokens[cached:cached + p]):
                best, best_p = pn, p
        if best is not None and touch:
            best.last_use = next(self._tick)
        return best, best_p

    def match(self, tokens, limit):
        """Match up to ``limit`` leading tokens of ``tokens``.

        Returns ``(blocks, cached, partial_node, partial_tokens)``:
        ``blocks`` are fully-shared block ids (each RETAINED for the
        caller — release them on admission failure), ``cached`` counts
        their tokens, and ``partial_node``/``partial_tokens`` describe a
        terminal partial block usable via copy-on-write.  The partial's
        block is RETAINED too: the caller releases it after the COW copy
        (or on admission failure), and the tree keeps its own retain so
        the node survives for the next sharer.
        """
        tokens = [int(t) for t in tokens[:max(0, int(limit))]]
        node, blocks, cached = self._walk_full(tokens, limit, touch=True)
        for b in blocks:
            self.pool.retain(b)
        pn, p = self._best_partial(node, tokens, cached, limit, touch=True)
        if pn is not None:
            self.pool.retain(pn.block)
        return blocks, cached, pn, p

    def peek(self, tokens, limit):
        """Read-only :meth:`match`: how many leading tokens the cache
        could serve (no refcounts, no LRU touch)."""
        tokens = [int(t) for t in tokens[:max(0, int(limit))]]
        node, _, cached = self._walk_full(tokens, limit, touch=False)
        _, p = self._best_partial(node, tokens, cached, limit, touch=False)
        return cached + p

    def probe(self, tokens, limit):
        """Read-only routing probe ``(device_tokens, host_tokens)``.
        Without a host tier nothing is host-resident, so this is
        ``(peek(tokens, limit), 0)``."""
        return self.peek(tokens, limit), 0

    # -- insertion -----------------------------------------------------------
    def insert(self, tokens, blocks):
        """Donate a sequence's blocks: ``blocks[i]`` holds the K/V of
        ``tokens[i*bs:(i+1)*bs]`` (the last chunk may be partial).
        Newly cached blocks are retained by the tree; already-cached
        chunks are skipped.  Returns the number of blocks newly cached."""
        bs = self.pool.block_size
        tokens = [int(t) for t in tokens]
        node, added, i = self._root, 0, 0
        while (i + 1) * bs <= len(tokens):
            chunk = tuple(tokens[i * bs:(i + 1) * bs])
            child = node.children.get(chunk)
            if child is None:
                child = _Node(chunk, blocks[i], node)
                child.last_use = next(self._tick)
                node.children[chunk] = child
                self.pool.retain(blocks[i])
                self.nodes += 1
                added += 1
            node = child
            i += 1
        rest = tuple(tokens[i * bs:])
        if rest and i < len(blocks) and rest not in node.partials:
            pn = _Node(rest, blocks[i], node)
            pn.last_use = next(self._tick)
            node.partials[rest] = pn
            self.pool.retain(blocks[i])
            self.nodes += 1
            added += 1
        return added

    # -- eviction ------------------------------------------------------------
    def _leaves(self, node, out):
        for child in node.children.values():
            self._leaves(child, out)
        for pn in node.partials.values():
            out.append(pn)
        if node is not self._root and node.is_leaf():
            out.append(node)

    def _detach(self, node):
        parent = node.parent
        if parent.partials.get(node.chunk) is node:
            del parent.partials[node.chunk]
        else:
            del parent.children[node.chunk]
        self.nodes -= 1

    def evict(self, n):
        """Free up to ``n`` blocks by releasing LRU leaf nodes whose
        blocks nobody but the tree references.  Returns blocks freed."""
        freed = 0
        while freed < n:
            leaves = []
            self._leaves(self._root, leaves)
            victims = sorted(
                (l for l in leaves if self.pool.ref(l.block) == 1),
                key=lambda l: l.last_use)
            if not victims:
                break
            victim = victims[0]
            self._detach(victim)
            self.pool.release(victim.block)
            freed += 1
            counters.inc("serving.kv.blocks_evicted")
        return freed
