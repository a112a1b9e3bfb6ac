"""Host-side bookkeeping for the paged KV cache (port of
``paddle_tpu/serving/kvcache.py``).

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
* :class:`HostKVTier` — a host-RAM arena for *spilled* blocks.  When the
  device pool is oversubscribed, cold tree leaves move their K/V tiles to
  host buffers instead of being discarded: the node stays in the radix
  tree (``host=True``, device block released) and pages back on demand
  when a prompt matches it again.  Buffers come from a reuse pool keyed
  by (shape, dtype), so steady-state spill/restore never allocates
  (``serving.kv.host_buf_reuse``); they are pinned (page-locked) when the
  pools live on CUDA, so a restore's host-to-device copy can run
  asynchronously.  The device copies are the engine's job
  (``serving.paged``).

Host-residency invariant: only leaf-ward nodes spill (a node is
spillable only once its entire subtree is host-resident), so the
host-resident nodes of any root-to-leaf path form a contiguous *suffix*
of that path.  Dropping a host node therefore drops an all-host subtree
and can never strand a device block.

Thread safety: the owning engine serialises access under its own lock;
these classes are deliberately lock-free.
"""

from __future__ import annotations

import itertools

import torch

from ..profiler import counters

__all__ = ["TRASH_BLOCK", "BlockPoolExhausted", "HostTierLost", "BlockPool",
           "PrefixCache", "HostKVTier", "blocks_for_tokens"]

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


class HostTierLost(RuntimeError):
    """A spilled request's host copy is gone (tier LRU overflow, or the
    ``kv_spill_drop`` fault), so its KV cannot be paged back.  The caller
    replays the request by re-prefill: same tokens, same seed, same
    output."""


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
                 "last_use", "host")

    def __init__(self, chunk, block, parent):
        self.chunk = chunk
        self.block = block
        self.children = {}   # full-block chunk tuple -> _Node
        self.partials = {}   # partial chunk tuple -> _Node (leaves)
        self.parent = parent
        self.last_use = 0
        #: True once the node's K/V lives in the host tier: ``block`` is
        #: TRASH_BLOCK and the tier holds this node as its entry key.
        self.host = False

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
        #: optional :class:`HostKVTier`; wired by the engine when
        #: ``host_kv_blocks > 0``.
        self.tier = None
        #: hashes of root-level full-chunk children: the radix digest
        #: :meth:`probe` reads before walking the tree.
        self._digest = set()

    # -- lookup --------------------------------------------------------------
    def _walk_full(self, tokens, limit, touch):
        """Longest full-block descent over DEVICE-resident nodes:
        returns (node, blocks, cached).  Host-resident children stop the
        walk — their blocks are TRASH until restored, so matching past
        them would retain the trash block."""
        bs = self.pool.block_size
        node, blocks, cached = self._root, [], 0
        while cached + bs <= limit:
            child = node.children.get(tuple(tokens[cached:cached + bs]))
            if child is None or child.host:
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
        (or on admission failure), and the tree keeps its OWN retain so
        the node survives for the next sharer — without the caller-side
        retain, the COW release would strip the tree's reference and
        leave a dangling partial node over a freed (and eventually
        reused) block.
        """
        tokens = [int(t) for t in tokens[:max(0, int(limit))]]
        node, blocks, cached = self._walk_full(tokens, limit, touch=True)
        for b in blocks:
            self.pool.retain(b)
        pn, p = self._best_partial(node, tokens, cached, limit, touch=True)
        if pn is not None:
            self.pool.retain(pn.block)
        return blocks, cached, pn, p

    def match_full(self, tokens, limit):
        """Full-block-only :meth:`match`: the longest fully-cached block
        run, with NO terminal-partial candidate.  The KV-migration adopt
        path uses this — a migrated request shares only whole data blocks
        strictly below its write frontier (the block it will write next
        must stay private), and a partial adoption would be exactly the
        COW device copy the migration is trying to avoid.  Returns
        ``(blocks, cached)``; every block is RETAINED on this pool for
        the caller (the refcount transfer: release them on adopt
        failure)."""
        tokens = [int(t) for t in tokens[:max(0, int(limit))]]
        _, blocks, cached = self._walk_full(tokens, limit, touch=True)
        for b in blocks:
            self.pool.retain(b)
        return blocks, cached

    def peek(self, tokens, limit):
        """Read-only :meth:`match`: how many leading tokens the cache
        could serve (no refcounts, no LRU touch)."""
        tokens = [int(t) for t in tokens[:max(0, int(limit))]]
        node, _, cached = self._walk_full(tokens, limit, touch=False)
        _, p = self._best_partial(node, tokens, cached, limit, touch=False)
        return cached + p

    def probe(self, tokens, limit):
        """Read-only routing probe: ``(device_tokens, host_tokens)``.

        ``device_tokens`` counts leading tokens servable without any
        restore (full device blocks plus a terminal COW partial);
        ``host_tokens`` counts the contiguous host-resident run that
        would extend the device match after paging back in.  A
        first-chunk digest check short-circuits the walk for prompts
        this tree has never seen."""
        limit = max(0, int(limit))
        bs = self.pool.block_size
        if (limit >= bs and len(tokens) >= bs and not self._root.partials
                and hash(tuple(int(t) for t in tokens[:bs]))
                not in self._digest):
            return 0, 0
        tokens = [int(t) for t in tokens[:limit]]
        node, _, cached = self._walk_full(tokens, limit, touch=False)
        host = 0
        while cached + host + bs <= limit:
            child = node.children.get(
                tuple(tokens[cached + host:cached + host + bs]))
            if child is None or not child.host:
                break
            node = child
            host += bs
        if host:
            return cached, host
        _, p = self._best_partial(node, tokens, cached, limit, touch=False)
        return cached + p, 0

    def digest(self):
        """Snapshot of the radix digest (hashes of first-chunk entries):
        what :meth:`probe`'s fast path consults."""
        return frozenset(self._digest)

    # -- insertion -----------------------------------------------------------
    def insert(self, tokens, blocks):
        """Donate a sequence's blocks: ``blocks[i]`` holds the K/V of
        ``tokens[i*bs:(i+1)*bs]`` (the last chunk may be partial).
        Newly cached blocks are retained by the tree; already-cached
        chunks are skipped.  A host-resident node on the walk path is
        *re-adopted* in place: the donor carries a live device copy of
        that chunk, so the node flips back to device residency for free
        and its host buffers recycle (``serving.kv.tier.readopted``).
        Returns the number of blocks newly cached."""
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
                if node is self._root:
                    self._digest.add(hash(chunk))
            elif child.host:
                child.block = blocks[i]
                self.pool.retain(blocks[i])
                child.host = False
                child.last_use = next(self._tick)
                if self.tier is not None:
                    self.tier.pop(child)
                counters.inc("serving.kv.tier.readopted")
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
        if node.chunk in parent.partials and \
                parent.partials[node.chunk] is node:
            del parent.partials[node.chunk]
        else:
            del parent.children[node.chunk]
            if parent is self._root:
                self._digest.discard(hash(node.chunk))
        self.nodes -= 1

    def evict(self, n):
        """Free up to ``n`` blocks by releasing LRU leaf nodes whose
        blocks nobody but the tree references.  Returns blocks freed.
        Host-resident nodes are never evicted here — they hold no
        device block; :meth:`drop_host` is their exit path."""
        freed = 0
        while freed < n:
            leaves = []
            self._leaves(self._root, leaves)
            victims = sorted(
                (l for l in leaves
                 if not l.host and self.pool.ref(l.block) == 1),
                key=lambda l: l.last_use)
            if not victims:
                break
            victim = victims[0]
            self._detach(victim)
            self.pool.release(victim.block)
            freed += 1
            counters.inc("serving.kv.blocks_evicted")
        return freed

    # -- host tiering --------------------------------------------------------
    def _spillables(self, node, out):
        for child in node.children.values():
            self._spillables(child, out)
            if (not child.host and not child.partials
                    and self.pool.ref(child.block) == 1
                    and all(c.host for c in child.children.values())):
                out.append(child)

    def spill_victims(self, n):
        """Up to ``n`` nodes eligible to spill to the host tier,
        coldest first.  Eligible: a full-block node the tree alone
        references (refcount 1), with no partial children (partials
        stay device-side — they exist only for COW adoption) and whose
        full children are ALL already host-resident.  That closure rule
        is what keeps host nodes a contiguous suffix of every path —
        a device node can never end up below a host one."""
        out = []
        self._spillables(self._root, out)
        out.sort(key=lambda nd: nd.last_use)
        return out[:max(0, int(n))]

    def mark_spilled(self, node):
        """Flip a node to host residency AFTER the engine has copied
        its K/V into host buffers and :meth:`HostKVTier.put` them under
        this node.  Releases the tree's device reference (freeing the
        block — eligibility required refcount 1)."""
        self.pool.release(node.block)
        node.block = TRASH_BLOCK
        node.host = True
        counters.inc("serving.kv.tier.spilled_blocks")

    def mark_restored(self, node, block):
        """Flip a host node back to device residency over a freshly
        allocated ``block`` (the tree takes the allocation's ref).  The
        engine has already copied the tier buffers into the pools; it
        pops the tier entry once the copy has completed."""
        node.block = int(block)
        node.host = False
        node.last_use = next(self._tick)
        counters.inc("serving.kv.tier.restored_blocks")

    def drop_host(self, node):
        """Drop a host-resident node AND its (by the closure invariant,
        all-host) subtree: the fault-injection and tier-overflow exit.
        Tier buffers recycle into the reuse pool; the dropped tokens
        become a plain cache miss, so a request depending on them
        simply re-prefills — deterministic replay, no device blocks to
        reconcile.  Returns nodes dropped."""
        stack, dropped = [node], 0
        while stack:
            nd = stack.pop()
            stack.extend(nd.children.values())
            self._detach(nd)
            if self.tier is not None:
                self.tier.pop(nd)
            counters.inc("serving.kv.tier.spill_drops")
            dropped += 1
        return dropped

    def host_chain(self, tokens, limit):
        """The contiguous host-resident run extending the device match
        for this prompt: returns the host ``_Node`` list, shallowest
        first (restore order).  Touches every node on the path so a
        just-restored run is MRU — the same reservation's shortfall
        handling must not immediately re-spill it."""
        tokens = [int(t) for t in tokens[:max(0, int(limit))]]
        bs = self.pool.block_size
        node, _, cached = self._walk_full(tokens, limit, touch=True)
        chain = []
        while cached + bs <= limit:
            child = node.children.get(tuple(tokens[cached:cached + bs]))
            if child is None or not child.host:
                break
            child.last_use = next(self._tick)
            chain.append(child)
            node = child
            cached += bs
        return chain

    def clear(self):
        """Release every cached block (engine drain/teardown).  Host
        entries hand their buffers back to the tier's reuse pool."""
        leaves = []
        self._leaves(self._root, leaves)
        while leaves:
            for node in leaves:
                self._detach(node)
                if node.host:
                    if self.tier is not None:
                        self.tier.pop(node)
                else:
                    self.pool.release(node.block)
            leaves = []
            self._leaves(self._root, leaves)


class HostKVTier:
    """Host-RAM arena for spilled KV blocks.

    Holds at most ``capacity`` entries; one entry is one block's K/V tiles
    across every layer (a tuple of CPU tensors, plus the fp32 scale rows
    under quantized pools).  Keys are opaque to the tier: the prefix tree
    uses its ``_Node`` objects, the engine ``("req", rid, i)`` tuples for
    idle-request spills.  Overflow is LRU: :meth:`put` returns the
    discarded keys so the owner can reconcile its own maps.

    ``pin_memory=True`` (the engine sets it when its pools are on CUDA)
    allocates page-locked buffers, which an asynchronous host-to-device
    copy can read after the call that queued it returned; allocation
    raises if the host cannot pin, never falling back to pageable memory.
    Buffers come from a reuse pool keyed by (shape, dtype):
    :meth:`acquire` hands back a recycled buffer when one fits (counted
    under ``serving.kv.host_buf_reuse``) and allocates only when the pool
    is dry, growing the ``serving.kv.host_arena_bytes`` gauge.
    """

    def __init__(self, capacity, pin_memory=False):
        if int(capacity) < 1:
            raise ValueError(
                f"host tier capacity must be >= 1 block, got {capacity}")
        self.capacity = int(capacity)
        self.pin_memory = bool(pin_memory)
        self._entries = {}    # key -> tuple[Tensor]; dict order = LRU
        self._freebufs = {}   # (shape, dtype) -> [recycled buffers]
        self._bytes = 0

    @property
    def resident(self):
        """Entries currently held (blocks resident in the tier)."""
        return len(self._entries)

    @property
    def arena_bytes(self):
        """Total host bytes ever allocated (resident + reuse pool)."""
        return self._bytes

    def acquire(self, spec):
        """One host buffer per ``(shape, torch.dtype)`` in ``spec``:
        recycled when available, freshly allocated otherwise."""
        bufs = []
        for shape, dtype in spec:
            pool = self._freebufs.get((tuple(shape), dtype))
            if pool:
                bufs.append(pool.pop())
                counters.inc("serving.kv.host_buf_reuse")
            else:
                buf = torch.empty(tuple(shape), dtype=dtype,
                                  pin_memory=self.pin_memory)
                self._bytes += buf.nbytes
                counters.set_gauge("serving.kv.host_arena_bytes",
                                   self._bytes)
                bufs.append(buf)
        return tuple(bufs)

    def _recycle(self, bufs):
        for buf in bufs:
            self._freebufs.setdefault((tuple(buf.shape), buf.dtype),
                                      []).append(buf)

    def put(self, key, bufs):
        """Insert (or refresh) an entry; returns the keys LRU-discarded to
        stay within ``capacity``.  Their buffers are already recycled;
        the caller reconciles its own bookkeeping."""
        self._entries.pop(key, None)
        self._entries[key] = tuple(bufs)
        dropped = []
        while len(self._entries) > self.capacity:
            old = next(iter(self._entries))
            self._recycle(self._entries.pop(old))
            dropped.append(old)
        return dropped

    def get(self, key):
        """The entry's buffers (MRU-touched), or None.  The buffers stay
        owned by the tier: callers :meth:`pop` only after any device copy
        reading them has completed."""
        bufs = self._entries.pop(key, None)
        if bufs is None:
            return None
        self._entries[key] = bufs
        return bufs

    def pop(self, key):
        """Remove an entry, recycling its buffers.  Tolerant of absent
        keys (overflow may have discarded them first); returns True when
        the key was present."""
        bufs = self._entries.pop(key, None)
        if bufs is None:
            return False
        self._recycle(bufs)
        return True
