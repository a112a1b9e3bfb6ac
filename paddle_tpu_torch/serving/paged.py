"""Paged KV-cache serving engine: block pools + prefix cache + chunked
prefill (port of ``paddle_tpu/serving/paged.py``; constructed by
``LLMEngine(model, kv_layout="paged")``).

KV lives in a shared pool pair ``[L, n_blocks, block_size, nh, hd]`` on
the model's device, and each slot carries a fixed-shape int32 table
mapping its logical block index to a physical pool block:

* **Capacity** — a request reserves only ``ceil((T + max_new - 1)/bs)``
  blocks.  Reservation is all-or-nothing at admission, so decode never
  hits mid-flight exhaustion and a refused admission never tears a table.
* **Prefix sharing** — finished sequences donate their blocks to a radix
  tree (``serving.kvcache.PrefixCache``); a prompt that shares a cached
  prefix adopts those blocks read-only instead of re-prefilling.  A
  shared *partial* block is adopted by **copy-on-write**: it is copied
  into the request's private tail block (``serving.kv.cow_copies``), so
  shared blocks are never mutated.  Unreferenced tree blocks are
  reclaimed LRU (``serving.kv.blocks_evicted``) when the pool runs dry.
* **Chunked prefill** — prompts prefill in bucketed chunks of at most
  ``prefill_chunk`` tokens, one chunk per scheduler step, interleaved with
  the decode launch, so a long prompt never starves another request's
  inter-token latency.
* **Quantized KV** — ``kv_dtype="int8"|"fp8"`` stores the pools one byte
  a value with fp32 per-token scale pools ``[L, n_blocks, bs]`` beside
  them (``serving.kv.quant.*`` gauges and counters).
* **Multi-tenant LoRA** — ``adapter_slots > 0`` builds an
  ``AdapterArena`` (``serving.adapters``); ``add_request(adapter=t)``
  pins tenant ``t``'s factors at admission (a full arena defers the
  request like KV exhaustion) and every prefill/decode call carries the
  rows' adapter slots.  Each tenant's cached prefixes live in a key plane
  of their own (:meth:`PagedLLMEngine._prefix_key`).
* **Host-RAM tier** — ``host_kv_blocks > 0``: cold prefix-tree leaves
  spill to host buffers (pinned when the pools are on CUDA) before the
  pool would evict them, and page back in when a prompt matches them;
  held requests idle past ``spill_idle_steps`` scheduler steps park their
  private blocks there until :meth:`PagedLLMEngine.export_request`.
* **KV migration** — ``add_request(hold_after_prefill=True)`` parks a
  request after its last prefill chunk (state ``"held"``);
  ``export_request`` snapshots its table, ``adopt_migration(mig, src)``
  installs it on another engine over the same device (shared prefix
  blocks adopted by refcount from the destination's own tree, only the
  unshared tail copied) and ``finish_migrated`` releases the source.

On a mesh every rank runs the same engine (``serving.engine``): the LoRA
slabs stay whole on each rank, the host tier's buffers and a
migration's copies hold the rank's own head shard of the pools (the
quantized pools' scale planes, which have no head axis, whole), and the
decisions that move blocks (reservations, spills, restores, adoptions)
read only state every rank shares.  A migration between engines whose
meshes or head splits differ is refused.

The pools are updated in place by the model's ``prefill_paged`` /
``decode_paged``, by the COW copy, by restores and by migration; this
replaces the reference's donation of the pools through every program.
Each decode step copies the host mirrors (tokens, positions, block
tables, adapter slots) to the device once and reads the next tokens back
once.

Telemetry, beyond the slot engine's: the ``serving.kv.block_occupancy``
histogram once a step; flight-recorder events at admission
(``serving.kv.admit``), pool and adapter exhaustion, host-tier moves and
adopts; trace spans ``kv.reserve``, ``cow.adopt``, ``prefill.chunk``,
``decode.iter`` and ``kv.adopt``; a device-time note at each chunk,
decode, COW copy, spill, restore and migration copy.
"""

from __future__ import annotations

import math
import time
import zlib

import numpy as np
import torch

from ..kernels.paged_attention import KV_DTYPES
from ..profiler import counters
from ..profiler import devicetime as _devicetime
from ..profiler import flight, metrics
from ..profiler import trace as rtrace
from ..profiler.host_tracer import span
from ..resilience import faultinject as _fi
from .adapters import AdapterArena, AdapterArenaExhausted
from .engine import (EngineBackpressure, EngineClosed, LLMEngine, Request,
                     bucket_length, prompt_ids)
from .kvcache import (TRASH_BLOCK, BlockPool, BlockPoolExhausted,
                      HostKVTier, HostTierLost, PrefixCache,
                      blocks_for_tokens)
from .sampling import sample_tokens

__all__ = ["PagedLLMEngine"]


class PagedLLMEngine(LLMEngine):
    """``LLMEngine`` over paged block-pool KV.

    Extra knobs:

    * ``block_size`` — tokens per KV block (default 16).
    * ``n_blocks`` — physical pool blocks *including* the reserved trash
      block 0; default ``max_slots * ceil(S_max/bs) + 1``.
    * ``prefill_chunk`` — max tokens prefilled per scheduler step
      (default ``min(S_max, 128)``); chunks are padded to power-of-two
      buckets up to this.
    * ``prefix_cache`` — enable the COW prefix tree (default True).
    * ``kv_dtype`` — ``None`` (the model dtype), ``"int8"`` or ``"fp8"``.
    * ``adapter_slots`` / ``adapter_rank`` — LoRA tenant slots resident
      at once (0: no adapters) and their padded rank (default 8).
    * ``host_kv_blocks`` — host-RAM tier capacity in blocks (default 0:
      no tier).  Requires the prefix cache.
    * ``spill_idle_steps`` — scheduler steps a held request sits idle
      before its private KV spills to the host tier (default 0: never).
    """

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.hists["serving.kv.block_occupancy"] = metrics.Histogram(
            "serving.kv.block_occupancy", "frac")

    def _prog_key(self, base):
        """A dispatch's device-time name: ``base``, then ``@<kv_dtype>``
        for quantized pools and ``+lora<rank>`` with adapters."""
        kv = f"@{self.kv_dtype}" if self.kv_dtype else ""
        lo = f"+lora{self.adapter_rank}" if self.adapters is not None else ""
        return f"{base}{kv}{lo}"

    def _init_kv(self, c, B, S, nh, hd):
        bs = self.block_size
        if not 1 <= bs <= S:
            raise ValueError(f"block_size {bs} outside [1, {S}]")
        self.max_blocks = blocks_for_tokens(S, bs)
        if self.n_blocks is None:
            self.n_blocks = B * self.max_blocks + 1
        self.n_blocks = int(self.n_blocks)
        if self.prefill_chunk is None:
            self.prefill_chunk = min(S, 128)
        self.prefill_chunk = max(int(self.prefill_chunk), self.min_bucket)
        self.pool = BlockPool(self.n_blocks, bs, kv_dtype=self.kv_dtype)
        self.prefix = PrefixCache(self.pool) if self.prefix_caching else None
        shape = (c.num_layers, self.n_blocks, bs, nh, hd)
        dt = self.model.wte.dtype
        adt = KV_DTYPES[self.kv_dtype] if self.kv_dtype else dt
        # this rank's heads under a mesh (the arena splits them)
        self.pool_k = self._kv_zeros("pool_k", shape, adt)
        self.pool_v = self._kv_zeros("pool_v", shape, adt)
        shape = self.pool_k.shape
        nh = shape[3]
        # per-token fp32 scales at the same (layer, block, position) as the
        # quantized tiles (no head axis: replicated on a mesh); empty
        # tuple for unquantized pools
        self.scales = ()
        if self.kv_dtype:
            self.scales = tuple(
                self.arena.declare_zeros(n, shape[:3], torch.float32,
                                         self.device)
                for n in ("scale_k", "scale_v"))
            raw = 2 * math.prod(shape) * dt.itemsize
            quant = self._pool_bytes()
            counters.set_gauge("serving.kv.quant.arena_bytes", quant)
            counters.set_gauge("serving.kv.quant.bytes_saved",
                               max(raw - quant, 0))
        # per-slot block tables (host mirror; copied to the device per step)
        self._bt = np.zeros((B, self.max_blocks), np.int32)
        self._running = np.zeros(B, np.bool_)
        self._slot_blocks = [None] * B
        self._prefill_state = {}      # slot -> {"req": Request, "done": n}
        # host-RAM KV tier: cold prefix leaves and idle held requests spill
        # their blocks into host buffers (pinned when the pools are on
        # CUDA) and page back on demand; the tree's nodes key the entries
        self._host_tier = (HostKVTier(self.host_kv_blocks,
                                      pin_memory=self.device.type == "cuda")
                           if self.host_kv_blocks > 0
                           and self.prefix is not None else None)
        if self.prefix is not None:
            self.prefix.tier = self._host_tier
        # one host buffer spec per block: K/V tiles (+ scale rows)
        spec = [((c.num_layers, bs, nh, hd), adt)] * 2
        if self.kv_dtype:
            spec += [((c.num_layers, bs), torch.float32)] * 2
        self._host_spec = tuple(spec)
        self._req_host = {}    # rid -> {"idx": set[int], "lost": bool}
        self._held_idle = {}   # rid -> idle scheduler steps while held
        self.adapters = (AdapterArena(self.model, self.adapter_slots,
                                      self.adapter_rank,
                                      tp=self._w.get("tp"))
                         if self.adapter_slots > 0 else None)
        if self.adapters is not None:
            # on a mesh, the cut of the slabs this rank's shards meet
            self.arena.declare("adapters", self.adapters.slabs())
        # per-slot adapter arena row (host mirror; 0 = the base model)
        self._aid = np.zeros(B, np.int32)
        # per-engine prefix-cache accounting (the same events also feed
        # the process-global counters registry)
        self.kv_prefix_hits = 0
        self.kv_prefix_misses = 0
        self.kv_prefix_hit_tokens = 0
        self.kv_cow_copies = 0
        self.kv_blocks_evicted = 0
        self.kv_pool_exhausted_events = 0
        self.kv_tier_spilled = 0
        self.kv_tier_restored = 0

    def release_kv(self):
        self.pool_k = self.pool_v = None
        self.scales = ()
        self.arena.release("pool_k", "pool_v", "scale_k", "scale_v",
                           "adapters")
        if self.adapters is not None:
            self.adapters.release_slabs()

    def _pools(self):
        """The device tensors a block's KV lives in: K, V and, for
        quantized pools, their scale pools."""
        return (self.pool_k, self.pool_v, *self.scales)

    def _pool_bytes(self):
        return sum(t.nbytes for t in self._pools() if t is not None)

    def _copy_block(self, src, dst, nvalid):
        """Copy-on-write block clone: ``dst[:nvalid] = src[:nvalid]``,
        zeros beyond, in every layer of both pools and of the scale
        pools."""
        _dt = _devicetime.note(f"serving.kv.{self._prog_key('copy_block')}")
        for pool in self._pools():
            pool[:, dst, :nvalid] = pool[:, src, :nvalid]
            pool[:, dst, nvalid:] = 0
        _devicetime.observe(_dt, self.pool_k)

    # -- adapters and prefix views -------------------------------------------
    def register_adapter(self, tenant, factors):
        """Stage ``tenant``'s LoRA factors host-side
        (:meth:`AdapterArena.register`); they page into the arena on the
        tenant's first admission."""
        if self.adapters is None:
            raise ValueError("engine was built with adapter_slots=0")
        with self._cond:
            self.adapters.register(tenant, factors)

    def adapter_peek(self, tenant):
        if self.adapters is None or tenant is None:
            return 0
        with self._cond:
            return self.adapters.peek(tenant)

    @staticmethod
    def _prefix_key(tokens, tenant):
        """Tenant-salted token list for the prefix tree.  KV computed
        under a LoRA adapter is not base KV for the same tokens, so each
        tenant's cached prefixes live in a disjoint key plane: every
        token is offset by ``(crc32(tenant) + 1) << 32``, above any vocab
        id (block alignment kept; base traffic stays unsalted).  The
        tokens are Python ints: the salt would wrap an int32/int64
        array and let tenants share KV."""
        if tenant is None:
            return tokens
        salt = (zlib.crc32(str(tenant).encode("utf-8")) + 1) << 32
        return [int(t) + salt for t in tokens]

    def prefix_peek(self, prompt, tenant=None):
        """Tokens of ``prompt`` the prefix cache could serve without
        prefilling (read-only), in ``tenant``'s key plane."""
        if self.prefix is None:
            return 0
        ids = prompt_ids(prompt)
        with self._cond:
            return self.prefix.peek(self._prefix_key(ids.tolist(), tenant),
                                    int(ids.shape[0]) - 1)

    def prefix_probe(self, prompt, tenant=None):
        """``(device_tokens, host_tokens)`` the prefix cache could serve
        for this prompt in ``tenant``'s key plane: host tokens pay a
        page-in first."""
        if self.prefix is None:
            return 0, 0
        ids = prompt_ids(prompt)
        with self._cond:
            return self.prefix.probe(self._prefix_key(ids.tolist(), tenant),
                                     int(ids.shape[0]) - 1)

    # -- host-RAM KV tier ----------------------------------------------------
    # All helpers below run with ``_cond`` held by the caller: spill and
    # restore are part of atomic reservation / export transitions, as the
    # COW copy and the migration adopt are.
    def _spill_block(self, block):
        """Device-to-host copy of ONE block into reuse-pool buffers
        (returned).  The copy is synchronous, so the device block may be
        released the moment this returns."""
        bufs = self._host_tier.acquire(self._host_spec)
        _dt = _devicetime.note(f"serving.kv.{self._prog_key('spill_block')}")
        for buf, pool in zip(bufs, self._pools()):
            buf.copy_(pool[:, block])
        _devicetime.observe(_dt, self.pool_k)
        return bufs

    def _restore_block(self, block, bufs):
        """Host-to-device copy of one tier entry into ``block``, queued
        asynchronously from pinned buffers on CUDA: the buffers are read
        after this returns, so callers :meth:`_restores_done` before they
        recycle them."""
        _dt = _devicetime.note(
            f"serving.kv.{self._prog_key('restore_block')}")
        for pool, buf in zip(self._pools(), bufs):
            pool[:, block].copy_(buf, non_blocking=True)
        _devicetime.observe(_dt, self.pool_k)

    def _restores_done(self):
        """Wait for the restores queued so far (a CUDA event recorded
        after them); a CPU copy was synchronous already."""
        if self.device.type == "cuda":
            ev = torch.cuda.Event()
            ev.record()
            ev.synchronize()

    def _drop_host_key(self, key):
        """Reconcile bookkeeping for a key the tier LRU-discarded: a
        prefix node drops its (all-host) subtree; a spilled request's
        block marks its spill set lost, so export raises
        :class:`HostTierLost` instead of restoring."""
        if isinstance(key, tuple) and key and key[0] == "req":
            ent = self._req_host.get(key[1])
            if ent is not None:
                ent["idx"].discard(key[2])
                ent["lost"] = True
            counters.inc("serving.kv.tier.spill_drops")
        else:
            self.prefix.drop_host(key)

    def _spill_cold(self, want):
        """Spill up to ``want`` cold prefix-tree blocks to the host tier,
        coldest first, freeing their device blocks.  Runs BEFORE LRU
        eviction on a shortfall, so oversubscription demotes prefixes
        instead of destroying them.  Returns blocks freed."""
        freed = 0
        while freed < want:
            victims = self.prefix.spill_victims(want - freed)
            if not victims:
                break
            for v in victims:
                bufs = self._spill_block(v.block)
                self.prefix.mark_spilled(v)
                self.kv_tier_spilled += 1
                for k in self._host_tier.put(v, bufs):
                    self._drop_host_key(k)
                freed += 1
        return freed

    def _restore_prefix(self, tokens, limit, rid):
        """Page the host-resident chain extending this prompt's device
        match back into fresh device blocks, so the following
        ``PrefixCache.match`` adopts them like any cached prefix.  Under
        the ``kv_spill_drop`` fault the chain's host copies are dropped
        instead: the prompt becomes a plain miss and its prefill is the
        replay.  Returns blocks restored."""
        chain = self.prefix.host_chain(tokens, limit)
        if not chain:
            return 0
        if _fi.take("kv_spill_drop", rid):
            dropped = self.prefix.drop_host(chain[0])
            flight.record("serving.kv.tier.spill_drop", rid=rid,
                          nodes=dropped, where="prefix_restore")
            return 0
        restored = []
        for node in chain:
            bufs = self._host_tier.get(node)
            if bufs is None:
                # overflow discarded the entry between walk and get: the
                # rest of the chain is a miss now
                self.prefix.drop_host(node)
                break
            if self.pool.free_blocks == 0:
                self.prefix.evict(1)
                if self.pool.free_blocks == 0:
                    break
            block = self.pool.alloc()
            self._restore_block(block, bufs)
            self.prefix.mark_restored(node, block)
            self.kv_tier_restored += 1
            restored.append(node)
        if restored:
            # one wait for the whole chain, then recycle its buffers
            self._restores_done()
            for node in restored:
                self._host_tier.pop(node)
        return len(restored)

    def _maybe_spill_idle(self):
        """Held requests that sit idle past ``spill_idle_steps``
        scheduler steps spill their private KV to the host tier;
        ``export_request`` pages it back.  One sweep per :meth:`step`."""
        if self._host_tier is None or self.spill_idle_steps <= 0:
            return
        with self._cond:
            live = {r.rid: (s, r) for s, r in enumerate(self._slots)
                    if r is not None and r.state == "held"
                    and r.rid not in self._req_host}
            self._held_idle = {rid: self._held_idle.get(rid, 0) + 1
                               for rid in live}
            for rid, steps in list(self._held_idle.items()):
                if steps >= self.spill_idle_steps:
                    slot, req = live[rid]
                    self._spill_request(slot, req)
                    del self._held_idle[rid]

    def _spill_request(self, slot, req):
        """Move a held request's PRIVATE data blocks (refcount 1, below
        the write frontier) to the host tier and trash their table
        entries; shared prefix blocks stay on the device.  The freed
        blocks fund new admissions while the request waits.  Caller holds
        ``_cond``."""
        table = self._slot_blocks[slot]
        pos = int(self._pos[slot])
        n_data = blocks_for_tokens(max(pos, 1), self.pool.block_size)
        ent = {"idx": set(), "lost": False}
        for i in range(n_data):
            b = table[i]
            if b == TRASH_BLOCK or self.pool.ref(b) != 1:
                continue
            bufs = self._spill_block(b)
            for k in self._host_tier.put(("req", req.rid, i), bufs):
                self._drop_host_key(k)
            self.pool.release(b)
            table[i] = TRASH_BLOCK
            self._bt[slot, i] = 0
            ent["idx"].add(i)
            counters.inc("serving.kv.tier.spilled_blocks")
            self.kv_tier_spilled += 1
        if ent["idx"]:
            self._req_host[req.rid] = ent
            flight.record("serving.kv.tier.req_spilled", rid=req.rid,
                          blocks=len(ent["idx"]))

    def _restore_request(self, req):
        """Page a spilled held request's KV back into fresh device blocks,
        so :meth:`export_request` snapshots a fully device-resident table.
        Raises :class:`HostTierLost` when the host copy is gone (tier
        overflow or the ``kv_spill_drop`` fault) and
        ``EngineBackpressure`` when the pool cannot host the restore yet
        (partial progress is kept; a later export resumes).  Caller holds
        ``_cond``."""
        ent = self._req_host.get(req.rid)
        if ent is None:
            return
        slot = req.slot
        table = self._slot_blocks[slot]
        if ent["lost"] or _fi.take("kv_spill_drop", req.rid):
            for i in list(ent["idx"]):
                self._host_tier.pop(("req", req.rid, i))
                counters.inc("serving.kv.tier.spill_drops")
            del self._req_host[req.rid]
            flight.record("serving.kv.tier.spill_drop", rid=req.rid,
                          nodes=len(table), where="request_restore")
            raise HostTierLost(
                f"request {req.rid}: spilled KV lost before restore")
        restored, err = [], None
        for i in sorted(ent["idx"]):
            bufs = self._host_tier.get(("req", req.rid, i))
            if bufs is None:
                ent["lost"] = True
                break
            if self.pool.free_blocks == 0 and self.prefix is not None:
                self.prefix.evict(1)
            if self.pool.free_blocks == 0:
                err = EngineBackpressure(
                    "host-tier restore needs free blocks",
                    queue_depth=len(self._queue),
                    retry_after_hint=self._retry_hint_locked())
                break
            b = self.pool.alloc()
            self._restore_block(b, bufs)
            table[i] = b
            self._bt[slot, i] = b
            restored.append(i)
        if restored:
            self._restores_done()
            for i in restored:
                ent["idx"].discard(i)
                self._host_tier.pop(("req", req.rid, i))
            counters.inc("serving.kv.tier.restored_blocks", len(restored))
            self.kv_tier_restored += len(restored)
        if ent["lost"]:
            for i in list(ent["idx"]):
                self._host_tier.pop(("req", req.rid, i))
                counters.inc("serving.kv.tier.spill_drops")
            del self._req_host[req.rid]
            raise HostTierLost(
                f"request {req.rid}: spilled KV lost mid-restore")
        if err is not None:
            raise err
        del self._req_host[req.rid]
        flight.record("serving.kv.tier.req_restored", rid=req.rid,
                      blocks=len(restored))

    # -- request intake ------------------------------------------------------
    def add_request(self, prompt, max_new_tokens=32, **kw):
        tenant = kw.get("adapter")
        if tenant is not None:
            # refuse unregistered tenants here, synchronously: admission
            # runs inside step(), where the error would reach no caller
            if self.adapters is None:
                raise ValueError("adapter given but the engine was "
                                 "built with adapter_slots=0")
            with self._cond:
                if tenant not in self.adapters._registry:
                    raise KeyError(
                        f"adapter {tenant!r} is not registered on this "
                        "engine (register_adapter first)")
        ids = prompt_ids(prompt)
        need = blocks_for_tokens(
            max(1, int(ids.shape[0]) + int(max_new_tokens) - 1),
            self.pool.block_size)
        if need > self.pool.capacity:
            raise ValueError(
                f"request needs {need} KV blocks but the pool only has "
                f"{self.pool.capacity} (n_blocks={self.n_blocks}, "
                f"block_size={self.pool.block_size})")
        return super().add_request(ids, max_new_tokens=max_new_tokens, **kw)

    # -- admission: all-or-nothing block reservation -------------------------
    def _reserve(self, req, events):
        """Pin the request's adapter, match the prefix cache (paging a
        host-resident run back in first), then reserve every block the
        request can ever touch (``ceil((T + max_new - 1)/bs)`` minus
        shared prefix blocks).  Returns False, with NOTHING allocated and
        no table mutated, when the adapter arena or the pool (after
        spilling and LRU eviction) cannot cover it, or when the
        ``kv_pool_exhausted`` fault is scheduled for this request id."""
        T = int(req.prompt.shape[0])
        bs = self.pool.block_size
        total = blocks_for_tokens(max(1, T + req.max_new_tokens - 1), bs)
        tr = req.trace
        t0_tr = time.perf_counter_ns() if tr is not None else 0
        with self._cond:
            injected = _fi.take("kv_pool_exhausted", req.rid)
            aslot = 0
            if self.adapters is not None and req.adapter is not None:
                # a full arena or an injected adapter_load_drop defers the
                # request exactly as KV exhaustion does
                try:
                    aslot = self.adapters.acquire(req.adapter, rid=req.rid)
                except AdapterArenaExhausted as e:
                    flight.record("serving.adapter.exhausted",
                                  rid=req.rid, tenant=str(req.adapter),
                                  needed=e.needed, free=e.free)
                    return False
            shared, cached, pnode, p = [], 0, None, 0
            if self.prefix is not None and not injected:
                pkey = self._prefix_key(req.prompt.tolist(), req.adapter)
                if self._host_tier is not None:
                    self._restore_prefix(pkey, T - 1, req.rid)
                shared, cached, pnode, p = self.prefix.match(pkey, T - 1)
            fresh_needed = total - len(shared)
            shortfall = fresh_needed - self.pool.free_blocks
            if shortfall > 0 and self.prefix is not None:
                if self._host_tier is not None:
                    # spill before evict: demote cold prefixes to host RAM
                    self._spill_cold(shortfall)
                    shortfall = fresh_needed - self.pool.free_blocks
                if shortfall > 0:
                    self.kv_blocks_evicted += self.prefix.evict(shortfall)
                    shortfall = fresh_needed - self.pool.free_blocks
            if injected or shortfall > 0:
                for b in shared:
                    self.pool.release(b)
                if pnode is not None:
                    self.pool.release(pnode.block)
                if aslot:
                    # the tenant stays resident at refcount 0, warm for
                    # the retry
                    self.adapters.release(req.adapter)
                self.kv_pool_exhausted_events += 1
                counters.inc("serving.kv.pool_exhausted")
                flight.record("serving.kv.pool_exhausted", rid=req.rid,
                              needed=fresh_needed,
                              free=self.pool.free_blocks,
                              injected=bool(injected))
                return False
            fresh = self.pool.alloc_n(fresh_needed)
            table = shared + fresh
            slot = self._free.pop()
            if tr is not None:
                tr.add_span("kv.reserve", t0_tr, time.perf_counter_ns(),
                            blocks=len(table), shared=len(shared),
                            cached=cached)
            if pnode is not None:
                # copy-on-write: clone the shared partial block into the
                # request's first private tail block before extending it
                t0_cow = time.perf_counter_ns() if tr is not None else 0
                self._copy_block(pnode.block, table[len(shared)], p)
                if tr is not None:
                    tr.add_span("cow.adopt", t0_cow,
                                time.perf_counter_ns(), tokens=p)
                self.pool.release(pnode.block)   # drop the match retain
                cached += p
                self.kv_cow_copies += 1
                counters.inc("serving.kv.cow_copies")
            if cached > 0:
                self.kv_prefix_hits += 1
                self.kv_prefix_hit_tokens += cached
                counters.inc("serving.kv.prefix_hits")
                counters.inc("serving.kv.prefix_hit_tokens", cached)
            else:
                self.kv_prefix_misses += 1
                counters.inc("serving.kv.prefix_misses")
            self._slot_blocks[slot] = table
            self._bt[slot] = 0
            self._bt[slot, :len(table)] = table
            self._aid[slot] = aslot
            self._running[slot] = False
            req.state = "prefilling"
            req.slot = slot
            if req.do_sample:
                req.generator = torch.Generator(
                    device=self.device).manual_seed(req.seed)
            self._slots[slot] = req
            self._prefill_state[slot] = {"req": req, "done": cached}
        flight.record("serving.kv.admit", rid=req.rid, blocks=len(table),
                      shared=len(shared), cached_tokens=cached)
        events.append({"type": "admitted", "request": req})
        return True

    def _admit(self, events):
        now = time.monotonic()
        while self._free:
            with self._cond:
                if not self._queue:
                    return
                req = self._queue.popleft()
                self._cond.notify()
            if req._cancel:
                self._finish(req, "cancelled", events)
                continue
            if self._past_deadline(req, now):
                counters.inc("serving.deadline_expired")
                self._finish(req, "deadline", events)
                continue
            if not self._reserve(req, events):
                # pool or adapter arena exhausted (real or injected): park
                # the request back at the queue head and stop admitting
                # this step; blocks free as running requests finish
                with self._cond:
                    self._queue.appendleft(req)
                return
            self._observe("serving.queue_wait_ns",
                          time.monotonic_ns() - req.arrival_ns,
                          sum_counter=True)
            if req.trace is not None:
                req.trace.span_from("enqueue", "queue")

    def _adapter_args(self, aids):
        """``(adapters, adapter_ids)`` keywords of a model call over rows
        whose adapter slots are ``aids`` (empty without an arena)."""
        if self.adapters is None:
            return {}
        return {"adapters": self.adapters.slabs(),
                "adapter_ids": torch.from_numpy(
                    np.ascontiguousarray(aids, np.int64)).to(self.device)}

    # -- chunked prefill, interleaved with decode ----------------------------
    def _run_chunk(self, slot, st, events):
        req = st["req"]
        T = int(req.prompt.shape[0])
        start = st["done"]
        remaining = T - start
        C = bucket_length(min(remaining, self.prefill_chunk),
                          self.min_bucket, self.prefill_chunk)
        take_n = min(remaining, C)
        last = start + take_n == T
        ids = np.zeros((1, C), np.int64)
        ids[0, :take_n] = req.prompt[start:start + take_n]
        self._observe("serving.prefill_occupancy", take_n / C)
        tr = req.trace
        t0_tr = time.perf_counter_ns() if tr is not None else 0
        dev = self.device
        with span("serving.prefill"):
            _dt = _devicetime.note(
                f"serving.{self._prog_key('prefill_paged')}[c{C}]")
            logits = self.model.prefill_paged(
                self._w, torch.from_numpy(ids).to(dev), start, take_n,
                torch.from_numpy(self._bt[slot]).to(dev), *self._pools(),
                **self._adapter_args(self._aid[slot:slot + 1]))
            _devicetime.observe(_dt, logits)
        if tr is not None:
            tr.add_span("prefill.chunk", t0_tr, time.perf_counter_ns(),
                        chunk=C, start=start, take=take_n)
        counters.inc("serving.kv.prefill_chunks")
        if self.kv_dtype:
            counters.inc("serving.kv.quant.prefill_tokens", take_n)
        st["done"] = start + take_n
        if last:
            # only the final chunk's logits are sampled: the first token
            tok = int(self._agree(sample_tokens(
                logits, req.generator, do_sample=req.do_sample,
                temperature=req.temperature, top_k=req.top_k,
                top_p=req.top_p))[0])
            del self._prefill_state[slot]
            counters.inc("serving.prefill_batches")
            self._tok[slot] = tok
            self._pos[slot] = T
            if req.hold:
                # the KV-migration hand-off point: the row parks instead
                # of decoding (_running stays False, so decode tables it
                # to the trash block) until export_request; its first
                # token is emitted here, and may finish the request
                req.state = "held"
                self._emit(req, tok, events)
                if req.state == "held":
                    events.append({"type": "prefilled", "request": req})
            else:
                req.state = "running"
                self._running[slot] = True
                self._emit(req, tok, events)

    def _prefill_chunks(self, events):
        """One chunk per prefilling slot per step (round-robin in slot
        order): a long prompt advances ``prefill_chunk`` tokens per
        scheduler iteration while every running request still gets its
        decode token."""
        for slot in sorted(self._prefill_state):
            st = self._prefill_state.get(slot)
            if st is None or st["req"].is_finished:
                continue
            req = st["req"]
            try:
                _fi.maybe_fault("serving_prefill", req.rid)
                self._run_chunk(slot, st, events)
            except Exception as e:  # noqa: BLE001 — the scheduler boundary
                # a poisoned prefill finishes THIS request with
                # finish_reason="error" and frees its slot + blocks; the
                # exception rides the request for the caller to inspect
                req.error = e
                counters.inc("serving.request_errors")
                self._finish(req, "error", events)

    # -- decode over block tables --------------------------------------------
    def _decode_step(self, events):
        active = [(s, r) for s, r in enumerate(self._slots)
                  if r is not None and r.state == "running"]
        if not active:
            return
        self._observe("serving.decode_occupancy",
                      len(active) / self.max_slots)
        # non-running rows (idle, mid-prefill or held) are tabled to the
        # trash block at position 0 on the base row, so every launch has
        # the same shapes
        bt_eff = np.where(self._running[:, None], self._bt, 0).astype(
            np.int32)
        pos_eff = np.where(self._running, self._pos, 0).astype(np.int32)
        t0 = time.perf_counter()
        t0_tr = time.perf_counter_ns() if rtrace.enabled() else 0
        dev = self.device
        with span("serving.decode"):
            _dt = _devicetime.note(
                f"serving.{self._prog_key('decode_paged')}")
            logits = self.model.decode_paged(
                self._w, torch.from_numpy(self._tok).to(dev),
                torch.from_numpy(pos_eff).to(dev),
                torch.from_numpy(bt_eff).to(dev), *self._pools(),
                **self._adapter_args(np.where(self._running, self._aid, 0)))
            _devicetime.observe(_dt, logits)
            nxt = self._next_tokens(logits, active)
        self._trace_decode(active, t0_tr)
        self._note_decode(len(active), time.perf_counter() - t0)
        counters.inc("serving.decode_steps")
        counters.inc("serving.decode_tokens", len(active))
        if self.kv_dtype:
            counters.inc("serving.kv.quant.decode_tokens", len(active))
        for s, req in active:
            self._tok[s] = nxt[s]
            self._pos[s] += 1
            self._emit(req, nxt[s], events)

    # -- KV migration ----------------------------------------------------------
    def export_request(self, req):
        """Snapshot a held request's migration payload: block table,
        decode state and committed tokens.  No device copy and no
        mutation (beyond paging a spilled request back in), so the source
        stays intact until :meth:`finish_migrated` and a severed
        migration loses nothing.  KV is valid for positions ``[0, pos)``;
        the last committed token (``tok``) was sampled but never written
        back, as in a prefix-tree donation.  A sampled request carries
        its generator's state."""
        with self._cond:
            slot = req.slot
            if slot is None or req.state != "held":
                raise RuntimeError(
                    f"request {req.rid} is not held for migration "
                    f"(state={req.state!r})")
            if self._host_tier is not None:
                # raises HostTierLost / EngineBackpressure; nothing torn
                self._restore_request(req)
            return {
                "prompt": req.prompt,
                "tokens": list(req.tokens),
                "max_new_tokens": req.max_new_tokens,
                "do_sample": req.do_sample,
                "temperature": req.temperature,
                "top_k": req.top_k,
                "top_p": req.top_p,
                "eos_token_id": req.eos_token_id,
                "seed": req.seed,
                # the seconds left, so another process's clock (the
                # adopting engine's) does not shift the deadline
                "deadline_left_s": (None if req.deadline is None
                                    else req.deadline - time.monotonic()),
                "arrival_ns": req.arrival_ns,
                "last_emit_ns": req.last_emit_ns,
                "tok": int(self._tok[slot]),
                "pos": int(self._pos[slot]),
                "generator_state": (None if req.generator is None
                                    else req.generator.get_state()),
                "table": list(self._slot_blocks[slot]),
                "block_size": self.pool.block_size,
                "kv_dtype": self.kv_dtype,
                "adapter": req.adapter,
            }

    def _kv_split(self):
        """``(mp degree, this rank's mp index, heads held)``: what a
        migration's block copies assume the two engines share (no mesh
        and a mesh of one rank hold the same whole pools)."""
        mesh = self.arena.mesh
        if mesh is None:
            return (1, 0, int(self.pool_k.shape[3]))
        return (mesh.degree("mp"), mesh.index("mp"),
                int(self.pool_k.shape[3]))

    def _migrate_blocks(self, src, src_ids, dst_ids):
        """Copy blocks ``src_ids`` of ``src``'s pools into this engine's
        blocks ``dst_ids``, in every layer of K, V and the scale pools:
        one gather and one scatter a pool, live ids only (the trash block
        is never written)."""
        dev = self.device
        si = torch.tensor(src_ids, dtype=torch.long, device=dev)
        di = torch.tensor(dst_ids, dtype=torch.long, device=dev)
        _dt = _devicetime.note(
            f"serving.kv.{self._prog_key('migrate_blocks')}")
        for dst, s in zip(self._pools(), src._pools()):
            dst.index_copy_(1, di, s.index_select(1, si))
        _devicetime.observe(_dt, self.pool_k)

    def adopt_migration(self, mig, src, trace_ctx=None):
        """Install a migrated request on THIS engine (the decode side of
        the hand-off; ``src`` is the exporting engine, on the same
        device).  The prefix is re-resolved against this engine's own
        radix tree: full data blocks already cached here are adopted by
        refcount (``PrefixCache.match_full``), and only the unshared tail
        of the source table is copied.  Raises ``EngineBackpressure`` /
        ``BlockPoolExhausted`` with NOTHING allocated when this engine
        cannot host the request.

        Returns ``(request, info)``: the installed request is already
        ``"running"`` with the migrated tokens in its stream, so its next
        token continues the source's.  ``trace_ctx`` (the fleet handle's
        trace) rides the installed request and gets a ``kv.adopt``
        span."""
        if (self.pool.block_size != mig["block_size"]
                or self.kv_dtype != mig["kv_dtype"]):
            raise ValueError(
                "KV migration between incompatible paged engines "
                f"(block_size {self.pool.block_size} vs "
                f"{mig['block_size']}, kv_dtype {self.kv_dtype!r} vs "
                f"{mig['kv_dtype']!r})")
        if src.device != self.device:
            raise ValueError(f"KV migration from {src.device} to "
                             f"{self.device}: both engines must share a "
                             "device")
        if src._kv_split() != self._kv_split():
            raise ValueError(
                "KV migration between engines of different meshes or head "
                f"splits (source {src._kv_split()}, destination "
                f"{self._kv_split()}: mp degree, this rank's mp index, "
                "heads held)")
        bs = self.pool.block_size
        pos = int(mig["pos"])
        total = len(mig["table"])
        if total > self.max_blocks:
            raise ValueError(
                f"migrated table ({total} blocks) exceeds this engine's "
                f"max_blocks ({self.max_blocks})")
        n_data = blocks_for_tokens(max(pos, 1), bs)
        seq = np.concatenate(
            [mig["prompt"], np.asarray(mig["tokens"], np.int32)])[:pos]
        t0_tr = time.perf_counter_ns() if trace_ctx is not None else 0
        with self._cond:
            if self._closed:
                raise EngineClosed("engine is drained; cannot adopt")
            if not self._free:
                raise EngineBackpressure(
                    "no free decode slot for migration",
                    queue_depth=len(self._queue),
                    retry_after_hint=self._retry_hint_locked())
            mig_ad = mig.get("adapter")
            aslot = 0
            if mig_ad is not None:
                # re-acquired by tenant name against THIS engine's arena;
                # factors never ride the payload
                if self.adapters is None:
                    raise ValueError(
                        f"migrated request carries adapter {mig_ad!r} "
                        "but this engine was built with adapter_slots=0")
                try:
                    aslot = self.adapters.acquire(mig_ad)
                except (AdapterArenaExhausted, KeyError) as e:
                    raise EngineBackpressure(
                        f"adapter arena cannot host migrated tenant "
                        f"{mig_ad!r}: {e}",
                        queue_depth=len(self._queue),
                        retry_after_hint=self._retry_hint_locked()) from e
            shared, cached = [], 0
            if self.prefix is not None:
                pkey = self._prefix_key(seq.tolist(), mig_ad)
                if self._host_tier is not None:
                    self._restore_prefix(pkey, (pos // bs) * bs, -1)
                # only whole blocks strictly below the write frontier are
                # shareable: the block holding position ``pos`` is written
                # by the next decode step and must stay private
                shared, cached = self.prefix.match_full(pkey,
                                                        (pos // bs) * bs)
            n_shared = len(shared)
            fresh_needed = total - n_shared
            shortfall = fresh_needed - self.pool.free_blocks
            if shortfall > 0 and self.prefix is not None:
                if self._host_tier is not None:
                    self._spill_cold(shortfall)
                    shortfall = fresh_needed - self.pool.free_blocks
                if shortfall > 0:
                    self.kv_blocks_evicted += self.prefix.evict(shortfall)
                    shortfall = fresh_needed - self.pool.free_blocks
            if shortfall > 0:
                for b in shared:
                    self.pool.release(b)
                if aslot:
                    self.adapters.release(mig_ad)
                self.kv_pool_exhausted_events += 1
                counters.inc("serving.kv.pool_exhausted")
                flight.record("serving.kv.pool_exhausted",
                              migration=True, needed=fresh_needed,
                              free=self.pool.free_blocks)
                raise BlockPoolExhausted(
                    f"migration needs {fresh_needed} blocks, "
                    f"{self.pool.free_blocks} free",
                    needed=fresh_needed, free=self.pool.free_blocks)
            fresh = self.pool.alloc_n(fresh_needed)
            table = shared + fresh
            n_copy = n_data - n_shared
            if n_copy > 0:
                self._migrate_blocks(src, mig["table"][n_shared:n_data],
                                     table[n_shared:n_data])
            if cached > 0:
                self.kv_prefix_hits += 1
                self.kv_prefix_hit_tokens += cached
                counters.inc("serving.kv.prefix_hits")
                counters.inc("serving.kv.prefix_hit_tokens", cached)
            else:
                self.kv_prefix_misses += 1
                counters.inc("serving.kv.prefix_misses")
            req = Request(next(self._rid), mig["prompt"],
                          int(mig["max_new_tokens"]), bool(mig["do_sample"]),
                          float(mig["temperature"]), int(mig["top_k"]),
                          float(mig["top_p"]), mig["eos_token_id"],
                          int(mig["seed"]),
                          (None if mig["deadline_left_s"] is None
                           else time.monotonic() + mig["deadline_left_s"]),
                          self)
            req.tokens = list(mig["tokens"])
            req.arrival_ns = mig["arrival_ns"]
            req.last_emit_ns = mig["last_emit_ns"]
            req.trace = trace_ctx
            req.adapter = mig_ad
            if mig["generator_state"] is not None:
                req.generator = torch.Generator(device=self.device)
                req.generator.set_state(mig["generator_state"])
            req.state = "running"
            slot = self._free.pop()
            req.slot = slot
            self._slots[slot] = req
            self._slot_blocks[slot] = table
            self._bt[slot] = 0
            self._bt[slot, :len(table)] = table
            self._aid[slot] = aslot
            self._running[slot] = True
            self._tok[slot] = int(mig["tok"])
            self._pos[slot] = pos
            self._outstanding += max(0, req.max_new_tokens - len(req.tokens))
            self._adopt_extra(slot, req, mig)
            if self.prefix is not None and pos // bs > 0:
                # the migrated prefix enters THIS tree at once: blocks
                # below the write frontier are never written again, so the
                # next same-prefix prompt or migration shares them
                n_full = pos // bs
                self.prefix.insert(
                    self._prefix_key(seq[:n_full * bs].tolist(), mig_ad),
                    table[:n_full])
        info = {"blocks_copied": n_copy, "blocks_shared": n_shared,
                "tokens": pos, "blocks_total": total}
        if trace_ctx is not None:
            trace_ctx.add_span("kv.adopt", t0_tr, time.perf_counter_ns(),
                               **info)
        flight.record("serving.kv.adopt", rid=req.rid, **info)
        return req, info

    def _adopt_extra(self, slot, req, mig):
        """Subclass hook: rebuild engine-local state the migration payload
        does not carry (the speculative engine re-prefills its draft
        namespace here).  Caller holds ``_cond``."""

    def finish_migrated(self, req):
        """Source-side release after the destination adopted (or the
        caller abandoned) a migration: finish the held request with
        reason ``"migrated"``; ``_release_slot_kv`` donates its blocks to
        THIS engine's prefix tree and drops every table reference."""
        done = self._finish(req, "migrated", [])
        req.tag = None
        return done

    # -- eviction / teardown -------------------------------------------------
    def _release_slot_kv(self, slot, req, reason):
        """Free a finished request's table: donate the sequence's blocks
        to the prefix tree (when prefill completed cleanly), then drop
        the request's references.  Caller holds ``_cond``."""
        table = self._slot_blocks[slot]
        self._slot_blocks[slot] = None
        st = self._prefill_state.pop(slot, None)
        self._running[slot] = False
        self._bt[slot] = 0
        if self.adapters is not None and req.adapter is not None \
                and self._aid[slot]:
            # the tenant stays resident: warm for its next request
            self.adapters.release(req.adapter)
        self._aid[slot] = 0
        self._held_idle.pop(req.rid, None)
        ent = self._req_host.pop(req.rid, None)
        if ent is not None:
            # released while spilled: the host copies die with it
            for i in ent["idx"]:
                if self._host_tier.pop(("req", req.rid, i)):
                    counters.inc("serving.kv.tier.spill_drops")
        if table is None:
            return
        if self.prefix is not None and st is None and reason != "error" \
                and req.tokens and TRASH_BLOCK not in table:
            # K/V is live through position T + len(tokens) - 2 (the last
            # emitted token was sampled but never written back); a table
            # with spilled (trashed) entries has holes and cannot donate
            n_avail = int(req.prompt.shape[0]) + len(req.tokens) - 1
            seq = np.concatenate(
                [req.prompt, np.asarray(req.tokens, np.int32)])[:n_avail]
            self.prefix.insert(self._prefix_key(seq.tolist(), req.adapter),
                               table)
        for b in table:
            if b != TRASH_BLOCK:
                self.pool.release(b)

    def _finish(self, req, reason, events):
        with self._cond:
            slot = req.slot
            done = super()._finish(req, reason, events)
            if done and slot is not None:
                self._release_slot_kv(slot, req, reason)
        return done

    # -- scheduling ----------------------------------------------------------
    def step(self):
        """One scheduler iteration: sweep cancels/deadlines, spill idle
        held requests, admit from the queue (prefix match + block
        reservation only), advance every mid-prefill request by ONE
        chunk, run ONE decode launch for all running slots, re-admit into
        anything freed this step.  Returns the list of events ({'type':
        'admitted' | 'token' | 'prefilled' | 'finished', ...})
        produced."""
        with span("serving.step"):
            events = []
            self._sweep(events)
            self._maybe_spill_idle()
            self._admit(events)
            self._prefill_chunks(events)
            self._decode_step(events)
            self._admit(events)
        counters.set_gauge(
            "serving.slot_occupancy",
            sum(r is not None for r in self._slots) / self.max_slots)
        used = self.pool.used_blocks
        counters.set_gauge("serving.kv.blocks_used", used)
        self._observe("serving.kv.block_occupancy",
                      used / max(1, self.pool.capacity))
        if self._host_tier is not None:
            counters.set_gauge("serving.kv.tier.host_blocks",
                               self._host_tier.resident)
        return events

    def stats(self):
        """Base snapshot plus the block-pool / prefix-cache / tier /
        adapter fields (one lock acquisition; the RLock makes the nested
        base call atomic)."""
        with self._cond:
            st = super().stats()
            tier = self._host_tier
            st.update({
                "kv_layout": "paged",
                "kv_dtype": self.kv_dtype,
                "weight_dtype": self.weight_dtype,
                "block_size": self.pool.block_size,
                "blocks_total": self.pool.capacity,
                "blocks_free": self.pool.free_blocks,
                "blocks_used": self.pool.used_blocks,
                "block_utilization": (self.pool.used_blocks
                                      / max(1, self.pool.capacity)),
                "prefix_hits": self.kv_prefix_hits,
                "prefix_misses": self.kv_prefix_misses,
                "prefix_hit_tokens": self.kv_prefix_hit_tokens,
                "cow_copies": self.kv_cow_copies,
                "blocks_evicted": self.kv_blocks_evicted,
                "pool_exhausted": self.kv_pool_exhausted_events,
                "prefix_nodes": (0 if self.prefix is None
                                 else self.prefix.nodes),
                "prefilling": len(self._prefill_state),
                "kv_pool_bytes": self._pool_bytes(),
                # what this rank holds: under an mp mesh the KV pools and
                # the weight matrices divide by the axis degree
                "kv_pool_bytes_per_chip": self.arena.device_bytes(
                    "pool_k", "pool_v", "scale_k", "scale_v"),
                "weight_bytes_per_chip": self.arena.device_bytes(
                    "weights"),
                "host_tier_capacity": 0 if tier is None else tier.capacity,
                "host_tier_blocks": 0 if tier is None else tier.resident,
                # this rank's host buffers: under an mp mesh its head
                # shard of each spilled block, the scale rows whole
                "host_arena_bytes": 0 if tier is None else tier.arena_bytes,
                "tier_spilled": self.kv_tier_spilled,
                "tier_restored": self.kv_tier_restored,
                "adapter_slots": self.adapter_slots,
                "adapters": (None if self.adapters is None
                             else self.adapters.stats()),
            })
        return st
