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

The pools are updated in place by the model's ``prefill_paged`` /
``decode_paged`` and by the COW copy; this replaces the reference's
donation of the pools through every program.  Each decode step copies
the host mirrors (tokens, positions, block tables) to the device once
and reads the next tokens back once.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from ..kernels.paged_attention import KV_DTYPES
from ..profiler import counters
from .engine import LLMEngine, bucket_length
from .kvcache import (TRASH_BLOCK, BlockPool, PrefixCache,
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
    """

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
        self.pool_k = torch.zeros(shape, dtype=adt, device=self.device)
        self.pool_v = torch.zeros(shape, dtype=adt, device=self.device)
        # per-token fp32 scales at the same (layer, block, position) as the
        # quantized tiles; empty tuple for unquantized pools
        self.scales = ()
        if self.kv_dtype:
            self.scales = tuple(
                torch.zeros(shape[:3], dtype=torch.float32,
                            device=self.device) for _ in range(2))
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
        # per-engine prefix-cache accounting (the same events also feed
        # the process-global counters registry)
        self.kv_prefix_hits = 0
        self.kv_prefix_misses = 0
        self.kv_prefix_hit_tokens = 0
        self.kv_cow_copies = 0
        self.kv_blocks_evicted = 0
        self.kv_pool_exhausted_events = 0

    def prefix_peek(self, prompt):
        """Tokens of ``prompt`` the prefix cache could serve without
        prefilling (read-only)."""
        if self.prefix is None:
            return 0
        ids = np.asarray(prompt, dtype=np.int32).reshape(-1)
        with self._cond:
            return self.prefix.peek(ids.tolist(), int(ids.shape[0]) - 1)

    def prefix_probe(self, prompt):
        """``(device_tokens, host_tokens)`` the prefix cache could serve
        for this prompt; ``host_tokens`` is 0 without a host tier."""
        if self.prefix is None:
            return 0, 0
        ids = np.asarray(prompt, dtype=np.int32).reshape(-1)
        with self._cond:
            return self.prefix.probe(ids.tolist(), int(ids.shape[0]) - 1)

    def _pool_bytes(self):
        return sum(t.nbytes for t in (self.pool_k, self.pool_v,
                                      *self.scales))

    def _copy_block(self, src, dst, nvalid):
        """Copy-on-write block clone: ``dst[:nvalid] = src[:nvalid]``,
        zeros beyond, in every layer of both pools and of the scale
        pools."""
        for pool in (self.pool_k, self.pool_v, *self.scales):
            pool[:, dst, :nvalid] = pool[:, src, :nvalid]
            pool[:, dst, nvalid:] = 0

    # -- request intake ------------------------------------------------------
    def add_request(self, prompt, max_new_tokens=32, **kw):
        ids = np.asarray(prompt, dtype=np.int32).reshape(-1)
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
        """Match the prefix cache, then reserve every block the request
        can ever touch (``ceil((T + max_new - 1)/bs)`` minus shared
        prefix blocks).  Returns False — with NOTHING allocated and no
        table mutated — when the pool (after LRU eviction) cannot cover
        it."""
        T = int(req.prompt.shape[0])
        bs = self.pool.block_size
        total = blocks_for_tokens(max(1, T + req.max_new_tokens - 1), bs)
        with self._cond:
            shared, cached, pnode, p = [], 0, None, 0
            if self.prefix is not None:
                shared, cached, pnode, p = self.prefix.match(
                    req.prompt.tolist(), T - 1)
            fresh_needed = total - len(shared)
            shortfall = fresh_needed - self.pool.free_blocks
            if shortfall > 0 and self.prefix is not None:
                self.kv_blocks_evicted += self.prefix.evict(shortfall)
                shortfall = fresh_needed - self.pool.free_blocks
            if shortfall > 0:
                for b in shared:
                    self.pool.release(b)
                if pnode is not None:
                    self.pool.release(pnode.block)
                self.kv_pool_exhausted_events += 1
                counters.inc("serving.kv.pool_exhausted")
                return False
            fresh = self.pool.alloc_n(fresh_needed)
            table = shared + fresh
            slot = self._free.pop()
            if pnode is not None:
                # copy-on-write: clone the shared partial block into the
                # request's first private tail block before extending it
                self._copy_block(pnode.block, table[len(shared)], p)
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
            self._running[slot] = False
            req.state = "prefilling"
            req.slot = slot
            if req.do_sample:
                req.generator = torch.Generator(
                    device=self.device).manual_seed(req.seed)
            self._slots[slot] = req
            self._prefill_state[slot] = {"req": req, "done": cached}
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
            if req.deadline is not None and now > req.deadline:
                counters.inc("serving.deadline_expired")
                self._finish(req, "deadline", events)
                continue
            if not self._reserve(req, events):
                # pool exhausted: park the request back at the queue head
                # and stop admitting this step — blocks free as running
                # requests finish
                with self._cond:
                    self._queue.appendleft(req)
                return

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
        dev = self.device
        logits = self.model.prefill_paged(
            self._w, torch.from_numpy(ids).to(dev), start, take_n,
            torch.from_numpy(self._bt[slot]).to(dev), self.pool_k,
            self.pool_v, *self.scales)
        counters.inc("serving.kv.prefill_chunks")
        if self.kv_dtype:
            counters.inc("serving.kv.quant.prefill_tokens", take_n)
        st["done"] = start + take_n
        if last:
            # only the final chunk's logits are sampled: the first token
            tok = int(sample_tokens(
                logits, req.generator, do_sample=req.do_sample,
                temperature=req.temperature, top_k=req.top_k,
                top_p=req.top_p)[0])
            del self._prefill_state[slot]
            counters.inc("serving.prefill_batches")
            self._tok[slot] = tok
            self._pos[slot] = T
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
        # non-running rows (idle or mid-prefill) are tabled to the trash
        # block at position 0, so every launch has the same shapes
        bt_eff = np.where(self._running[:, None], self._bt, 0).astype(
            np.int32)
        pos_eff = np.where(self._running, self._pos, 0).astype(np.int32)
        t0 = time.perf_counter()
        dev = self.device
        logits = self.model.decode_paged(
            self._w, torch.from_numpy(self._tok).to(dev),
            torch.from_numpy(pos_eff).to(dev),
            torch.from_numpy(bt_eff).to(dev), self.pool_k, self.pool_v,
            *self.scales)
        nxt = self._next_tokens(logits, active)
        self._note_decode(len(active), time.perf_counter() - t0)
        counters.inc("serving.decode_steps")
        counters.inc("serving.decode_tokens", len(active))
        if self.kv_dtype:
            counters.inc("serving.kv.quant.decode_tokens", len(active))
        for s, req in active:
            self._tok[s] = nxt[s]
            self._pos[s] += 1
            self._emit(req, nxt[s], events)

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
        if table is None:
            return
        if self.prefix is not None and st is None and reason != "error" \
                and req.tokens:
            # K/V is live through position T + len(tokens) - 2 (the last
            # emitted token was sampled but never written back)
            n_avail = int(req.prompt.shape[0]) + len(req.tokens) - 1
            seq = np.concatenate(
                [req.prompt, np.asarray(req.tokens, np.int32)])[:n_avail]
            self.prefix.insert(seq.tolist(), table)
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
        """One scheduler iteration: sweep cancels/deadlines, admit from
        the queue (prefix match + block reservation only), advance every
        mid-prefill request by ONE chunk, run ONE decode launch for all
        running slots, re-admit into anything freed this step.  Returns
        the list of events ({'type': 'admitted' | 'token' | 'finished',
        ...}) produced."""
        events = []
        self._sweep(events)
        self._admit(events)
        self._prefill_chunks(events)
        self._decode_step(events)
        self._admit(events)
        counters.set_gauge(
            "serving.slot_occupancy",
            sum(r is not None for r in self._slots) / self.max_slots)
        counters.set_gauge("serving.kv.blocks_used", self.pool.used_blocks)
        return events

    def stats(self):
        """Base snapshot plus the block-pool / prefix-cache fields (one
        lock acquisition; the RLock makes the nested base call atomic)."""
        with self._cond:
            st = super().stats()
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
            })
        return st
