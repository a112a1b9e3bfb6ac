"""Continuous-batching LLM engine (port of
``paddle_tpu/serving/engine.py``).

Iteration-level scheduling (Orca, OSDI '22): requests are admitted from a
bounded queue into free slots, decoded together one token per step
regardless of arrival time, and evicted on EOS / ``max_new_tokens`` /
deadline / cancellation with the slot immediately re-handed out.

``LLMEngine(model)`` is the slot layout, the reference's default: a
dense KV arena ``[L, max_slots, S, nh, hd]`` in the model dtype on the
model's device, one row a slot.  Admission prefills a request's prompt,
padded to a power-of-two bucket, straight into its slot's row
(``GPTForCausalLM.prefill_slot``: the row's K/V written in place, the
rest of the row zeroed) and draws the first token; each step then runs
``decode_slots`` once for every occupied slot.  ``kv_layout="paged"``
constructs :class:`serving.paged.PagedLLMEngine` (block pools, prefix
cache, chunked prefill; ``kv_dtype="int8"|"fp8"`` quantized pools), and
``draft_model=`` :class:`serving.speculative.SpeculativeLLMEngine` over
the paged pools.  ``weight_dtype="int8"`` serves int8 weight-only layer
matmuls (``quantization.ptq_int8_decode_state``).  The paged engine's
LoRA adapters (``adapter_slots``, ``adapter_rank``), host-RAM KV tier
(``host_kv_blocks``, ``spill_idle_steps``) and held requests for KV
migration (``add_request(hold_after_prefill=True)``) are described in
``serving.paged``.

``mesh=`` (``distributed.build_mesh``) serves tensor-parallel: the
engine's ``StateArena`` (``serving.arena``) keeps this rank's shard of
the weights and of the KV storage (heads split over ``mp``), the
model's Megatron forward all-reduces after the row-parallel
projections, and the paged decode launches K4/K4q on the rank's heads
(``kernels.paged_attention.sharded_paged_decode_attention``).  Every
rank runs the same engine on the same requests; the token every rank
emits is the one mesh rank 0 chose, broadcast each step (the
speculative engine broadcasts each proposal and each round's accepted
block the same way), so the ranks' host decisions (admission, chunking,
blocks, prefix hits, spills, sampling) stay identical.  The paged
engine's extras serve on a mesh as without one: LoRA adapters (each
rank's arena holds the cut of the slabs its matmul shards meet, and
each shard adds its part of the update), the host-RAM tier (each rank spills and restores its own head
shard; the quantized pools' scale planes whole), KV migration between
two engines over the same mesh and head split (each rank copies its
shard), the speculative engine (the draft's weights and pools split
like the target's when its heads divide ``mp``) and the fleet
(``serving.fleet``).  ``deadline_s`` serves on a mesh of more than one
rank by mesh rank 0's clock: in a step where a queued or running
request has a deadline, rank 0 names the requests past theirs and every
rank evicts those (``arena.RankZero``; under a fleet the verdict rides
in the fleet's tick).  Cancels act at the step after the caller's
``cancel()``, so every rank's caller cancels between the same two steps
(a fleet on such a mesh posts them and applies rank 0's count at a
tick).  A mesh with ``sep > 1`` is refused (ROADMAP.md A7c-moe).  A
mesh of one rank runs the same code, collectives included, and gives the
same tokens as no mesh.

The engine follows the model's device.  Each sampled request carries its
own ``torch.Generator``, seeded from the request's ``seed``.

Telemetry, at the reference's sites: per-engine and process-global
histograms ``serving.ttft_ns``, ``serving.itl_ns``,
``serving.queue_wait_ns``, ``serving.prefill_occupancy`` and
``serving.decode_occupancy`` (the paged engine adds
``serving.kv.block_occupancy``; with adapters, per-tenant-bucket
``serving.ttft_ns.tenant.<b>`` / ``serving.itl_ns.tenant.<b>``), which
:meth:`LLMEngine.histogram_snapshot` copies for the fleet's Router;
flight-recorder events at admit and finish; request-trace spans
(``queue``, ``prefill``, ``decode.iter``, ``evict``); host-tracer spans
``serving.step`` / ``serving.prefill`` / ``serving.decode``; and a
device-time note at each dispatch.
"""

from __future__ import annotations

import itertools
import threading
import time
import zlib
from collections import deque

import numpy as np
import torch

from ..core.tensor import unwrap
from ..profiler import counters
from ..profiler import devicetime as _devicetime
from ..profiler import flight, metrics
from ..profiler import trace as rtrace
from ..profiler.host_tracer import span
from ..quantization import ptq_int8_decode_state
from ..resilience import faultinject as _fi
from .arena import KV_POOL_SPEC, StateArena
from .sampling import sample_tokens

_TODO = {
    "mesh+sep": "ROADMAP.md A7c-moe (serving over a mesh with sep > 1; "
                "a model built with sequence_parallel or context_parallel "
                "serves without one)",
}


def _not_ported(knob):
    return NotImplementedError(
        f"{knob} is not ported to paddle_tpu_torch yet: {_TODO[knob]}")


class EngineBackpressure(RuntimeError):
    """add_request refused: the bounded request queue is full.  Carries
    the structured retry info clients need to back off:

    * ``queue_depth`` — requests waiting at refusal time.
    * ``retry_after_hint`` — estimated seconds until the backlog drains
      (``outstanding_tokens / decode tokens/s EMA``), or None when the
      engine has produced no throughput estimate yet.
    """

    def __init__(self, msg="", queue_depth=0, retry_after_hint=None):
        super().__init__(msg)
        self.queue_depth = int(queue_depth)
        self.retry_after_hint = retry_after_hint


class EngineClosed(RuntimeError):
    """add_request refused: the engine is draining or drained."""


class Request:
    """One generation request and its live state (also the user handle:
    ``add_request`` returns it; iterate it to stream tokens)."""

    __slots__ = ("rid", "prompt", "max_new_tokens", "do_sample",
                 "temperature", "top_k", "top_p", "eos_token_id", "seed",
                 "state", "finish_reason", "tokens", "slot", "arrival_ns",
                 "last_emit_ns", "deadline", "_cancel", "_engine", "error",
                 "generator", "tag", "trace", "hold", "adapter")

    def __init__(self, rid, prompt, max_new_tokens, do_sample, temperature,
                 top_k, top_p, eos_token_id, seed, deadline, engine):
        self.rid = rid
        self.prompt = prompt                    # np.int32 [T]
        self.max_new_tokens = max_new_tokens
        self.do_sample = do_sample
        self.temperature = temperature
        self.top_k = top_k
        self.top_p = top_p
        self.eos_token_id = eos_token_id
        self.seed = seed
        # queued | prefilling | running | held | finished
        self.state = "queued"
        # eos | length | deadline | cancelled | error
        self.finish_reason = None
        self.error = None         # the exception, when finish_reason="error"
        self.tokens = []          # generated tokens (includes eos if hit)
        self.slot = None
        self.arrival_ns = time.monotonic_ns()
        self.last_emit_ns = None  # monotonic_ns of the last emitted token
        self.deadline = deadline  # absolute time.monotonic() or None
        self._cancel = False
        self._engine = engine
        self.generator = None     # torch.Generator, made at admission
        self.tag = None           # opaque owner backref (fleet handle)
        self.trace = None         # TraceContext when request tracing is on
        self.hold = False         # park after prefill for KV migration
        self.adapter = None       # tenant id (LoRA adapter), None = base

    @property
    def is_finished(self):
        return self.state == "finished"

    def cancel(self):
        """Request cancellation; the engine evicts the request (or drops
        it from the queue) on its next step.  Safe from any thread, any
        number of times, including after the request finished."""
        self._cancel = True

    def output_ids(self):
        """prompt + generated tokens, as one np.int32 array."""
        return np.concatenate([self.prompt,
                               np.asarray(self.tokens, np.int32)])

    def __iter__(self):
        """Stream generated tokens, pumping the engine while this request
        is live (single-threaded serving loop)."""
        i = 0
        while True:
            while i < len(self.tokens):
                yield self.tokens[i]
                i += 1
            if self.is_finished:
                return
            self._engine.step()

    def __repr__(self):
        return (f"Request(id={self.rid}, state={self.state!r}, "
                f"reason={self.finish_reason!r}, "
                f"generated={len(self.tokens)})")



def prompt_ids(prompt):
    """A prompt as a 1-d int32 numpy array, from a ``torch.Tensor`` on any
    device (copied to the host), the paddle-style ``Tensor``, a list or
    an array: what every entry point that takes a prompt reads (the
    reference unwraps its own device arrays the same way)."""
    data = unwrap(prompt)
    if isinstance(data, torch.Tensor):
        data = data.detach().cpu().numpy()
    return np.asarray(data, dtype=np.int32).reshape(-1)

def bucket_length(n, min_bucket=8, max_len=None):
    """Smallest power-of-two >= n (floored at ``min_bucket``, clamped to
    ``max_len``): the padded length of an n-token prefill chunk."""
    b = max(int(min_bucket), 1)
    while b < n:
        b *= 2
    return min(b, max_len) if max_len is not None else b


class LLMEngine:
    """Continuous-batching engine over one ``GPTForCausalLM``.

    ``add_request()`` enqueues (bounded queue, optional blocking
    backpressure); ``step()`` admits, prefills, runs one decode launch
    for every active slot, and evicts finished rows; ``generate()`` is
    the blocking convenience loop; iterating a returned ``Request``
    streams its tokens.  ``drain()`` stops admission and finishes all
    outstanding work.
    """

    def __new__(cls, *args, **kw):
        # kv_layout="paged" routes construction to the paged subclass so
        # `LLMEngine(model, kv_layout="paged")` is the one public spelling;
        # a draft_model= routes further to the speculative engine, which
        # runs over the paged pools
        if cls is LLMEngine and kw.get("draft_model") is not None:
            from .speculative import SpeculativeLLMEngine
            return super().__new__(SpeculativeLLMEngine)
        if cls is LLMEngine and kw.get("kv_layout", "slots") == "paged":
            from .paged import PagedLLMEngine
            return super().__new__(PagedLLMEngine)
        return super().__new__(cls)

    def __init__(self, model, max_slots=8, max_seq_len=None, queue_size=64,
                 min_bucket=8, eos_token_id=None, kv_layout="slots",
                 block_size=16, n_blocks=None, prefill_chunk=None,
                 prefix_cache=True, kv_dtype=None, weight_dtype=None,
                 host_kv_blocks=0, spill_idle_steps=0, mesh=None,
                 shard_rules=None, adapter_slots=0, adapter_rank=8,
                 tenant_buckets=8):
        if kv_layout not in ("slots", "paged"):
            raise ValueError(f"unknown kv_layout {kv_layout!r}; "
                             "want 'slots' or 'paged'")
        if kv_dtype not in (None, "int8", "fp8"):
            raise ValueError(f"kv_dtype must be None, 'int8' or 'fp8', "
                             f"got {kv_dtype!r}")
        if kv_dtype is not None and kv_layout != "paged":
            raise ValueError("kv_dtype requires kv_layout='paged' (the "
                             "slot arena is not quantized)")
        if weight_dtype not in (None, "int8"):
            raise ValueError(f"weight_dtype must be None or 'int8', "
                             f"got {weight_dtype!r}")
        if mesh is not None and mesh.shape.get("sep", 1) > 1:
            raise _not_ported("mesh+sep")
        if int(adapter_slots or 0) > 0 and kv_layout != "paged":
            raise ValueError("adapter_slots requires kv_layout='paged' "
                             "(adapter ids ride the paged calls)")
        self.kv_layout = kv_layout
        # multi-tenant LoRA knobs (paged engine only; 0 disables).
        # tenant_buckets bounds the per-tenant telemetry cardinality:
        # TTFT/ITL histograms are keyed by a stable hash bucket, never by
        # the raw tenant id
        self.adapter_slots = int(adapter_slots or 0)
        self.adapter_rank = int(adapter_rank)
        self.tenant_buckets = int(tenant_buckets)
        # host-RAM KV tier knobs (paged engine only; 0 disables)
        self.host_kv_blocks = int(host_kv_blocks or 0)
        self.spill_idle_steps = int(spill_idle_steps or 0)
        # paged-pool knobs (read by PagedLLMEngine._init_kv)
        self.block_size = int(block_size)
        self.n_blocks = n_blocks
        self.prefill_chunk = prefill_chunk
        self.prefix_caching = bool(prefix_cache)
        self.kv_dtype = kv_dtype
        self.weight_dtype = weight_dtype
        c = model.config
        self.model = model
        self.config = c
        self.device = model.device
        self.max_slots = int(max_slots)
        self.max_seq_len = int(max_seq_len or c.max_seq_len)
        if not c.use_rope and self.max_seq_len > c.max_seq_len:
            raise ValueError(
                f"max_seq_len {self.max_seq_len} exceeds the model's "
                f"learned-position table ({c.max_seq_len})")
        self.queue_size = int(queue_size)
        self.min_bucket = int(min_bucket)
        self.eos_token_id = eos_token_id  # default for requests
        # the arena keeps this rank's shards under a mesh; without one it
        # passes the weights through untouched
        self.arena = StateArena(mesh=mesh, shard_rules=shard_rules)
        self._disagreed = None   # see _agree
        # a multi-rank mesh's deadline verdicts (see _deadline_verdict):
        # this step's, and the one a fleet's tick hands in (None: the
        # engine asks rank 0 itself)
        self._expired = None
        self._fleet_verdict = None
        self._w = self.arena.declare_tree(
            "weights", ptq_int8_decode_state(model) if weight_dtype == "int8"
            else model.decode_state(), c.num_heads)

        B, S = self.max_slots, self.max_seq_len
        nh = c.num_heads
        self._init_kv(c, B, S, nh, c.hidden_size // nh)

        # host mirrors of the per-slot decode inputs
        self._tok = np.zeros(B, np.int32)
        self._pos = np.zeros(B, np.int32)

        self._slots: list = [None] * B
        self._free = list(range(B - 1, -1, -1))  # slot 0 handed out first
        self._queue: deque = deque()
        # ONE engine lock: the Condition's (re-entrant) lock guards the
        # queue, slot bookkeeping, the finish CAS, and the stats()
        # aggregates below
        self._cond = threading.Condition(threading.RLock())
        self._closed = False
        self._rid = itertools.count()
        self._outstanding = 0     # undelivered tokens across queued+active
        self._tps_ema = 0.0       # decode tokens/s, EMA over launches
        self._ema_alpha = 0.25
        # per-engine mergeable histograms (the fleet Router merges them
        # across replicas); every observation also feeds the global
        # registry under the same name
        self.hists = {
            n: metrics.Histogram(n, unit)
            for n, unit in (("serving.ttft_ns", "ns"),
                            ("serving.itl_ns", "ns"),
                            ("serving.queue_wait_ns", "ns"),
                            ("serving.prefill_occupancy", "frac"),
                            ("serving.decode_occupancy", "frac"))}

    def _observe(self, name, value, sum_counter=False):
        metrics.observe(name, value, sum_counter=sum_counter,
                        extra=self.hists[name])

    def _tenant_bucket(self, tenant):
        """Stable low-cardinality label of a tenant: ``"base"`` for
        un-adapted rows, else a crc32 hash bucket ``"t<n>"``."""
        if tenant is None:
            return "base"
        return f"t{zlib.crc32(str(tenant).encode()) % self.tenant_buckets}"

    def _observe_tenant(self, base, tenant, value):
        """Record a latency sample into the tenant-bucketed histogram
        (created on first use) and the global registry, where the health
        plane's ``noisy_neighbor`` watchdog reads it."""
        name = f"{base}.tenant.{self._tenant_bucket(tenant)}"
        h = self.hists.get(name)
        if h is None:
            h = self.hists[name] = metrics.Histogram(name, "ns")
        metrics.observe(name, value, extra=h)

    def histogram_snapshot(self):
        """Copies of the per-engine histograms (safe to
        ``Histogram.merge`` across replicas, as the fleet Router does)."""
        return {n: h.copy() for n, h in self.hists.items()}

    def _init_kv(self, c, B, S, nh, hd):
        """Allocate the device KV storage: the slot arena ``[L, B, S, nh,
        hd]`` in the model dtype here, a block pool in the PagedLLMEngine
        override."""
        dt = self.model.wte.dtype
        self._ck, self._cv = (self._kv_zeros(n, (c.num_layers, B, S, nh, hd),
                                             dt) for n in ("cache_k",
                                                           "cache_v"))

    def _kv_zeros(self, name, shape, dtype, weights=None):
        """Zeroed KV storage ``[L, *, *, nh, hd]`` through the arena:
        this rank's heads when the attention weights of ``weights`` (the
        target's decode state by default) split."""
        tp = (self._w if weights is None else weights).get("tp")
        return self.arena.declare_zeros(
            name, shape, dtype, self.device, KV_POOL_SPEC,
            split=tp is not None and tp.attn)

    def _agree(self, tok):
        """``tok`` (a device integer tensor) as mesh rank 0 chose it:
        broadcast over the mesh, so every rank emits the same tokens and
        takes the same host decisions; every element this rank chose
        apart from rank 0 is counted (``rank_disagreements``).  Without
        a mesh, ``tok`` itself."""
        if self.arena.mesh is None:
            return tok
        from ..distributed.communication import broadcast
        mine = tok.contiguous()
        tok = mine.clone()
        broadcast(tok, src=0)
        if self.arena.multi_device:
            # what this rank chose itself and rank 0 did not, summed on
            # the device and read by stats()
            d = (mine != tok).sum()
            self._disagreed = d if self._disagreed is None \
                else self._disagreed + d
        return tok

    def release_kv(self):
        """Drop the device KV arena (a dead replica's arena is garbage)."""
        self._ck = self._cv = None
        self.arena.release("cache_k", "cache_v")

    def prefix_peek(self, prompt, tenant=None):
        """Tokens of ``prompt`` a prefix cache could serve without
        prefilling: 0 under the slot layout (no sharing); the paged
        engine overrides.  ``tenant`` scopes the probe to that adapter's
        KV plane."""
        return 0

    def prefix_probe(self, prompt, tenant=None):
        """``(device_tokens, host_tokens)`` a prefix cache could serve:
        ``(0, 0)`` under the slot layout; the paged engine overrides."""
        return 0, 0

    def adapter_peek(self, tenant):
        """Prefill-equivalent tokens saved because ``tenant``'s LoRA
        factors are already resident: 0 here (the slot engine serves no
        adapters); the paged engine overrides."""
        return 0

    # -- request intake ------------------------------------------------------
    def add_request(self, prompt, max_new_tokens=32, do_sample=False,
                    temperature=1.0, top_k=0, top_p=1.0, eos_token_id=None,
                    seed=None, deadline_s=None, block=True, timeout=None,
                    trace_ctx=None, hold_after_prefill=False, adapter=None):
        """Enqueue one prompt; returns the live ``Request`` handle.

        Backpressure: when the bounded queue is full, ``block=False``
        raises ``EngineBackpressure`` immediately; ``block=True`` waits up
        to ``timeout`` seconds (forever if None) for another thread's
        ``step()`` to make room, then raises.  ``deadline_s`` is a
        per-request wall-clock budget (queue wait included); on expiry the
        request finishes with ``finish_reason='deadline'`` and whatever
        tokens it produced.  ``trace_ctx`` carries a caller-minted
        ``TraceContext`` (the fleet threads one through every attempt);
        with tracing on and none given, the engine mints its own.
        ``hold_after_prefill`` parks the request
        after its last prefill chunk (state ``"held"``, a ``{"type":
        "prefilled"}`` event) instead of entering decode: the hand-off
        point for KV migration (``export_request``).  The paged engine
        honours it; the slot layout decodes in place.  ``adapter`` names
        the tenant whose registered LoRA factors decorate this request's
        matmuls (None = the base model); it needs ``adapter_slots > 0``."""
        if self._closed:
            raise EngineClosed("engine is drained; no new requests")
        if adapter is not None and not self.adapter_slots:
            raise ValueError("adapter given but the engine was built "
                             "with adapter_slots=0")
        ids = prompt_ids(prompt)
        T = int(ids.shape[0])
        if T < 1:
            raise ValueError("empty prompt")
        if T + int(max_new_tokens) > self.max_seq_len:
            raise ValueError(
                f"prompt ({T}) + max_new_tokens ({max_new_tokens}) exceeds "
                f"the engine's max_seq_len ({self.max_seq_len})")
        eos = eos_token_id if eos_token_id is not None else self.eos_token_id
        if seed is None:
            seed = int(np.random.randint(0, 2**31 - 1))
        deadline = (time.monotonic() + float(deadline_s)
                    if deadline_s is not None else None)
        req = Request(next(self._rid), ids, int(max_new_tokens),
                      bool(do_sample), float(temperature), int(top_k),
                      float(top_p), (None if eos is None else int(eos)),
                      int(seed), deadline, self)
        req.hold = bool(hold_after_prefill)
        req.adapter = adapter
        req.trace = trace_ctx if trace_ctx is not None \
            else rtrace.new_trace(req.rid)
        if req.trace is not None:
            req.trace.stamp("enqueue")  # the queue span covers the wait
        with self._cond:
            while len(self._queue) >= self.queue_size:
                if not block:
                    raise EngineBackpressure(
                        f"request queue full ({self.queue_size})",
                        queue_depth=len(self._queue),
                        retry_after_hint=self._retry_hint_locked())
                if not self._cond.wait(timeout):
                    raise EngineBackpressure(
                        f"request queue full ({self.queue_size}); timed "
                        f"out after {timeout}s",
                        queue_depth=len(self._queue),
                        retry_after_hint=self._retry_hint_locked())
                if self._closed:
                    raise EngineClosed("engine drained while waiting")
            self._queue.append(req)
            self._outstanding += req.max_new_tokens
        counters.inc("serving.requests")
        flight.record("serving.request", rid=req.rid, prompt_len=T,
                      max_new_tokens=req.max_new_tokens)
        return req

    def _note_decode(self, emitted, elapsed_s):
        """Fold one decode launch into the tokens/s EMA (``emitted`` is
        the number of tokens the launch delivered)."""
        inst = emitted / max(elapsed_s, 1e-9)
        with self._cond:
            self._tps_ema = (inst if self._tps_ema <= 0 else
                             self._ema_alpha * inst
                             + (1 - self._ema_alpha) * self._tps_ema)

    def _retry_hint_locked(self):
        """Seconds until the current backlog drains at the EMA decode
        rate; None before the first decode launch.  Caller holds _cond."""
        if self._tps_ema <= 0:
            return None
        return self._outstanding / self._tps_ema

    # -- scheduling ----------------------------------------------------------
    def _finish(self, req, reason, events):
        """Terminal transition: a compare-and-set on the request state
        under the engine lock, so a cancel from another thread and the
        scheduler can never both finish it or release its slot twice."""
        with self._cond:
            if req.state == "finished":
                return False
            req.state = "finished"
            req.finish_reason = reason
            self._outstanding -= max(
                0, req.max_new_tokens - len(req.tokens))
            if req.slot is not None:
                s = req.slot
                self._slots[s] = None
                self._free.append(s)
                self._tok[s] = 0
                self._pos[s] = 0
                req.slot = None
        counters.inc("serving.evictions")
        counters.inc(f"serving.evictions.{reason}")
        flight.record("serving.finish", rid=req.rid, reason=reason,
                      tokens=len(req.tokens))
        events.append({"type": "finished", "request": req, "reason": reason})
        tr = req.trace
        if tr is not None:
            tr.add_event("evict", reason=reason)
            if req.tag is None:
                # a standalone request: the engine finalizes its trace; a
                # fleet-owned one (tag set) is finalized by its fleet
                # handle, which sees retries
                breached = (req.deadline is not None
                            and time.monotonic() > req.deadline)
                rtrace.finish(tr, reason, breached=breached)
        return True

    def expired_rids(self):
        """Ids of the queued and running requests past their deadline by
        this rank's clock."""
        now = time.monotonic()
        with self._cond:
            reqs = [r for r in self._slots if r is not None] \
                + list(self._queue)
        return sorted(r.rid for r in reqs
                      if r.deadline is not None and now > r.deadline)

    def _deadline_verdict(self):
        """This step's deadline verdict on a mesh of more than one rank:
        the ids of the requests past their deadline by mesh rank 0's
        clock (a rank's own clock would evict at other steps), the one a
        fleet's tick handed in, else asked of rank 0 in a step where a
        queued or running request has a deadline (every rank's caller
        gave the same ``deadline_s``, so every rank asks in the same
        steps; a step without one issues no collective).  None off such
        a mesh: each check reads this process's clock."""
        if not self.arena.multi_device:
            return None
        if self._fleet_verdict is not None:
            v, self._fleet_verdict = self._fleet_verdict, frozenset()
            return v
        with self._cond:
            timed = any(r is not None and r.deadline is not None
                        for r in (*self._slots, *self._queue))
        if not timed:
            return frozenset()
        return frozenset(self.arena.rank_zero.decide(self.expired_rids))

    def _past_deadline(self, req, now):
        if self._expired is not None:
            return req.rid in self._expired
        return req.deadline is not None and now > req.deadline

    def _sweep(self, events):
        """Evict cancelled / past-deadline requests — active slots AND the
        admission queue, so a request whose deadline lapsed while queued
        never spends a prefill launch."""
        self._expired = self._deadline_verdict()
        now = time.monotonic()
        for req in list(self._slots):
            if req is None:
                continue
            if req._cancel:
                self._finish(req, "cancelled", events)
            elif self._past_deadline(req, now):
                self._finish(req, "deadline", events)
        with self._cond:
            dead = [r for r in self._queue
                    if r._cancel or self._past_deadline(r, now)]
            for r in dead:
                self._queue.remove(r)
            if dead:
                self._cond.notify_all()
        for req in dead:
            if req._cancel:
                self._finish(req, "cancelled", events)
            else:
                counters.inc("serving.deadline_expired")
                self._finish(req, "deadline", events)

    def _emit(self, req, tok, events):
        """Record one generated token; finish on EOS / length.  The event
        carries the token's stream index (one step can emit several)."""
        req.tokens.append(int(tok))
        now_ns = time.monotonic_ns()
        if len(req.tokens) == 1:
            self._observe("serving.ttft_ns", now_ns - req.arrival_ns)
            if self.adapter_slots:
                self._observe_tenant("serving.ttft_ns", req.adapter,
                                     now_ns - req.arrival_ns)
        elif req.last_emit_ns is not None:
            self._observe("serving.itl_ns", now_ns - req.last_emit_ns)
            if self.adapter_slots:
                self._observe_tenant("serving.itl_ns", req.adapter,
                                     now_ns - req.last_emit_ns)
        req.last_emit_ns = now_ns
        with self._cond:
            self._outstanding -= 1
        events.append({"type": "token", "request": req, "token": int(tok),
                       "index": len(req.tokens) - 1})
        if req.eos_token_id is not None and int(tok) == req.eos_token_id:
            self._finish(req, "eos", events)
        elif len(req.tokens) >= req.max_new_tokens:
            self._finish(req, "length", events)

    def _next_tokens(self, logits, active):
        """Next token of every row of ``logits [B, V]``: argmax, and a
        draw with the request's generator and knobs for each sampled
        ``(slot, request)`` of ``active``; read back to the host once."""
        nxt = torch.argmax(logits, dim=-1)
        for s, req in active:
            if req.do_sample:
                nxt[s] = sample_tokens(
                    logits[s:s + 1], req.generator, do_sample=True,
                    temperature=req.temperature, top_k=req.top_k,
                    top_p=req.top_p)[0]
        return self._agree(nxt).cpu().numpy()

    # -- the slot layout -----------------------------------------------------
    def _prefill_insert(self, slot, req):
        """Prefill ``req``'s prompt, padded to its power-of-two bucket,
        straight into the slot's arena row (its K/V at ``[0, T)``, zeros
        after) and draw the first token with the request's generator;
        returns that token."""
        T = int(req.prompt.shape[0])
        bucket = bucket_length(T, self.min_bucket, self.max_seq_len)
        self._observe("serving.prefill_occupancy", T / bucket)
        ids = np.zeros((1, bucket), np.int64)
        ids[0, :T] = req.prompt
        tr = req.trace
        t0_tr = time.perf_counter_ns() if tr is not None else 0
        with span("serving.prefill"):
            _dt = _devicetime.note(f"serving.prefill[b{bucket}]")
            logits = self.model.prefill_slot(
                self._w, torch.from_numpy(ids).to(self.device), T,
                self._ck[:, slot:slot + 1], self._cv[:, slot:slot + 1])
            _devicetime.observe(_dt, logits)
            tok = int(self._agree(sample_tokens(
                logits, req.generator, do_sample=req.do_sample,
                temperature=req.temperature, top_k=req.top_k,
                top_p=req.top_p))[0])
        if tr is not None:
            tr.add_span("prefill", t0_tr, time.perf_counter_ns(),
                        bucket=bucket, tokens=T)
        return tok

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
            self._observe("serving.queue_wait_ns",
                          time.monotonic_ns() - req.arrival_ns,
                          sum_counter=True)
            if req.trace is not None:
                req.trace.span_from("enqueue", "queue")
            with self._cond:
                slot = self._free.pop()
            try:
                _fi.maybe_fault("serving_prefill", req.rid)
                if req.do_sample:
                    req.generator = torch.Generator(
                        device=self.device).manual_seed(req.seed)
                tok = self._prefill_insert(slot, req)
            except Exception as e:  # noqa: BLE001 — the scheduler boundary
                # a poisoned request (bad prompt, prefill blow-up) must not
                # kill the engine loop: it finishes with
                # finish_reason="error", the exception riding the request,
                # and the slot is handed right back
                with self._cond:
                    self._free.append(slot)
                req.error = e
                counters.inc("serving.request_errors")
                self._finish(req, "error", events)
                continue
            counters.inc("serving.prefill_batches")
            req.state = "running"
            req.slot = slot
            self._slots[slot] = req
            self._tok[slot] = tok
            self._pos[slot] = int(req.prompt.shape[0])
            events.append({"type": "admitted", "request": req})
            self._emit(req, tok, events)

    def _decode_step(self, events):
        active = [(s, r) for s, r in enumerate(self._slots) if r is not None]
        if not active:
            return
        self._observe("serving.decode_occupancy",
                      len(active) / self.max_slots)
        t0 = time.perf_counter()
        t0_tr = time.perf_counter_ns() if rtrace.enabled() else 0
        dev = self.device
        with span("serving.decode"):
            # idle rows decode token 0 at position 0 of their own row:
            # nothing reads it, and the next admission rewrites the row
            _dt = _devicetime.note("serving.decode")
            logits = self.model.decode_slots(
                self._w, torch.from_numpy(self._tok).to(dev),
                torch.from_numpy(self._pos).to(dev), self._ck, self._cv)
            _devicetime.observe(_dt, logits)
            nxt = self._next_tokens(logits, active)
        self._trace_decode(active, t0_tr)
        self._note_decode(len(active), time.perf_counter() - t0)
        counters.inc("serving.decode_steps")
        counters.inc("serving.decode_tokens", len(active))
        for s, req in active:
            self._tok[s] = nxt[s]
            self._pos[s] += 1
            self._emit(req, nxt[s], events)

    @staticmethod
    def _trace_decode(active, t0_tr):
        """One ``decode.iter`` span per traced row of a decode launch that
        started at ``t0_tr`` (0: tracing was off)."""
        if not t0_tr:
            return
        t1_tr = time.perf_counter_ns()
        for _s, r in active:
            if r.trace is not None:
                r.trace.add_span("decode.iter", t0_tr, t1_tr,
                                 batch=len(active))

    def step(self):
        """One scheduler iteration: sweep cancels/deadlines, admit from
        the queue into free slots (prefill into the arena row), run ONE
        decode launch for all occupied slots, re-admit into slots freed
        this step.  Returns the list of events ({'type': 'admitted' |
        'token' | 'finished', ...}) produced."""
        with span("serving.step"):
            events = []
            self._sweep(events)
            self._admit(events)
            self._decode_step(events)
            self._admit(events)
        counters.set_gauge(
            "serving.slot_occupancy",
            sum(r is not None for r in self._slots) / self.max_slots)
        return events

    # -- conveniences --------------------------------------------------------
    def has_work(self):
        with self._cond:
            queued = len(self._queue)
        return queued > 0 or any(r is not None for r in self._slots)

    def generate(self, prompts, **kw):
        """Blocking batch API: submit every prompt, step until all finish,
        return their full sequences (prompt + generated) as np.int32
        arrays.  Oversubscription beyond the queue bound is handled by
        stepping the engine between submissions."""
        pending = deque(prompts)
        handles = []
        while pending or not all(h.is_finished for h in handles):
            while pending:
                try:
                    handles.append(self.add_request(pending[0], block=False,
                                                    **kw))
                    pending.popleft()
                except EngineBackpressure:
                    break
            self.step()
        return [h.output_ids() for h in handles]

    def drain(self):
        """Graceful shutdown: stop admitting (``add_request`` raises
        ``EngineClosed``), finish every queued + active request, return
        them.  Idempotent."""
        self._closed = True
        with self._cond:
            self._cond.notify_all()
        events = []
        self._sweep(events)
        done = [ev["request"] for ev in events if ev["type"] == "finished"]
        while self.has_work():
            for ev in self.step():
                if ev["type"] == "finished":
                    done.append(ev["request"])
        return done

    def stats(self):
        """Atomic snapshot under ONE lock acquisition.

        ``outstanding_tokens`` is the undelivered-token backlog (sum of
        remaining ``max_new_tokens`` over queued + active requests);
        ``decode_tps_ema`` is the decode tokens/s EMA over launches
        (0.0 before the first decode)."""
        with self._cond:
            return {
                "kv_layout": self.kv_layout,
                "active": sum(r is not None for r in self._slots),
                "queued": len(self._queue),
                "free_slots": len(self._free),
                "max_slots": self.max_slots,
                "closed": self._closed,
                "outstanding_tokens": self._outstanding,
                "decode_tps_ema": self._tps_ema,
                "mesh_tag": self.arena.tag or None,
                # tokens this rank chose that rank 0's broadcast replaced
                # (0 when every rank's logits agree; a multi-rank mesh
                # only)
                "rank_disagreements": (0 if self._disagreed is None
                                       else int(self._disagreed)),
            }
