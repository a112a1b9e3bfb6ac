"""Multi-tenant LoRA adapter arena for the paged serving engine (port of
``paddle_tpu/serving/adapters.py``; S-LoRA / Punica style: one base
model, many low-rank variants).

The :class:`AdapterArena` holds paged low-rank factor slabs on the
model's device, one pair per adapted matmul::

    a_<t>  [L, slots + 1, d_in, R]     b_<t>  [L, slots + 1, R, d_out]

for ``t`` in ``qkv_w / proj_w / fc1_w / fc2_w``, in the model dtype,
rank-padded to a fixed ``R`` so every tenant rides the same shapes.  Each
prefill, decode and verify call carries per-row ``adapter_ids`` and
``models.gpt._mm_lora`` applies the gathered update ``x @ A[ids] @
B[ids]`` beside the (possibly int8) base matmul, so one batch serves any
mix of tenants.  Row 0 is the base model: its slab rows are zeros and
the model selects the un-adapted product itself for id-0 rows, so base
traffic is bitwise that of an adapter-free engine.

Slots are managed like ``kvcache.BlockPool`` blocks: admission acquires
the request's adapter (refcount + 1; a cold tenant pages in from the
host registry by an in-place copy into its slot's rows), completion
releases it, and a refcount-0 resident is an LRU eviction candidate when
the arena runs dry.  A full arena raises :class:`AdapterArenaExhausted`,
which the paged engine turns into the same deferred admission as KV
exhaustion.  The ``adapter_load_drop`` fault fails a page-in *before*
any slab write, so a dropped load never leaves another tenant's weights
behind the slot.

On a tensor-parallel mesh (``tp``, the engine's
``models.gpt.TensorParallel``) each rank's arena holds only the cut of
the slabs its matmul shards meet: ``B``'s columns of the
column-parallel qkv (per q/k/v block) and fc1, ``A``'s rows of the
row-parallel proj and fc2, the other factor whole.  A tenant's factors
are cut once, when it registers, so page-in copies this rank's cut and a
model call reads the slabs as they are.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from ..profiler import counters
from ..profiler import devicetime as _devicetime
from ..resilience import faultinject as _fi

__all__ = ["AdapterArena", "AdapterArenaExhausted", "ADAPTER_TARGETS",
           "ADAPTER_PEEK_TOKENS", "random_lora_factors"]

#: the adapted matmuls, in slab order (matches ``gpt._mm_lora`` names).
ADAPTER_TARGETS = ("qkv_w", "proj_w", "fc1_w", "fc2_w")

#: router cost-model bonus (in tokens) for a replica whose arena already
#: holds the request's adapter: what a cold page-in costs in queue-delay
#: terms, in the currency of the prefix-cache peek.
ADAPTER_PEEK_TOKENS = 32


class AdapterArenaExhausted(RuntimeError):
    """Adapter acquisition refused: every tenant slot is referenced by a
    running request (or the ``adapter_load_drop`` fault fired mid
    page-in).  The paged engine defers the admission; it never crashes
    the scheduler or strands a refcount."""

    def __init__(self, msg="", needed=0, free=0):
        super().__init__(msg)
        self.needed = int(needed)
        self.free = int(free)


def _target_dims(config):
    H, F = config.hidden_size, config.ffn_hidden_size
    return {"qkv_w": (H, 3 * H), "proj_w": (H, H),
            "fc1_w": (H, F), "fc2_w": (F, H)}


def random_lora_factors(config, rank, seed=0, scale=0.05,
                        targets=ADAPTER_TARGETS):
    """Seeded random LoRA factors for ``config`` (tests, smoke runs): a
    flat ``{"a_<t>": [L, d_in, rank], "b_<t>": [L, rank, d_out]}`` dict of
    fp32 numpy arrays, the same ``RandomState`` draws as the JAX
    package's."""
    rng = np.random.RandomState(seed)
    dims = _target_dims(config)
    L = config.num_layers
    out = {}
    for t in targets:
        di, do = dims[t]
        out["a_" + t] = (rng.standard_normal((L, di, rank))
                        * scale).astype(np.float32)
        out["b_" + t] = (rng.standard_normal((L, rank, do))
                        * scale).astype(np.float32)
    return out


class AdapterArena:
    """Paged device arena of per-tenant LoRA factor slabs.

    ``slots`` tenant slots (row 0 is the base model, so the slab row axis
    is ``slots + 1``), fixed rank ``rank``.  Factors are registered
    host-side (:meth:`register`) and paged into a slot on first
    :meth:`acquire`.  Synchronization is the caller's: the paged engine
    calls every mutating method under its lock, as for the block pool.
    """

    def __init__(self, model, slots, rank, tp=None):
        c = model.config
        if getattr(c, "num_experts", 0) > 0:
            raise ValueError(
                "adapter serving requires a dense FFN (num_experts == 0): "
                "the MoE expert matmuls have no LoRA epilogue")
        if int(slots) < 1:
            raise ValueError(f"adapter_slots must be >= 1, got {slots}")
        if int(rank) < 1:
            raise ValueError(f"adapter_rank must be >= 1, got {rank}")
        self.model = model
        self.slots = int(slots)
        self.rank = int(rank)
        self.peek_tokens = ADAPTER_PEEK_TOKENS
        self._dims = _target_dims(c)
        self._dt = model.wte.dtype
        self._tp = tp
        L, R, rows = c.num_layers, self.rank, self.slots + 1
        shapes = {}
        for t in ADAPTER_TARGETS:
            di, do = self._dims[t]
            shapes["a_" + t] = torch.empty((L, rows, di, R), device="meta")
            shapes["b_" + t] = torch.empty((L, rows, R, do), device="meta")
        self._slabs = {n: torch.zeros(v.shape, dtype=self._dt,
                                      device=model.device)
                       for n, v in self._local(shapes).items()}
        self._registry = {}             # tenant -> padded host factors
        self._resident = OrderedDict()  # tenant -> slot, LRU order
        self._refs = {}                 # tenant -> live request count
        # LIFO free list, lowest slot ids handed out first (determinism;
        # mirrors BlockPool)
        self._free = list(range(rows - 1, 0, -1))
        self.hits = 0
        self.misses = 0
        self.loads = 0
        self.evictions = 0
        self.exhausted_events = 0
        self.load_drops = 0
        counters.set_gauge("serving.adapter.arena_bytes",
                           self.device_bytes())

    # -- host registry -------------------------------------------------------
    def _pad(self, tenant, factors):
        """Validate and rank-pad one tenant's factor dict into CPU tensors
        of the model dtype.  Accepts a flat ``{"a_<t>": [L, d_in, r],
        "b_<t>": [L, r, d_out]}`` with any subset of targets (a missing
        pair leaves that matmul un-adapted: its slab rows stay zero);
        zero-padding ``r -> R`` on the contracted axis is exact."""
        c = self.model.config
        L, R = c.num_layers, self.rank
        known = {f"{p}_{t}" for t in ADAPTER_TARGETS for p in "ab"}
        extra = set(factors) - known
        if extra:
            raise ValueError(
                f"adapter {tenant!r}: unknown factor keys {sorted(extra)}")
        out = {}
        for t in ADAPTER_TARGETS:
            di, do = self._dims[t]
            a, b = factors.get("a_" + t), factors.get("b_" + t)
            if (a is None) != (b is None):
                raise ValueError(
                    f"adapter {tenant!r}: target {t!r} needs both "
                    f"a_{t} and b_{t}")
            ap = torch.zeros((L, di, R), dtype=self._dt)
            bp = torch.zeros((L, R, do), dtype=self._dt)
            if a is not None:
                a = torch.as_tensor(np.asarray(a, np.float32))
                b = torch.as_tensor(np.asarray(b, np.float32))
                r = a.shape[-1] if a.dim() == 3 else -1
                if tuple(a.shape) != (L, di, r) or \
                        tuple(b.shape) != (L, r, do) or not 1 <= r <= R:
                    raise ValueError(
                        f"adapter {tenant!r}: target {t!r} expects "
                        f"a [L={L}, {di}, r<= {R}] and b [L, r, {do}], got "
                        f"{tuple(a.shape)} / {tuple(b.shape)}")
                ap[:, :, :r] = a
                bp[:, :r, :] = b
            out["a_" + t] = ap
            out["b_" + t] = bp
        return self._local(out)

    def _local(self, factors):
        """This rank's cut of a factor or slab dict (``TensorParallel.
        lora_local``), the dict itself without a mesh."""
        return factors if self._tp is None else self._tp.lora_local(factors)

    def register(self, tenant, factors):
        """Install (or replace) one tenant's host-side factors.  A
        resident but idle tenant is evicted, so the next acquire pages in
        the new weights; replacing a tenant a running request still
        references is refused."""
        if tenant is None or tenant == 0:
            raise ValueError("tenant id None/0 is the base model")
        if self._refs.get(tenant, 0) > 0:
            raise ValueError(
                f"adapter {tenant!r} is referenced by "
                f"{self._refs[tenant]} running request(s); drain before "
                "re-registering")
        padded = self._pad(tenant, factors)
        slot = self._resident.pop(tenant, None)
        if slot is not None:
            self._refs.pop(tenant, None)
            self._free.append(slot)
            counters.set_gauge("serving.adapter.resident",
                               len(self._resident))
        self._registry[tenant] = padded

    # -- slot lifecycle ------------------------------------------------------
    def _take_slot(self):
        if self._free:
            return self._free.pop()
        victim = next((t for t in self._resident
                       if self._refs.get(t, 0) == 0), None)
        if victim is None:
            return None
        slot = self._resident.pop(victim)
        self._refs.pop(victim, None)
        self.evictions += 1
        counters.inc("serving.adapter.evictions")
        counters.set_gauge("serving.adapter.resident", len(self._resident))
        return slot

    def acquire(self, tenant, rid=None):
        """Pin ``tenant``'s factors for one request; returns its slot id
        (the row the request's ``adapter_ids`` carry).  ``None`` is the
        base model: slot 0, never refcounted.  Raises
        :class:`AdapterArenaExhausted` (nothing allocated, no refcount
        moved) when the arena cannot host the tenant, and ``KeyError``
        for an unregistered tenant."""
        if tenant is None:
            return 0
        factors = self._registry.get(tenant)
        if factors is None:
            raise KeyError(f"adapter {tenant!r} is not registered")
        slot = self._resident.get(tenant)
        if slot is not None:
            self._refs[tenant] = self._refs.get(tenant, 0) + 1
            self._resident.move_to_end(tenant)
            self.hits += 1
            counters.inc("serving.adapter.hits")
            return slot
        self.misses += 1
        counters.inc("serving.adapter.misses")
        slot = self._take_slot()
        if slot is None:
            self.exhausted_events += 1
            counters.inc("serving.adapter.arena_exhausted")
            raise AdapterArenaExhausted(
                f"adapter arena full: all {self.slots} slots referenced",
                needed=1, free=0)
        if rid is not None and _fi.take("adapter_load_drop", rid):
            # injected page-in failure BEFORE any slab write: the slot
            # goes back untouched and the request is deferred
            self._free.append(slot)
            self.load_drops += 1
            counters.inc("serving.adapter.load_drops")
            raise AdapterArenaExhausted(
                f"injected adapter_load_drop for tenant {tenant!r}",
                needed=1, free=len(self._free))
        _dt = _devicetime.note("serving.adapter.load")
        for n, v in factors.items():
            self._slabs[n][:, slot].copy_(v)
        _devicetime.observe(_dt, self._slabs)
        self._resident[tenant] = slot
        self._refs[tenant] = 1
        self.loads += 1
        counters.inc("serving.adapter.loads")
        counters.set_gauge("serving.adapter.resident", len(self._resident))
        return slot

    def release(self, tenant):
        """Drop one request's reference; the tenant stays resident (an
        LRU eviction candidate at refcount 0) so a follow-up request
        reuses the warm slot."""
        if tenant is None:
            return
        r = self._refs.get(tenant, 0)
        if r <= 0:
            raise ValueError(f"release of unreferenced adapter {tenant!r}")
        self._refs[tenant] = r - 1

    # -- dispatch / routing views -------------------------------------------
    def slabs(self):
        """The slab dict a model call reads (``a_<t>`` / ``b_<t>``, as
        ``gpt._mm_lora`` expects)."""
        return self._slabs

    def peek(self, tenant):
        """``peek_tokens`` when the tenant is already resident here (a
        dispatch here skips a cold page-in), else 0."""
        if tenant is None or tenant not in self._resident:
            return 0
        return self.peek_tokens

    def device_bytes(self):
        return sum(t.nbytes for t in self._slabs.values() if t is not None)

    def release_slabs(self):
        self._slabs = {n: None for n in self._slabs}

    def stats(self):
        return {
            "slots": self.slots,
            "rank": self.rank,
            "resident": len(self._resident),
            "registered": len(self._registry),
            "tenants": {t: self._refs.get(t, 0) for t in self._resident},
            "loads": self.loads,
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "exhausted": self.exhausted_events,
            "load_drops": self.load_drops,
            "arena_bytes": self.device_bytes(),
        }
