"""Speculative decoding over the shared paged KV pools (port of
``paddle_tpu/serving/speculative.py``; constructed by
``LLMEngine(model, draft_model=...)``).

A small draft model proposes K tokens one decode step at a time
(``decode_paged``, the paged decode kernel K4 — K4q with ``kv_dtype`` —
at the draft's head shape); the target scores the committed token and
the K proposals in one pass (``GPTForCausalLM.verify_paged``), and
:func:`_acceptance` keeps a prefix of the draft plus one correction or
bonus token.  A round yields 1..K+1 tokens a running slot.

* **Greedy** — a proposal is accepted while it equals the target's
  argmax at the position before it; the first mismatch emits the
  argmax.  The tokens are the target's own greedy chain, those of the
  paged engine and of ``generate``, whatever the draft proposes.
* **Sampling** — modified rejection sampling (Leviathan et al., ICML
  2023): proposal ``x ~ q`` is accepted when ``u * q(x) < p(x)``; on
  rejection the correction is drawn from ``norm(max(0, p - q))``
  (``sampling.residual_sample``), after a clean sweep a bonus token from
  ``p``.  The output distribution is the target's.  The verify draws
  come from the request's generator, the proposals from a second one
  seeded from the request's seed and :data:`DRAFT_SEED_SALT`.

Memory: both models' K/V blocks come from the one ``BlockPool``.  A block
id indexes the target pools or the draft pools ``[L_d, n_blocks, bs,
nh_d, hd_d]`` depending on whose table holds it, and draft blocks are
never donated to the prefix tree.  The target's table is reserved whole
at admission, as in ``PagedLLMEngine`` (``n_valid`` caps the verify
writes to it); the draft's table grows ahead of each round and is
rolled back after a rejection by truncating the table (stale K/V is
masked until a later write overwrites it, so nothing is copied).

On a mesh (``mesh=``) the draft's weights and pools are declared on the
engine's ``StateArena`` beside the target's: they split over ``mp``
when the draft's heads divide it (each draft step launches K4/K4q on
the rank's slice of the draft's heads) and degrade to replicated
otherwise (``serving.mesh.spec_degraded``).  Every rank drafts and
verifies the same rows; each draft step's proposals and each round's
accepted block and its length are rank 0's, broadcast
(``LLMEngine._agree``), so a sampled row whose generators differ
between ranks still takes one outcome everywhere.

LoRA adapters: the draft proposes on the base model and the verify pass
scores under each row's adapter, so acceptance keeps the tenant's
distribution.  KV migration: the draft namespace never migrates; an
adopted request's committed sequence is re-prefilled into this engine's
draft pools (:meth:`SpeculativeLLMEngine._adopt_extra`).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..kernels.paged_attention import KV_DTYPES
from ..profiler import counters
from ..profiler import devicetime as _devicetime
from ..profiler import flight
from ..profiler import trace as rtrace
from ..profiler.host_tracer import span
from ..quantization import ptq_int8_decode_state
from .engine import bucket_length, prompt_ids
from .kvcache import blocks_for_tokens
from .paged import PagedLLMEngine
from .sampling import filter_logits, residual_sample

__all__ = ["SpeculativeLLMEngine"]

#: XOR-ed into a request's seed (< 2**31) to seed its draft generator: a
#: stream of its own, never another request's verify stream
DRAFT_SEED_SALT = 0x5BEC << 32


def _filtered_probs(logits, req):
    """The distribution a request samples from: softmax of ``logits[...,
    V]`` filtered by the request's temperature, top-k and top-p."""
    return torch.softmax(filter_logits(logits, req.temperature, req.top_k,
                                       req.top_p), dim=-1)


def _acceptance(logits, toks, q, nv, reqs):
    """Distribution-preserving acceptance over one verified draft block.

    ``logits[B, K1, V]`` are the target's scores at every position,
    ``toks[B, K1]`` the committed token and K proposals, ``q[B, K, V]``
    the draft's filtered proposal distributions (read for sampled rows
    only; None when no row samples), ``nv[B]`` (device) the valid
    positions of each row, ``reqs[B]`` the request of each row (None for
    an idle row).  Returns ``(emit[B, K1], n_emit[B])`` on the device:
    ``emit[b, :n_emit[b]]`` is the row's accepted prefix plus its
    correction or bonus token.

    A proposal is *considered* inside the row's budget (``j < nv - 1``)
    and before its first rejection; only a failed test rejects, so a
    truncated round (``nv < K1``: a request's last tokens, a draft-starved
    row) still draws its last token from ``p``, never from the residual.
    A sampled row draws, from its request's generator, K uniforms, then a
    residual and a bonus token (both, so the stream does not depend on
    the outcome)."""
    B, K1, V = logits.shape
    K = K1 - 1
    dev = logits.device
    greedy = logits.argmax(dim=-1)                                # [B, K1]
    ok = toks[:, 1:] == greedy[:, :K]                             # [B, K]
    j = torch.arange(K, device=dev)
    sampled = {}
    for b, req in enumerate(reqs):
        if req is None or not req.do_sample:
            continue
        p = _filtered_probs(logits[b], req)                       # [K1, V]
        u = torch.rand(K, generator=req.generator, device=dev)
        tok = toks[b, 1:].long()
        ok[b] = u * q[b, j, tok] < p[j, tok]
        sampled[b] = p
    # accepted: the leading run of passed tests inside the budget; a row
    # that stopped short of its budget failed a test
    in_budget = j[None, :] < (nv[:, None] - 1)
    acc = torch.cumprod((ok & in_budget).long(), dim=1).sum(dim=1)  # [B]
    rej = acc < nv - 1
    t_fin = greedy[torch.arange(B, device=dev), acc]
    for b, p in sampled.items():
        # index with one-element tensors: a 0-d index would read the
        # device value back to the host
        a = acc[b:b + 1]
        gen = reqs[b].generator
        pin = p[a][0]
        t_res = residual_sample(pin, q[b][a.clamp(max=K - 1)][0], gen)
        t_bonus = torch.multinomial(pin, 1, generator=gen)[0]
        t_fin[b] = torch.where(rej[b], t_res, t_bonus)
    tpad = torch.cat([toks[:, 1:].long(),
                      torch.zeros((B, 1), dtype=torch.long, device=dev)], 1)
    idx = torch.arange(K1, device=dev)[None, :]
    emit = torch.where(idx < acc[:, None], tpad,
                       torch.where(idx == acc[:, None], t_fin[:, None], 0))
    return emit, acc + 1


class SpeculativeLLMEngine(PagedLLMEngine):
    """``PagedLLMEngine`` with draft/verify speculative decoding.

    Extra knobs:

    * ``draft_model`` — the proposal ``GPTForCausalLM`` (the target's
      vocab and device; layers, width and heads are free).  Required.
    * ``spec_k`` — proposals drafted per scheduler round (default 4).

    ``weight_dtype="int8"`` quantizes the draft's weights as well;
    ``kv_dtype`` quantizes both models' pools.
    """

    def __init__(self, model, *args, **kw):
        draft = kw.pop("draft_model", None)
        if draft is None:
            raise ValueError("SpeculativeLLMEngine requires draft_model=")
        if kw.get("kv_layout", "paged") != "paged":
            raise ValueError(
                "draft_model= requires kv_layout='paged' (speculative "
                "decoding runs over the block pools)")
        kw["kv_layout"] = "paged"
        k = int(kw.pop("spec_k", 4))
        if k < 1:
            raise ValueError(f"spec_k must be >= 1, got {k}")
        if draft.config.vocab_size != model.config.vocab_size:
            raise ValueError(
                f"draft vocab ({draft.config.vocab_size}) != target vocab "
                f"({model.config.vocab_size}); speculative acceptance "
                "compares the two distributions token for token")
        if draft.device != model.device:
            raise ValueError(f"draft model on {draft.device}, target on "
                             f"{model.device}: both must share a device")
        self.draft_model = draft
        self.spec_k = k
        super().__init__(model, *args, **kw)

    # -- construction --------------------------------------------------------
    def _init_kv(self, c, B, S, nh, hd):
        draft = self.draft_model
        dc = draft.config
        if not dc.use_rope and S > dc.max_seq_len:
            raise ValueError(
                f"max_seq_len {S} exceeds the draft model's "
                f"learned-position table ({dc.max_seq_len})")
        super()._init_kv(c, B, S, nh, hd)
        # declared on the arena like the target's: this rank's shards
        # under a mesh (the draft's own head split), themselves without
        self._dw = self.arena.declare_tree(
            "draft_weights", ptq_int8_decode_state(draft)
            if self.weight_dtype == "int8" else draft.decode_state(),
            dc.num_heads)
        # the draft's pools share the pool's block ids, not its storage:
        # the same n_blocks/block_size, the draft model's own layer and
        # head shape
        dnh = dc.num_heads
        shape = (dc.num_layers, self.n_blocks, self.pool.block_size, dnh,
                 dc.hidden_size // dnh)
        adt = KV_DTYPES[self.kv_dtype] if self.kv_dtype else draft.wte.dtype
        self.dpool_k = self._kv_zeros("draft_pool_k", shape, adt, self._dw)
        self.dpool_v = self._kv_zeros("draft_pool_v", shape, adt, self._dw)
        self.dscales = ()
        if self.kv_dtype:
            # per-token scales have no head axis: whole on every rank
            self.dscales = tuple(
                self.arena.declare_zeros(n, self.dpool_k.shape[:3],
                                         torch.float32, self.device)
                for n in ("draft_scale_k", "draft_scale_v"))
        self._dbt = np.zeros((B, self.max_blocks), np.int32)
        self._dslot_blocks = [None] * B
        self._dgen = [None] * B       # per-slot draft generator (sampled)
        self._acc_ema = -1.0          # < 0: no drafted round yet
        self._yield_ema = 0.0
        self._spec_drafted = 0
        self._spec_accepted = 0

    # -- request intake ------------------------------------------------------
    def add_request(self, prompt, max_new_tokens=32, **kw):
        ids = prompt_ids(prompt)
        need = blocks_for_tokens(
            max(1, int(ids.shape[0]) + int(max_new_tokens) - 1),
            self.pool.block_size)
        if 2 * need > self.pool.capacity:
            raise ValueError(
                f"request needs {need} KV blocks in each of the target and "
                f"draft namespaces but the shared pool only has "
                f"{self.pool.capacity} (n_blocks={self.n_blocks}, "
                f"block_size={self.pool.block_size})")
        return super().add_request(ids, max_new_tokens=max_new_tokens, **kw)

    def _reserve(self, req, events):
        """Reserve the draft's prompt blocks beside the target's
        all-or-nothing reservation: both tables are covered or nothing is
        allocated (the draft's decode-ahead blocks grow per round, see
        :meth:`_grow_draft_tables`)."""
        T = int(req.prompt.shape[0])
        dneed = blocks_for_tokens(max(1, T), self.pool.block_size)
        with self._cond:
            short = dneed - self.pool.free_blocks
            if short > 0 and self.prefix is not None:
                self.kv_blocks_evicted += self.prefix.evict(short)
            if dneed > self.pool.free_blocks:
                self.kv_pool_exhausted_events += 1
                counters.inc("serving.kv.pool_exhausted")
                flight.record("serving.kv.pool_exhausted", rid=req.rid,
                              needed=dneed, free=self.pool.free_blocks,
                              injected=False)
                return False
            dblocks = self.pool.alloc_n(dneed)
        if not super()._reserve(req, events):
            with self._cond:
                for b in dblocks:
                    self.pool.release(b)
            return False
        with self._cond:
            s = req.slot
            self._dslot_blocks[s] = dblocks
            self._dbt[s] = 0
            self._dbt[s, :len(dblocks)] = dblocks
        return True

    # -- chunked prefill (both namespaces) -----------------------------------
    def _draft_prefill_tokens(self, slot, tokens, start):
        """One draft prefill chunk over ``tokens[start:]`` into the draft
        pools (no prefix reuse: the tree's blocks hold target K/V); the
        chunk's logits are not used.  Returns the new prefilled count."""
        remaining = int(len(tokens)) - start
        C = bucket_length(min(remaining, self.prefill_chunk),
                          self.min_bucket, self.prefill_chunk)
        take_n = min(remaining, C)
        ids = np.zeros((1, C), np.int64)
        ids[0, :take_n] = tokens[start:start + take_n]
        dev = self.device
        with span("serving.spec.draft_prefill"):
            _dt = _devicetime.note(
                f"{self._prog_key('serving.draft_prefill_paged')}[c{C}]")
            self.draft_model.prefill_paged(
                self._dw, torch.from_numpy(ids).to(dev), start, take_n,
                torch.from_numpy(self._dbt[slot]).to(dev), self.dpool_k,
                self.dpool_v, *self.dscales)
            _devicetime.observe(_dt, self.dpool_k)
        counters.inc("serving.spec.draft_prefill_chunks")
        return start + take_n

    def _run_chunk(self, slot, st, events):
        req = st["req"]
        T = int(req.prompt.shape[0])
        start = st["done"]
        C = bucket_length(min(T - start, self.prefill_chunk),
                          self.min_bucket, self.prefill_chunk)
        target_next = start + min(T - start, C)
        # the draft gets no prefix-cache head start, so it may owe several
        # chunks after a prefix hit: keep it level with the target
        while st.setdefault("ddone", 0) < target_next:
            st["ddone"] = self._draft_prefill_tokens(slot, req.prompt,
                                                     st["ddone"])
        super()._run_chunk(slot, st, events)
        if slot not in self._prefill_state and req.do_sample:
            # prefill done: the draft's own stream, independent of the
            # verify stream (acceptance corrects whatever it proposes)
            self._dgen[slot] = torch.Generator(device=self.device).manual_seed(
                req.seed ^ DRAFT_SEED_SALT)

    # -- KV migration --------------------------------------------------------
    def _adopt_extra(self, slot, req, mig):
        """Rebuild the draft namespace for a migrated request: its draft
        KV never rides a migration, so the committed sequence is
        re-prefilled into this engine's draft pools (ceil(pos / chunk)
        chunks).  A pool that cannot cover the draft table leaves the row
        draft-starved (plain decode, ``serving.spec.draft_starved``).
        Caller holds ``_cond``."""
        pos = int(mig["pos"])
        dneed = blocks_for_tokens(max(pos, 1), self.pool.block_size)
        short = dneed - self.pool.free_blocks
        if short > 0 and self.prefix is not None:
            self.kv_blocks_evicted += self.prefix.evict(short)
        if dneed > self.pool.free_blocks:
            self._dslot_blocks[slot] = None
            self._dbt[slot] = 0
            counters.inc("serving.spec.draft_starved")
            return
        dblocks = self.pool.alloc_n(dneed)
        self._dslot_blocks[slot] = dblocks
        self._dbt[slot] = 0
        self._dbt[slot, :len(dblocks)] = dblocks
        seq = np.concatenate(
            [mig["prompt"], np.asarray(mig["tokens"], np.int32)])[:pos]
        done = 0
        while done < pos:
            done = self._draft_prefill_tokens(slot, seq, done)
        if req.do_sample:
            self._dgen[slot] = torch.Generator(device=self.device).manual_seed(
                req.seed ^ DRAFT_SEED_SALT)

    # -- the draft/verify round ----------------------------------------------
    def _grow_draft_tables(self, nv):
        """Extend each running row's draft table to cover this round's
        draft writes (positions ``pos .. pos + nv - 1``).  A row the pool
        cannot cover, or whose table is gone, is downgraded to ``nv = 1``
        with drafting skipped (``serving.spec.draft_starved``): the
        verify pass still emits its one plain-decode token, so starvation
        costs throughput, never correctness.  Returns the per-row
        draft-ready mask."""
        bs = self.pool.block_size
        dready = np.zeros(self.max_slots, np.bool_)
        with self._cond:
            for s in range(self.max_slots):
                if not self._running[s]:
                    continue
                tbl = self._dslot_blocks[s]
                if tbl is None:
                    nv[s] = 1
                    counters.inc("serving.spec.draft_starved")
                    continue
                need = blocks_for_tokens(int(self._pos[s]) + int(nv[s]), bs)
                grow = need - len(tbl)
                if grow > 0:
                    short = grow - self.pool.free_blocks
                    if short > 0 and self.prefix is not None:
                        self.kv_blocks_evicted += self.prefix.evict(short)
                    if grow > self.pool.free_blocks:
                        nv[s] = 1
                        counters.inc("serving.spec.draft_starved")
                        continue
                    fresh = self.pool.alloc_n(grow)
                    self._dbt[s, len(tbl):need] = fresh
                    tbl.extend(fresh)
                dready[s] = True
        return dready

    def _rollback_draft(self, s):
        """Truncate the row's draft table to its committed length and
        release the blocks that held only rejected proposals — no device
        copies: stale K/V in a kept block is masked until overwritten."""
        tbl = self._dslot_blocks[s]
        if tbl is None:
            return
        keep = blocks_for_tokens(max(int(self._pos[s]), 1),
                                 self.pool.block_size)
        if len(tbl) <= keep:
            return
        with self._cond:
            drop = tbl[keep:]
            del tbl[keep:]
            self._dbt[s, keep:] = 0
            for b in drop:
                self.pool.release(b)
        counters.inc("serving.spec.rollback_blocks", len(drop))

    def _spec_note_round(self, drafted, accepted, emitted, n_active):
        with self._cond:
            self._spec_drafted += drafted
            self._spec_accepted += accepted
            if drafted > 0:
                rate = accepted / drafted
                self._acc_ema = (rate if self._acc_ema < 0 else
                                 self._ema_alpha * rate
                                 + (1 - self._ema_alpha) * self._acc_ema)
            y = emitted / max(n_active, 1)
            self._yield_ema = (y if self._yield_ema <= 0 else
                               self._ema_alpha * y
                               + (1 - self._ema_alpha) * self._yield_ema)
            acc_g, yld_g = max(self._acc_ema, 0.0), self._yield_ema
        counters.set_gauge("serving.spec.acceptance", acc_g)
        counters.set_gauge("serving.spec.yield", yld_g)

    def _draft_step(self, tok, pos, bt, reqs):
        """One draft decode step (``decode_paged``: K4, or K4q over
        quantized pools) and the proposal draw: argmax for greedy rows,
        a draw from the filtered distribution ``q`` with the row's draft
        generator for sampled rows; on a mesh the proposals are rank
        0's.  Returns ``(proposals [B], q [B, V] or None when no row
        samples)``."""
        _dt = _devicetime.note(self._prog_key("serving.draft_paged"))
        logits = self.draft_model.decode_paged(
            self._dw, tok, pos, bt, self.dpool_k, self.dpool_v,
            *self.dscales)
        _devicetime.observe(_dt, logits)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        q = None
        for b, req in enumerate(reqs):
            if req is None or not req.do_sample:
                continue
            if q is None:
                q = torch.zeros_like(logits)
            q[b] = _filtered_probs(logits[b], req)
            nxt[b] = torch.multinomial(q[b], 1, generator=self._dgen[b])[0]
        return self._agree(nxt), q

    def _decode_step(self, events):
        """One speculative round for every running slot: K+1 draft steps
        (K proposals and one that writes the last proposal's draft K/V,
        so the draft pools have no holes after a clean sweep), one verify
        pass with the acceptance rule, then host bookkeeping: emit the
        accepted block, advance positions by each row's yield, roll the
        draft tables back past rejections."""
        active = [(s, r) for s, r in enumerate(self._slots)
                  if r is not None and r.state == "running"]
        if not active:
            return
        self._observe("serving.decode_occupancy",
                      len(active) / self.max_slots)
        K1 = self.spec_k + 1
        nv = np.ones(self.max_slots, np.int32)
        for s, r in active:
            # at most the row's remaining token budget: keeps the verify
            # writes inside the admission reservation
            nv[s] = min(K1, max(r.max_new_tokens - len(r.tokens), 1))
        pos0 = np.where(self._running, self._pos, 0).astype(np.int32)
        t0 = time.perf_counter()
        dready = self._grow_draft_tables(nv)
        reqs = [None] * self.max_slots
        for s, r in active:
            reqs[s] = r
        dreqs = [r if dready[s] else None for s, r in enumerate(reqs)]
        dev = self.device
        t0_tr = time.perf_counter_ns() if rtrace.enabled() else 0
        with span("serving.spec.round"):
            cur = torch.from_numpy(self._tok).to(dev)
            ts, qs = [cur], []
            for j in range(K1):
                part = self._running & dready & (nv > j)
                bt_j = np.where(part[:, None], self._dbt, 0).astype(np.int32)
                pos_j = np.where(part, pos0 + j, 0).astype(np.int32)
                cur, q = self._draft_step(
                    cur, torch.from_numpy(pos_j).to(dev),
                    torch.from_numpy(bt_j).to(dev), dreqs)
                if j < K1 - 1:
                    ts.append(cur)
                    qs.append(q)
            counters.inc("serving.spec.draft_steps", K1)
            bt_eff = np.where(self._running[:, None], self._bt, 0).astype(
                np.int32)
            toks = torch.stack(ts, dim=1)
            nv_t = torch.from_numpy(nv).to(dev)
            _dt = _devicetime.note(
                self._prog_key(f"serving.verify_paged[k{self.spec_k}]"))
            logits = self.model.verify_paged(
                self._w, toks, torch.from_numpy(pos0).to(dev), nv_t,
                torch.from_numpy(bt_eff).to(dev), *self._pools(),
                **self._adapter_args(np.where(self._running, self._aid, 0)))
            _devicetime.observe(_dt, logits)
            q = None
            if any(r is not None and r.do_sample for r in reqs):
                # no q from the draft: every sampled row is draft-starved
                # (nv = 1) and reads none
                q = torch.stack([torch.zeros_like(logits[:, 0]) if x is None
                                 else x for x in qs], dim=1)
            emit, n_emit = _acceptance(logits, toks, q, nv_t, reqs)
            # the one read-back of the round: on a mesh rank 0's accepted
            # blocks and their lengths, which every rank then applies
            out = self._agree(torch.cat([emit, n_emit[:, None]],
                                        dim=1)).cpu().numpy()
            emit, n_emit = out[:, :-1], out[:, -1]
        self._trace_decode(active, t0_tr)
        counters.inc("serving.spec.verify_steps")
        counters.inc("serving.decode_steps")
        emitted = int(sum(int(n_emit[s]) for s, _ in active))
        self._note_decode(emitted, time.perf_counter() - t0)
        counters.inc("serving.decode_tokens", emitted)
        if self.kv_dtype:
            counters.inc("serving.kv.quant.decode_tokens", emitted)
        drafted = int(sum(int(nv[s]) - 1 for s, _ in active))
        accepted = int(sum(int(n_emit[s]) - 1 for s, _ in active))
        if drafted:
            counters.inc("serving.spec.drafted", drafted)
            counters.inc("serving.spec.accepted", accepted)
            counters.inc("serving.spec.rejected", drafted - accepted)
        self._spec_note_round(drafted, accepted, emitted, len(active))
        for s, req in active:
            n = int(n_emit[s])
            self._tok[s] = int(emit[s, n - 1])
            self._pos[s] += n
            self._rollback_draft(s)
            for i in range(n):
                if req.state != "running":   # EOS landed mid-block
                    break
                self._emit(req, int(emit[s, i]), events)

    # -- teardown / stats ----------------------------------------------------
    def release_kv(self):
        super().release_kv()
        self.dpool_k = self.dpool_v = None
        self.dscales = ()
        self.arena.release("draft_pool_k", "draft_pool_v", "draft_scale_k",
                           "draft_scale_v")

    def _release_slot_kv(self, slot, req, reason):
        super()._release_slot_kv(slot, req, reason)
        dbl = self._dslot_blocks[slot]
        self._dslot_blocks[slot] = None
        self._dbt[slot] = 0
        self._dgen[slot] = None
        # never donated to the prefix tree: its blocks hold target K/V
        for b in dbl or ():
            self.pool.release(b)

    def stats(self):
        with self._cond:
            st = super().stats()
            st.update({
                "speculative": True,
                "spec_k": self.spec_k,
                "spec_acceptance_ema": (None if self._acc_ema < 0
                                        else self._acc_ema),
                "spec_yield_ema": self._yield_ema,
                "spec_drafted": self._spec_drafted,
                "spec_accepted": self._spec_accepted,
                "draft_kv_pool_bytes_per_chip": self.arena.device_bytes(
                    "draft_pool_k", "draft_pool_v", "draft_scale_k",
                    "draft_scale_v"),
                "draft_weight_bytes_per_chip": self.arena.device_bytes(
                    "draft_weights"),
            })
        return st
