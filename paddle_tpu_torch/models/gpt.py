"""GPT causal LM — the training forward and the serving entry points
(port of ``paddle_tpu/models/gpt.py``).

The parameters keep the reference's stacked ``[L, ...]`` layout and
names (``wte``, ``wpe``, ``ln1_w``, ``qkv_w [L, H, 3H]``, ...), so a JAX
``state_dict`` loads one to one (:meth:`GPTForCausalLM.load_numpy_state`).
A plain Python loop over layers replaces ``lax.scan``.

Training: :meth:`GPTForCausalLM.forward` returns logits in the model
dtype; attention goes through ``kernels.flash_attention`` (the CUDA
kernels K1–K3 on a CUDA device), recompute through
``torch.utils.checkpoint``.  :class:`GPTPretrainingCriterion` is the
fp32 causal-LM loss.

Serving: the paged KV pools ``[L, n_blocks, bs, nh, hd]`` are updated
**in place** (``index_put_``) by :meth:`GPTForCausalLM.prefill_paged`
and :meth:`GPTForCausalLM.decode_paged`; this replaces the JAX package's
donation of the pools through every program.  Decode attention goes
through the CUDA kernel ``kernels/paged_attention`` on a CUDA device.
Quantized KV (int8/fp8 pools with per-token fp32 scale pools ``[L,
n_blocks, bs]``) quantizes on insert; decode attends through the
kernel's quantized variant, prefill over the dequantized gather.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..kernels import paged_attention as _pa
from ..kernels._shapes import NEG_INF
from ..kernels.flash_attention import flash_attention_fwd, reference_attention
from ..kernels.rope import apply_rope


class GPTConfig:
    def __init__(self, vocab_size=50304, hidden_size=768, num_layers=12,
                 num_heads=12, max_seq_len=1024, ffn_hidden_size=None,
                 dropout=0.0, attention_dropout=0.0, use_rope=False,
                 layer_norm_epsilon=1e-5, initializer_range=0.02,
                 use_flash_attention=True, recompute=False,
                 sequence_parallel=False, context_parallel=False,
                 num_experts=0, moe_every=2,
                 moe_top_k=2, moe_capacity_factor=1.25,
                 moe_aux_weight=0.01, dtype="float32",
                 tie_word_embeddings=True,
                 pp_schedule="gpipe", virtual_pp_degree=1):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.max_seq_len = max_seq_len
        self.ffn_hidden_size = ffn_hidden_size or 4 * hidden_size
        self.dropout = dropout
        self.attention_dropout = attention_dropout
        self.use_rope = use_rope
        self.layer_norm_epsilon = layer_norm_epsilon
        self.initializer_range = initializer_range
        self.use_flash_attention = use_flash_attention
        self.recompute = recompute
        self.sequence_parallel = sequence_parallel
        self.context_parallel = context_parallel
        self.num_experts = num_experts
        self.moe_every = moe_every
        self.moe_top_k = moe_top_k
        self.moe_capacity_factor = moe_capacity_factor
        self.moe_aux_weight = moe_aux_weight
        self.dtype = dtype
        self.tie_word_embeddings = tie_word_embeddings
        self.pp_schedule = pp_schedule
        self.virtual_pp_degree = virtual_pp_degree

    # named sizes from the GPT-3 paper / reference recipes
    @staticmethod
    def gpt3_125m(**kw):
        return GPTConfig(hidden_size=768, num_layers=12, num_heads=12, **kw)

    @staticmethod
    def gpt3_350m(**kw):
        return GPTConfig(hidden_size=1024, num_layers=24, num_heads=16, **kw)

    @staticmethod
    def gpt3_760m(**kw):
        return GPTConfig(hidden_size=1536, num_layers=24, num_heads=16, **kw)

    @staticmethod
    def gpt3_1_3b(**kw):
        return GPTConfig(hidden_size=2048, num_layers=24, num_heads=16, **kw)

    @staticmethod
    def gpt3_6_7b(**kw):
        return GPTConfig(hidden_size=4096, num_layers=32, num_heads=32, **kw)


#: model dtypes the serving path (and its decode kernel) takes
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

#: per-layer parameters stacked on a leading [L] axis
_STACKED = ("ln1_w", "ln1_b", "qkv_w", "qkv_b", "proj_w", "proj_b",
            "ln2_w", "ln2_b", "fc1_w", "fc1_b", "fc2_w", "fc2_b")


def _norm(x, w, b, eps):
    """LayerNorm in fp32, cast back to the input dtype, then ``* w + b``
    in that dtype (the reference's order, which matters in bf16)."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, unbiased=False)
    return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype) * w + b


def _dropout(x, p, seed):
    """Inverted dropout with the keep mask drawn from a generator seeded
    with ``seed``: a recomputed segment draws the same mask again.  (The
    JAX package draws from ``jax.random`` keys: the streams differ, the
    distribution is the same.)"""
    gen = torch.Generator(device=x.device).manual_seed(seed)
    keep = torch.rand(x.shape, generator=gen, device=x.device) < 1 - p
    return torch.where(keep, x / (1 - p), 0.0).to(x.dtype)


#: recompute modes (JAX ``_sel_policy``): which block activations survive
#: to the backward; everything else replays from them.
_RECOMPUTE = (False, True, "selective", "selective_lean")


def _lm_logits(c, wte, lnf_w, lnf_b, head, h_last):
    """Final norm + LM head in the model dtype, then fp32 logits."""
    h_last = _norm(h_last, lnf_w, lnf_b, c.layer_norm_epsilon)
    w = wte.T if c.tie_word_embeddings else head
    return torch.matmul(h_last, w).float()


def _rope_rows(x, pos, base=10000.0):
    """apply_rope for single-token rows ``x[B, 1, nh, hd]`` sitting at
    per-row positions ``pos[B]``."""
    b, s, h, d = x.shape
    inv = 1.0 / (base ** (torch.arange(0, d, 2, dtype=torch.float32,
                                       device=x.device) / d))
    freqs = pos.float()[:, None] * inv[None, :]               # [B, d/2]
    sin = torch.sin(freqs)[:, None, None, :]
    cos = torch.cos(freqs)[:, None, None, :]
    xf = x.float()
    x1, x2 = xf[..., : d // 2], xf[..., d // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return out.to(x.dtype)


def _mm(x, lw, name):
    """Layer matmul against a decode-state weight that may be int8
    weight-only quantized (``quantization.ptq_int8_decode_state`` stores
    ``name`` as int8 plus ``name + "__scale"`` fp32 per-output-channel).
    Per-output-channel scales commute with the contraction, so dequant is
    one row-vector multiply after the product, promoted to fp32 and cast
    back to ``x``'s dtype, as the reference does.  The int8 weight is
    widened to ``x``'s dtype exactly (|q| <= 127), but eagerly: a
    full-precision copy per call, which XLA fuses into the dot on the
    TPU (see PERF.md)."""
    w = lw[name]
    s = lw.get(name + "__scale")
    if s is None:
        return torch.matmul(x, w)
    return (torch.matmul(x, w.to(x.dtype)) * s).to(x.dtype)


def _resolve_device(device):
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "paddle_tpu_torch runs on a CUDA device and none is "
                "available; pass device='cpu' to run on the CPU explicitly")
        return torch.device("cuda")
    return torch.device(device)


class GPTForCausalLM(nn.Module):
    """GPT causal LM with stacked ``[L, ...]`` parameters.

    ``device=None`` picks ``cuda`` and raises ``RuntimeError`` when no
    GPU is present; pass ``device="cpu"`` to run on the CPU.  Weights are
    drawn from ``generator`` (default: a CPU ``torch.Generator`` seeded
    with 0): N(0, ``initializer_range``) for matrices and embeddings,
    zero biases, unit norm weights.
    """

    def __init__(self, config: GPTConfig, device=None, generator=None):
        super().__init__()
        c = self.config = config
        if c.num_experts > 0:
            raise NotImplementedError(
                "MoE GPT (num_experts > 0) is not ported yet: ROADMAP.md "
                "A7 (distributed and MoE)")
        for flag, on in (("sequence_parallel", c.sequence_parallel),
                         ("context_parallel", c.context_parallel),
                         ("pipeline parallel (pp_schedule/virtual_pp_degree)",
                          c.pp_schedule != "gpipe"
                          or c.virtual_pp_degree != 1)):
            if on:
                raise NotImplementedError(
                    f"{flag} is not ported yet: ROADMAP.md A7 (distributed "
                    "and MoE)")
        if c.recompute not in _RECOMPUTE:
            raise ValueError(f"GPTConfig.recompute {c.recompute!r}: expected "
                             f"one of {_RECOMPUTE}")
        if c.dtype not in _DTYPES:
            raise ValueError(f"GPTConfig.dtype {c.dtype!r}: the port takes "
                             f"{sorted(_DTYPES)}")
        dev = _resolve_device(device)
        dt = _DTYPES[c.dtype]
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        H, L, V, S = c.hidden_size, c.num_layers, c.vocab_size, c.max_seq_len
        F_ = c.ffn_hidden_size
        std = c.initializer_range

        def normal(shape):
            # filled slice by slice on the generator's device, so a large
            # stacked weight never needs an fp32 copy of itself
            p = torch.empty(shape, dtype=dt, device=dev)
            for part in (p if len(shape) == 3 else (p,)):
                r = torch.empty(part.shape, dtype=torch.float32,
                                device=generator.device)
                part.copy_(r.normal_(0.0, std, generator=generator))
            return nn.Parameter(p)

        def const(shape, value):
            return nn.Parameter(torch.full(shape, value, dtype=dt,
                                           device=dev))

        self.wte = normal((V, H))
        if not c.use_rope:
            self.wpe = normal((S, H))
        self.ln1_w = const((L, H), 1.0)
        self.ln1_b = const((L, H), 0.0)
        self.qkv_w = normal((L, H, 3 * H))
        self.qkv_b = const((L, 3 * H), 0.0)
        self.proj_w = normal((L, H, H))
        self.proj_b = const((L, H), 0.0)
        self.ln2_w = const((L, H), 1.0)
        self.ln2_b = const((L, H), 0.0)
        self.fc1_w = normal((L, H, F_))
        self.fc1_b = const((L, F_), 0.0)
        self.fc2_w = normal((L, F_, H))
        self.fc2_b = const((L, H), 0.0)
        self.lnf_w = const((H,), 1.0)
        self.lnf_b = const((H,), 0.0)
        if not c.tie_word_embeddings:
            self.lm_head = normal((H, V))
        #: host generator the training forward draws dropout seeds from
        #: when the caller passes none
        self.dropout_generator = torch.Generator().manual_seed(0)

    @property
    def device(self):
        return self.wte.device

    @torch.no_grad()
    def load_numpy_state(self, arrays):
        """Copy ``{name: ndarray}`` — the JAX model's ``state_dict()``
        names, as they are — into the parameters on this model's device,
        with no transposes (both packages keep the stacked layout).  The
        names must be exactly this model's parameters."""
        own = dict(self.named_parameters())
        missing = sorted(set(own) - set(arrays))
        unexpected = sorted(set(arrays) - set(own))
        if missing or unexpected:
            raise KeyError(f"load_numpy_state: missing {missing}, "
                           f"unexpected {unexpected}")
        for name, arr in arrays.items():
            arr = np.asarray(arr)
            if arr.dtype.name == "bfloat16":   # numpy has no bf16 of its own
                arr = arr.astype(np.float32)
            p = own[name]
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError(f"load_numpy_state: {name} has shape "
                                 f"{arr.shape}, want {tuple(p.shape)}")
            p.copy_(torch.from_numpy(np.array(arr)))  # a writable copy

    def _embed(self, wte, wpe, ids, start):
        """Token + learned-position embedding of ``ids[B, C]`` sitting at
        positions ``start + i``.  Positions are gathered per token; a
        padded tail that runs past the table is clamped token by token,
        so the live tokens always get their own positions."""
        h = wte[ids]
        if wpe is not None:
            p = start + torch.arange(ids.shape[1], device=ids.device)
            h = h + wpe[p.clamp(max=wpe.shape[0] - 1)]
        return h

    # -- training forward ---------------------------------------------------
    def forward(self, input_ids, *, generator=None, kernel=True):
        """Logits ``[B, S, V]`` in the model dtype for ``input_ids [B, S]``
        (positions ``0..S-1``), through the tied head.

        Each block: LayerNorm, qkv, causal flash attention (or
        ``reference_attention`` when ``use_flash_attention=False``),
        projection, GELU-tanh FFN, with residuals.  In training mode with
        ``dropout > 0`` the masks come from seeds drawn from
        ``generator`` (a CPU ``torch.Generator``; default
        ``self.dropout_generator``).  ``config.recompute`` replays
        activations in the backward through ``torch.utils.checkpoint``:
        ``True`` keeps only each block's input, ``"selective"`` also
        keeps qkv, the attention output and the FFN up-projection,
        ``"selective_lean"`` keeps qkv and the attention output.
        ``kernel=False`` swaps the flash kernels K1–K3 for their plain
        versions (used to hold the kernels against them in the model)."""
        c = self.config
        L = c.num_layers
        h = self.wte[input_ids]
        if not c.use_rope:
            h = h + self.wpe[:input_ids.shape[1]]
        seeds = [None] * L
        if self.training and c.dropout > 0:
            gen = self.dropout_generator if generator is None else generator
            seeds = torch.randint(0, 2 ** 62, (L, 2), generator=gen).tolist()
        layers = {n: getattr(self, n).unbind(0) for n in _STACKED}
        for l in range(L):
            lw = {n: t[l] for n, t in layers.items()}
            h = self._block(h, lw, seeds[l], kernel)
        h = _norm(h, self.lnf_w, self.lnf_b, c.layer_norm_epsilon)
        w = self.wte.T if c.tie_word_embeddings else self.lm_head
        return torch.matmul(h, w)

    def _block(self, h, lw, seeds, kernel):
        """One transformer block, cut into stages at the activations that
        recompute keeps: ``qkv``, ``attn_out`` and ``ffn_up`` (JAX
        ``checkpoint_name``s).  A checkpointed stage saves only its
        inputs and replays the rest in the backward."""
        c = self.config
        eps = c.layer_norm_epsilon
        drop = (None if seeds is None else
                lambda x, i: _dropout(x, c.dropout, seeds[i]))

        def qkv_of(h):
            x = _norm(h, lw["ln1_w"], lw["ln1_b"], eps)
            return torch.matmul(x, lw["qkv_w"]) + lw["qkv_b"]

        def attend(qkv):
            b, s, H3 = qkv.shape
            nh = c.num_heads
            hd = H3 // 3 // nh
            q, k, v = (t.reshape(b, s, nh, hd) for t in qkv.split(H3 // 3, -1))
            if c.use_rope:
                q, k = apply_rope(q), apply_rope(k)
            if c.use_flash_attention:
                o = flash_attention_fwd(q, k, v, causal=True, kernel=kernel)
            else:
                o = reference_attention(q, k, v, causal=True)
            return o.reshape(b, s, H3 // 3)

        def post_attn(h, o):
            a = torch.matmul(o, lw["proj_w"]) + lw["proj_b"]
            return h + (a if drop is None else drop(a, 0))

        def up_of(h2):
            x = _norm(h2, lw["ln2_w"], lw["ln2_b"], eps)
            return torch.matmul(x, lw["fc1_w"]) + lw["fc1_b"]

        def ffn(h2, up):
            f = (torch.matmul(F.gelu(up, approximate="tanh"), lw["fc2_w"])
                 + lw["fc2_b"])
            return h2 + (f if drop is None else drop(f, 1))

        def after_attn(h, o):
            h2 = post_attn(h, o)
            return ffn(h2, up_of(h2))

        def whole(h):
            return after_attn(h, attend(qkv_of(h)))

        mode = c.recompute if self.training and torch.is_grad_enabled() \
            else False
        if not mode:
            return whole(h)

        def ckpt(fn, *args):
            return checkpoint(fn, *args, use_reentrant=False,
                              preserve_rng_state=False)

        if mode is True:
            return ckpt(whole, h)
        o = ckpt(attend, ckpt(qkv_of, h))
        if mode == "selective_lean":
            return ckpt(after_attn, h, o)
        # keeping ffn_up but not the residual stream between the two
        # stages, so each stage replays the projection from attn_out
        up = ckpt(lambda h, o: up_of(post_attn(h, o)), h, o)
        return ckpt(lambda h, o, up: ffn(post_attn(h, o), up), h, o, up)

    # -- serving entry points (paddle_tpu_torch.serving.LLMEngine) ----------
    def decode_state(self):
        """The weights the serving entry points read, as one dict of the
        parameters themselves (no copies)."""
        c = self.config
        return {
            "lws": {n: getattr(self, n) for n in _STACKED},
            "wte": self.wte,
            "wpe": None if c.use_rope else self.wpe,
            "lnf_w": self.lnf_w,
            "lnf_b": self.lnf_b,
            "head": None if c.tie_word_embeddings else self.lm_head,
        }

    def _ffn(self, h, lw):
        x = _norm(h, lw["ln2_w"], lw["ln2_b"], self.config.layer_norm_epsilon)
        up = _mm(x, lw, "fc1_w") + lw["fc1_b"]
        return h + (_mm(F.gelu(up, approximate="tanh"), lw, "fc2_w")
                    + lw["fc2_b"])

    @torch.no_grad()
    def prefill_paged(self, w, ids, start, length, bt, pool_k, pool_v,
                      scale_k=None, scale_v=None):
        """One chunked-prefill step over the paged pools.

        ``ids[1, C]`` is one right-padded prompt chunk of true length
        ``length`` whose tokens sit at positions ``[start, start +
        length)`` (``start``/``length`` are host ints); ``bt[max_blocks]``
        is the request's int32 block table; ``pool_k``/``pool_v`` are the
        shared pools ``[L, n_blocks, bs, nh, hd]``.  Each chunk token's
        K/V is written in place into block ``bt[(start+i) // bs]`` at
        offset ``(start+i) % bs``; padded tail tokens are zeroed and
        routed to the trash block 0.  Attention gathers the row's whole
        logical sequence after the write, so one masked ``kpos <= qpos``
        attention covers the cached prefix, earlier chunks and the chunk
        itself.  Returns the fp32 logits ``[1, V]`` at the chunk's last
        valid token.

        Quantized KV: with int8/fp8 pools, ``scale_k``/``scale_v [L,
        n_blocks, bs]`` fp32 are the per-token scale pools.  Each token's
        K/V is quantized on insert (``quantize_kv``; padded tokens get
        zero tiles and zero scales in the trash block) and attention runs
        over the gathered view dequantized to fp32."""
        c = self.config
        nh, H = c.num_heads, c.hidden_size
        hd = H // nh
        B, C = ids.shape
        bs = pool_k.shape[2]
        max_blocks = bt.shape[0]
        S = max_blocks * bs
        scale = 1.0 / math.sqrt(hd)
        dev = ids.device
        h = self._embed(w["wte"], w["wpe"], ids, start)
        ar = torch.arange(C, device=dev)
        valid = ar < length
        tokpos = start + ar
        bt_l = bt.long()
        # padded tokens write (zeroed) into the trash block 0; the clamp
        # keeps a tail that runs past the table inside it
        blk = torch.where(valid, bt_l[(tokpos // bs).clamp(max=max_blocks - 1)],
                          0)
        off = tokpos % bs
        kpos = torch.arange(S, device=dev)
        mask = kpos[None, :] <= tokpos[:, None]                    # [C, S]
        vm = valid[:, None, None]
        kv_dt = None if scale_k is None else _pa.kv_dtype_of(pool_k.dtype)
        for l in range(c.num_layers):
            lw = {n: t[l] for n, t in w["lws"].items()}
            ck, cv = pool_k[l], pool_v[l]
            x = _norm(h, lw["ln1_w"], lw["ln1_b"], c.layer_norm_epsilon)
            qkv = _mm(x, lw, "qkv_w") + lw["qkv_b"]
            q, k, v = qkv.split(H, dim=-1)
            q = q.reshape(B, C, nh, hd)
            k = k.reshape(B, C, nh, hd)
            v = v.reshape(B, C, nh, hd)
            if c.use_rope:
                q = apply_rope(q, offset=start)
                k = apply_rope(k, offset=start)
            if kv_dt is None:
                zero = torch.zeros((), dtype=ck.dtype, device=dev)
                ck.index_put_((blk, off),
                              torch.where(vm, k[0].to(ck.dtype), zero))
                cv.index_put_((blk, off),
                              torch.where(vm, v[0].to(cv.dtype), zero))
                gk = ck[bt_l].reshape(S, nh, hd)[None]
                gv = cv[bt_l].reshape(S, nh, hd)[None]
            else:
                # quantize on insert; a zeroed padded token quantizes to a
                # zero tile, and its scale is zeroed as the reference does
                sk, sv = scale_k[l], scale_v[l]
                for pool, spool, new in ((ck, sk, k[0]), (cv, sv, v[0])):
                    xq, xs = _pa.quantize_kv(torch.where(vm, new, 0), kv_dt)
                    pool.index_put_((blk, off), xq)
                    spool.index_put_((blk, off), torch.where(valid, xs, 0.0))
                gk = _pa.dequantize_kv(ck[bt_l], sk[bt_l]).reshape(
                    S, nh, hd)[None]
                gv = _pa.dequantize_kv(cv[bt_l], sv[bt_l]).reshape(
                    S, nh, hd)[None]
            logits = torch.einsum("bqhd,bkhd->bhqk", (q * scale).float(),
                                  gk.float())
            logits = torch.where(mask[None, None], logits,
                                 torch.full((), NEG_INF, device=dev))
            p = torch.softmax(logits, dim=-1)
            o = torch.einsum("bhqk,bkhd->bqhd", p.to(gv.dtype), gv)
            o = o.reshape(B, C, H).to(h.dtype)
            h = h + (_mm(o, lw, "proj_w") + lw["proj_b"])
            h = self._ffn(h, lw)
        return _lm_logits(c, w["wte"], w["lnf_w"], w["lnf_b"], w["head"],
                          h[:, length - 1])

    @torch.no_grad()
    def decode_paged(self, w, tok, pos, bt, pool_k, pool_v, scale_k=None,
                     scale_v=None, kernel=True):
        """One decode step for B rows over the paged pools.

        tok ``[B]`` and pos ``[B]`` int32, bt ``[B, max_blocks]`` int32,
        pool_k/pool_v ``[L, n_blocks, bs, nh, hd]``.  Each row writes its
        K/V in place into block ``bt[row, pos // bs]`` at offset ``pos %
        bs`` (rows with nothing to write are tabled to the trash block 0
        at position 0 by the engine) and attends over keys ``kpos <=
        pos[row]``.  Returns the fp32 logits ``[B, V]``.

        Attention goes through :func:`kernels.paged_attention.
        paged_decode_attention` — the CUDA kernel on a CUDA device — with
        the query pre-scaled in the model dtype and ``scale=1.0``.
        ``kernel=False`` calls the kernel's plain version instead (used to
        hold the kernel against it inside the model).

        Quantized KV: with int8/fp8 pools and ``scale_k``/``scale_v [L,
        n_blocks, bs]``, each row's new K/V is quantized on insert and
        its scales written at the same ``(block, offset)``; attention
        runs the kernel's quantized variant (K4q), or its plain
        dequantizing version with ``kernel=False``."""
        c = self.config
        nh, H = c.num_heads, c.hidden_size
        hd = H // nh
        B = tok.shape[0]
        bs = pool_k.shape[2]
        scale = 1.0 / math.sqrt(hd)
        attend = (_pa.paged_decode_attention if kernel
                  else _pa.paged_decode_attention_reference)
        tok_l, pos_l = tok.long(), pos.long()
        h = w["wte"][tok_l][:, None, :]
        if w["wpe"] is not None:
            h = h + w["wpe"][pos_l][:, None, :]
        rows = torch.arange(B, device=tok.device)
        blk = bt.long()[rows, pos_l // bs]                          # [B]
        off = pos_l % bs
        kv_dt = None if scale_k is None else _pa.kv_dtype_of(pool_k.dtype)
        for l in range(c.num_layers):
            lw = {n: t[l] for n, t in w["lws"].items()}
            ck, cv = pool_k[l], pool_v[l]
            scales = () if kv_dt is None else (scale_k[l], scale_v[l])
            x = _norm(h, lw["ln1_w"], lw["ln1_b"], c.layer_norm_epsilon)
            qkv = _mm(x, lw, "qkv_w") + lw["qkv_b"]
            q, k, v = qkv.split(H, dim=-1)
            q = q.reshape(B, 1, nh, hd)
            k = k.reshape(B, 1, nh, hd)
            v = v.reshape(B, 1, nh, hd)
            if c.use_rope:
                q = _rope_rows(q, pos)
                k = _rope_rows(k, pos)
            # idle rows all write the trash slot (0, 0); nothing live
            # reads it, so the duplicate indices are harmless
            if kv_dt is None:
                ck.index_put_((blk, off), k[:, 0].to(ck.dtype))
                cv.index_put_((blk, off), v[:, 0].to(cv.dtype))
            else:
                for pool, spool, new in zip((ck, cv), scales, (k, v)):
                    xq, xs = _pa.quantize_kv(new[:, 0], kv_dt)
                    pool.index_put_((blk, off), xq)
                    spool.index_put_((blk, off), xs)
            o = attend((q[:, 0] * scale).contiguous(), ck, cv, bt, pos,
                       *scales, scale=1.0)
            o = o.reshape(B, 1, H).to(h.dtype)
            h = h + (_mm(o, lw, "proj_w") + lw["proj_b"])
            h = self._ffn(h, lw)
        return _lm_logits(c, w["wte"], w["lnf_w"], w["lnf_b"], w["head"],
                          h[:, 0])


class GPTPretrainingCriterion(nn.Module):
    """Causal-LM loss over ``logits [B, S, V]`` and ``labels [B, S]``: fp32
    ``logsumexp - picked`` per token, averaged, or averaged over
    ``loss_mask`` (at least one token) when it is given."""

    def __init__(self, config=None):
        super().__init__()

    def forward(self, logits, labels, loss_mask=None):
        lg = logits.float()
        picked = lg.gather(-1, labels.long()[..., None])[..., 0]
        loss = torch.logsumexp(lg, -1) - picked
        if loss_mask is None:
            return loss.mean()
        m = loss_mask.float()
        return (loss * m).sum() / m.sum().clamp_min(1.0)
