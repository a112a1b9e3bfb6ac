"""GPT causal LM — the training forward and the serving entry points
(port of ``paddle_tpu/models/gpt.py``).

``GPTForCausalLM`` is a paddle-style ``nn.Layer``, as the JAX class is:
its attributes are ``Parameter`` wrappers, ``parameters()``,
``state_dict``/``set_state_dict``, ``train``/``eval`` and
``amp.decorate``/``auto_cast`` work as on any layer, and Paddle's
dygraph loop (``model(ids)`` on ``Tensor``s, the criterion,
``loss.backward()``, ``opt.step()``, ``opt.clear_grad()``) trains it.
The parameters keep the reference's stacked ``[L, ...]`` layout and
names (``wte``, ``wpe``, ``ln1_w``, ``qkv_w [L, H, 3H]``, ...), so a JAX
``state_dict`` loads one to one (``load_numpy_state``).  Everything
inside reads the torch parameters themselves (:meth:`_weights`), so the
serving entry points, ``jit.CompiledTrainStep`` and its CUDA graphs see
plain torch tensors.  A plain Python loop over layers replaces
``lax.scan``.

Training: :meth:`GPTForCausalLM.forward` returns logits in the model
dtype — a ``Tensor`` for a ``Tensor`` input (the op ``"gpt_forward"``,
whose AMP cast applies), a torch tensor for a torch input; attention
goes through ``kernels.flash_attention`` (the CUDA kernels K1–K3 on a
CUDA device), recompute through ``torch.utils.checkpoint``.
:class:`GPTPretrainingCriterion` is the fp32 causal-LM loss
(``"gpt_loss"``).  Under the mesh step's sequence split (``sep > 1``,
``distributed.env.sequence_split``) a rank holds one chunk of every
row: ``context_parallel`` attends across the chunks by ring attention
(``kernels.ring_attention``), otherwise by an all-gather of qkv along
the sequence (see :meth:`GPTForCausalLM._block`).  Built under a mesh
with ``pp > 1`` a rank holds its pipeline stages' rows of every stacked
parameter (:class:`PipelineStages`) and the forward runs GPipe or the
interleaved schedule over ``pp`` (``distributed.pipeline.
pipeline_apply``, every rank calling, the logits on every rank);
:meth:`GPTForCausalLM.pipeline_parts` cuts the model for the 1F1B and
zero-bubble steps.

Serving: the paged KV pools ``[L, n_blocks, bs, nh, hd]`` are updated
**in place** (``index_put_``) by :meth:`GPTForCausalLM.prefill_paged`
and :meth:`GPTForCausalLM.decode_paged`; this replaces the JAX package's
donation of the pools through every program.  Decode attention goes
through the CUDA kernel ``kernels/paged_attention`` on a CUDA device.
Quantized KV (int8/fp8 pools with per-token fp32 scale pools ``[L,
n_blocks, bs]``) quantizes on insert; decode attends through the
kernel's quantized variant, prefill over the dequantized gather.
:meth:`GPTForCausalLM.verify_paged` scores a speculative draft block
over the same pools (dense attention over the gathered sequence).

Slot serving and ``generate``: :meth:`GPTForCausalLM.prefill_slot` and
:meth:`GPTForCausalLM.decode_slots` run over a dense per-slot arena
``[L, B, S, nh, hd]`` (``LLMEngine``'s default layout) and
:meth:`GPTForCausalLM.generate` over a cache of its own: K/V written in
place, dense attention that the reference leaves to XLA (no kernel
stands behind it).

Every serving entry point runs one layer loop (``_layers``); they
differ only in how a layer writes its new K/V and attends.

Mixture-of-Experts: ``GPTConfig(num_experts=E)`` makes every layer's FFN
a GShard top-k MoE FFN (``incubate.moe.moe_ffn``; the JAX package reads
no ``moe_every``) over the stacks ``gate_w [L, H, E]``, ``fc1_w [L, E,
H, F]``, ``fc1_b [L, E, F]``, ``fc2_w [L, E, F, H]`` and ``fc2_b [L, E,
H]``.  The training forward sums the layers' load-balancing losses
(:meth:`GPTForCausalLM.moe_aux_loss`); the serving entry points drop
them, and every row of a launch routes and takes capacity (prefill
padding, idle decode rows), as in the JAX package.  Built under a mesh,
the experts split over ``dp`` when ``E`` divides its degree (expert
parallelism: the tokens meet their experts by all-to-all, and routing,
capacity and the loss are the global batch's) and their hidden units
over ``mp``.
"""

from __future__ import annotations

import math
import warnings

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..core.dispatch import apply_op
from ..core.tensor import Tensor, _to_torch
from ..distributed import communication, mp_ops
from ..distributed.env import (get_mesh, row_axes, sequence_split,
                               token_axes)
from ..distributed.pipeline import pipeline_apply
from ..distributed.sharding_utils import (P, _axes_of, gather_shard,
                                          local_shard, validate_spec)
from ..incubate import moe as _moe
from ..kernels import paged_attention as _pa
from ..kernels._shapes import NEG_INF
from ..kernels.flash_attention import flash_attention_fwd, reference_attention
from ..kernels.ring_attention import ring_attention
from ..kernels.rope import apply_rope
from ..nn.layer.layers import Layer
from ..serving.sampling import sample_tokens


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


#: model dtypes; training and serving take all three (the CUDA flash
#: kernels run float16 as bf16 products with fp16 outputs, the paged
#: decode kernels widen fp16 to fp32 as the JAX kernel does)
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}

#: per-layer parameters stacked on a leading [L] axis
_STACKED = ("ln1_w", "ln1_b", "qkv_w", "qkv_b", "proj_w", "proj_b",
            "ln2_w", "ln2_b", "fc1_w", "fc1_b", "fc2_w", "fc2_b")
#: an MoE model's stacks: the router last, as in the JAX ``_stacked``
_STACKED_MOE = _STACKED + ("gate_w",)


def _norm(x, w, b, eps):
    """LayerNorm in fp32, cast back to the input dtype, then ``* w + b``
    in that dtype (the reference's order, which matters in bf16)."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, unbiased=False)
    return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype) * w + b


#: the seed step between the dropout streams of two sequence chunks
#: (``GPTForCausalLM.chunk_generator``): 2**64 over the golden ratio
_CHUNK_SEED_STRIDE = 0x9E3779B97F4A7C15


def _keep_mask(shape, p, generator, device):
    """Dropout's keep mask (rate ``1 - p``) drawn from ``generator``, a
    generator on ``device``: on CUDA one a captured graph registers, so
    every replay draws anew.  (The JAX package draws from ``jax.random``
    keys: the streams differ, the distribution is the same.)"""
    return torch.rand(shape, generator=generator, device=device) < 1 - p


def _dropout(x, p, keep):
    """Inverted dropout through the keep mask ``keep``."""
    return torch.where(keep, x / (1 - p), 0.0).to(x.dtype)


#: recompute modes (JAX ``_sel_policy``): which block activations survive
#: to the backward; everything else replays from them.
_RECOMPUTE = (False, True, "selective", "selective_lean")


def _rope_grid(x, pos, base=10000.0):
    """apply_rope for a grid of tokens ``x[B, T, nh, hd]`` sitting at
    per-token positions ``pos`` (``[B, T]``, or ``[1, T]`` shared by the
    rows): each token gets its own rotation."""
    d = x.shape[-1]
    inv = 1.0 / (base ** (torch.arange(0, d, 2, dtype=torch.float32,
                                       device=x.device) / d))
    freqs = pos.float()[..., None] * inv                      # [B, T, d/2]
    sin = torch.sin(freqs)[:, :, None, :]
    cos = torch.cos(freqs)[:, :, None, :]
    xf = x.float()
    x1, x2 = xf[..., : d // 2], xf[..., d // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return out.to(x.dtype)


def _causal_mask(pos, S):
    """``[B, 1, T, S]`` for tokens at positions ``pos[B, T]`` (B may be
    1): key ``s`` is visible to the token at ``pos[b, t]`` when ``s <=
    pos[b, t]``."""
    return (torch.arange(S, device=pos.device) <= pos[..., None])[:, None]


def _paged_write(pool, spool, new, blk, off, keep=None):
    """Write one layer's new K (or V) ``new[..., nh, hd]`` in place into
    ``pool [n_blocks, bs, nh, hd]`` at ``(blk, off)``.  With a scale pool
    ``spool [n_blocks, bs]`` the pool is int8/fp8: ``new`` is quantized
    on insert and its per-token scales are written beside it.  ``keep``
    (bool, ``new``'s token shape) zeroes the tokens it drops, scales
    included."""
    if keep is not None:
        new = torch.where(keep[..., None, None], new, 0)
    if spool is None:
        pool.index_put_((blk, off), new.to(pool.dtype))
        return
    xq, xs = _pa.quantize_kv(new, _pa.kv_dtype_of(pool.dtype))
    pool.index_put_((blk, off), xq)
    spool.index_put_((blk, off),
                     xs if keep is None else torch.where(keep, xs, 0.0))


def _paged_write_gather(pool, spool, new, blk, off, bt_l, keep=None):
    """:func:`_paged_write`, then the rows' logical sequences gathered
    through their tables ``bt_l`` (``pool[bt_l]``; dequantized to fp32
    with a scale pool)."""
    _paged_write(pool, spool, new, blk, off, keep)
    if spool is None:
        return pool[bt_l]
    return _pa.dequantize_kv(pool[bt_l], spool[bt_l])


def _dense_attention(q, k, v, mask):
    """Masked softmax attention of ``q[B, T, nh, hd]`` over ``k``/``v
    [B, S, nh, hd]``; ``mask`` broadcasts to ``[B, nh, T, S]``.  The
    reference's dtype order: logits from ``q * scale`` widened to fp32
    against fp32 keys, probabilities cast to ``v``'s dtype before the PV
    product (the order that keeps bf16 in step with the JAX package).
    Returns ``[B, T, nh, hd]`` in ``v``'s dtype."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", (q * scale).float(), k.float())
    logits = torch.where(mask, logits,
                         torch.full((), NEG_INF, device=q.device))
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)


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


def _mm_lora(x, lw, name, al, aids):
    """:func:`_mm` plus the gathered batched low-rank update (S-LoRA /
    Punica): ``y + x @ A[ids] @ B[ids]``, where ``al`` holds this layer's
    adapter slabs ``a_<name> [n_slots, d_in, R]`` / ``b_<name> [n_slots,
    R, d_out]`` and ``aids [B]`` is each row's adapter slot.  Slot 0 is the
    base model: its row is selected from the un-adapted ``y`` itself (not
    ``y + 0``), so base rows are bitwise those of an adapter-free call.
    The update rides beside whatever ``_mm`` produced, int8 epilogue
    included."""
    y = _mm(x, lw, name)
    if al is None:
        return y
    ag = al["a_" + name][aids]                        # [B, d_in, R]
    bg = al["b_" + name][aids]                        # [B, R, d_out]
    d = torch.einsum("bti,bir->btr", x, ag)
    d = torch.einsum("btr,bro->bto", d, bg)
    return torch.where((aids > 0)[:, None, None], y + d.to(y.dtype), y)


def _resolve_device(device):
    """``device``, else the paddle-style default device (``set_device``),
    else ``cuda``; raises when there is no GPU and the caller asked for
    no other device."""
    if device is None:
        from ..device import default_device
        return default_device()
    return torch.device(device)


#: the JAX package's placements of the parameters (``gpt.py`` ``mk``):
#: column-parallel qkv/fc1, row-parallel proj/fc2, the vocabulary of the
#: tied embedding and of an untied head; everything else replicated
PLACEMENTS = {
    "wte": P("mp", None), "qkv_w": P(None, None, "mp"),
    "qkv_b": P(None, "mp"), "proj_w": P(None, "mp", None),
    "fc1_w": P(None, None, "mp"), "fc1_b": P(None, "mp"),
    "fc2_w": P(None, "mp", None), "lm_head": P(None, "mp"),
}


def moe_placements(num_experts, ffn_hidden, mesh):
    """The JAX placements of an MoE model's expert stacks (``gpt.py``
    ``mk``): the expert axis over ``dp`` when ``num_experts`` divides its
    degree (expert parallelism), the hidden axis over ``mp`` when
    ``ffn_hidden`` divides its degree (column-parallel ``fc1``,
    row-parallel ``fc2``), each all or nothing across the stacks; the
    router replicated."""
    ep = "dp" if num_experts % mesh.degree("dp") == 0 else None
    mp = "mp" if ffn_hidden % mesh.degree("mp") == 0 else None
    return {"gate_w": P(), "fc1_w": P(None, ep, None, mp),
            "fc1_b": P(None, ep, mp), "fc2_w": P(None, ep, mp, None),
            "fc2_b": P(None, ep, None)}

#: leaves whose split dimension is the fused ``[q | k | v]`` columns:
#: rank r keeps its heads of q, of k and of v, so it computes locally
_FUSED = {"qkv_w": 3, "qkv_b": 3, "qkv_w__scale": 3}

#: leaves that split together or not at all: attention by heads (its
#: shard must hold whole heads), the FFN by its hidden units
_GROUPS = (("qkv_w", "qkv_b", "proj_w", "qkv_w__scale"),
           ("fc1_w", "fc1_b", "fc2_w", "fc1_w__scale"))


def _split(spec):
    return any(e is not None for e in (spec or ()))


def resolve_tp_specs(specs, num_heads, mesh, axis="mp", on_fallback=None):
    """Make ``specs`` (``{leaf name: P}``) computable with local shards:
    the attention leaves split only when ``num_heads`` divides by the
    ``axis`` degree (a shard holds whole heads), and each group of
    :data:`_GROUPS` splits as a whole or not at all.  A leaf that had a
    split and loses it calls ``on_fallback(message)``.  Returns a new
    dict."""
    out = dict(specs)
    n = mesh.degree(axis)
    for i, group in enumerate(_GROUPS):
        present = [k for k in group if k in out]
        ok = all(_split(out[k]) for k in present)
        if i == 0 and num_heads % n:
            ok = False
        if ok:
            continue
        for k in present:
            if _split(out[k]) and on_fallback is not None:
                on_fallback(f"{k!r} spec {out[k]} dropped: its group "
                            f"{group} cannot split over {axis}={n}")
            out[k] = P()
    return out


class TensorParallel:
    """How a GPT weight set is split over mesh axis ``axis`` and the
    Megatron forward over it.  ``specs`` maps leaf names (``wte``,
    ``wpe``, ``head``/``lm_head`` and the stacked layer names) to their
    :class:`P`.  Column-parallel inputs pass :func:`mp_ops.copy_to_mp`
    (the gradient's all-reduce), row-parallel outputs
    :func:`mp_ops.reduce_from_mp` (one all-reduce in the model dtype,
    the bias added once after it).  The embedding and the logits
    follow their spec: a vocabulary split looks up through
    ``vocab_parallel_embedding`` and gathers the logits, a hidden split
    gathers the embedding and all-reduces the logits.  At degree 1 the
    same collectives run over a group of one."""

    def __init__(self, mesh, specs, axis="mp"):
        self.mesh, self.axis, self.specs = mesh, axis, dict(specs)
        self.degree = mesh.degree(axis)
        self.attn = _split(self.specs.get("qkv_w"))
        fc1 = self.specs.get("fc1_w") or P()
        # the FFN's hidden units split over ``axis``; an MoE stack [L, E,
        # H, F] may also split its experts (``expert_axis``)
        self.ffn = bool(fc1) and axis in _axes_of(fc1[-1])
        self.expert_axis = (fc1[1] if len(fc1) == 4 and fc1[1] is not None
                            else None)

    def spec(self, name):
        return self.specs.get(name, P())

    def fused(self, name):
        """The parts laid end to end along leaf ``name``'s split dimension:
        3 for the ``[q | k | v]`` columns when they split, else 1."""
        return _FUSED.get(name, 1) if _split(self.spec(name)) else 1

    def local(self, name, full):
        """This rank's shard of the full leaf ``name``."""
        return local_shard(full, self.spec(name), self.mesh,
                           _FUSED.get(name, 1))

    def full(self, name, x):
        """The full leaf ``name`` from every rank's shard ``x`` (every
        rank calls)."""
        return gather_shard(x, self.spec(name), self.mesh,
                            _FUSED.get(name, 1))

    def col_in(self, x, on):
        return mp_ops.copy_to_mp(x, self.axis, self.mesh) if on else x

    def lora_local(self, adapters):
        """This rank's cut of LoRA factors ``a_<t> [..., d_in, R]`` /
        ``b_<t> [..., R, d_out]`` (``serving.adapters.AdapterArena`` cuts
        a tenant's once, when it registers), so that :func:`_mm_lora`
        adds the rank's part of ``x @ A @ B``: a column-parallel weight
        (qkv, fc1) keeps the columns of ``B`` its shard computes (qkv's
        per q/k/v block, as the weight is cut), a row-parallel one (proj,
        fc2) the rows of ``A`` its input features meet, so its update
        joins the partial sum before the all-reduce and counts once.
        Factors of a part that does not split stay whole."""
        cut = {"b_qkv_w": (self.attn, -1), "a_proj_w": (self.attn, -2),
               "b_fc1_w": (self.ffn, -1), "a_fc2_w": (self.ffn, -2)}
        out = dict(adapters)
        for name, (on, dim) in cut.items():
            t = out.get(name)
            if on and t is not None:
                spec = [None] * t.dim()
                spec[dim] = self.axis
                out[name] = local_shard(t, P(*spec), self.mesh,
                                        _FUSED.get(name[2:], 1))
        return out

    def row_out(self, y, on):
        return mp_ops.reduce_from_mp(y, self.axis, self.mesh) if on else y

    def embed(self, wte, wpe, ids, pos):
        """``wte[ids] (+ wpe[pos])`` in full, from the shards."""
        sw = self.spec("wte")
        if not _split(sw):
            h = wte[ids]
        elif sw == P(self.axis, None):
            h = mp_ops.vocab_parallel_embedding(ids, wte, self.axis,
                                                self.mesh)
        else:
            h = wte[ids]
            if wpe is not None and _split(self.spec("wpe")):
                return mp_ops.gather_from_mp(h + wpe[pos], self.axis,
                                             self.mesh)
            h = mp_ops.gather_from_mp(h, self.axis, self.mesh)
        if wpe is None:
            return h
        p = wpe[pos]
        if _split(self.spec("wpe")):
            p = mp_ops.gather_from_mp(p, self.axis, self.mesh)
        return h + p

    def logits(self, h, head, name):
        """``h @ head`` in full (``head`` is ``wte.T`` for ``name ==
        "wte"``, whose vocabulary is its first dimension)."""
        spec = self.spec(name)
        if not _split(spec):
            return torch.matmul(h, head)
        vocab = spec == (P(self.axis, None) if name == "wte"
                         else P(None, self.axis))
        if vocab:
            return mp_ops.gather_from_mp(
                torch.matmul(self.col_in(h, True), head), self.axis,
                self.mesh)
        part = mp_ops.scatter_to_mp(h, self.axis, self.mesh)
        return mp_ops.reduce_from_mp(torch.matmul(part, head), self.axis,
                                     self.mesh)


class PipelineStages:
    """The layers one rank holds under a mesh with ``pp > 1`` (the JAX
    pipeline's split of the stacked ``[L, ...]`` parameters): ``pp x V``
    logical stages of ``per_chunk`` layers, ``V`` being
    ``virtual_pp_degree`` for the interleaved schedule and 1 otherwise;
    logical stage ``v * pp + p`` is chunk ``v`` of rank ``p``.  ``rows``
    are this rank's layers in the order it holds them: contiguous for
    GPipe and 1F1B, its ``V`` chunks for the interleaved schedule."""

    def __init__(self, mesh, config):
        c = config
        self.mesh = mesh
        self.pp, self.p = mesh.degree("pp"), mesh.index("pp")
        self.last = self.p == self.pp - 1
        self.V = (c.virtual_pp_degree if c.pp_schedule == "interleaved"
                  else 1)
        n = self.pp * self.V
        if c.num_layers % n:
            raise ValueError(f"pipeline parallel requires num_layers "
                             f"({c.num_layers}) divisible by pp*virtual_pp "
                             f"({n})")
        self.per_chunk = c.num_layers // n
        self.rows = self.rows_of(self.p)

    def rows_of(self, p):
        k = self.per_chunk
        return [(v * self.pp + p) * k + i for v in range(self.V)
                for i in range(k)]

    def full(self, t):
        """The ``[L, ...]`` stack from every rank's rows ``t`` (an
        all-gather over ``pp``; every rank calls)."""
        parts = [torch.empty_like(t) for _ in range(self.pp)]
        dist.all_gather(parts, t.contiguous(), group=self.mesh.group("pp"))
        out = torch.empty((self.pp * t.shape[0], *t.shape[1:]),
                          dtype=t.dtype, device=t.device)
        for q, part in enumerate(parts):
            out[self.rows_of(q)] = part
        return out


def _tp_io(tp):
    """``(col_in, row_out)``: the column-parallel input and row-parallel
    output of a block part (``"attn"`` or ``"ffn"``) under ``tp``;
    identities without it."""
    if tp is None:
        return (lambda x, part: x), (lambda y, part: y)
    return (lambda x, part: tp.col_in(x, getattr(tp, part)),
            lambda y, part: tp.row_out(y, getattr(tp, part)))


class GPTForCausalLM(Layer):
    """GPT causal LM with stacked ``[L, ...]`` parameters.

    ``device=None`` picks the default device (``paddle.set_device``),
    ``cuda`` unless the caller set another, and raises ``RuntimeError``
    when no GPU is present; pass ``device="cpu"`` (or set it) to run on
    the CPU.  Weights are drawn from ``generator`` (default: a CPU
    ``torch.Generator`` seeded with 0): N(0, ``initializer_range``) for
    matrices and embeddings, zero biases, unit norm weights.
    """

    #: generator on the model's device the training forward draws dropout
    #: masks from when the caller passes none (an instance attribute,
    #: set in ``__init__``, in place of ``Layer``'s property)
    dropout_generator = None
    #: True: under the mesh step's sequence split the forward places its
    #: chunk and attends across the chunks (``jit.mesh.MeshPlan`` trains
    #: no other model on a mesh with ``sep > 1``)
    handles_sequence_split = True
    #: a dict that gathers each MoE call's dropped and routed choices by
    #: token count on the device (``incubate.moe.moe_ffn``'s ``stats``);
    #: None (the default) gathers nothing
    moe_stats = None

    def __init__(self, config: GPTConfig, device=None, generator=None):
        super().__init__()
        c = self.config = config
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
        E = c.num_experts
        std = c.initializer_range
        shapes = {"wte": (V, H), "wpe": (S, H), "ln1_w": (L, H),
                  "ln1_b": (L, H), "qkv_w": (L, H, 3 * H),
                  "qkv_b": (L, 3 * H), "proj_w": (L, H, H), "proj_b": (L, H),
                  "ln2_w": (L, H), "ln2_b": (L, H), "fc1_w": (L, H, F_),
                  "fc1_b": (L, F_), "fc2_w": (L, F_, H), "fc2_b": (L, H),
                  "lnf_w": (H,), "lnf_b": (H,), "lm_head": (H, V)}
        if E > 0:
            # every layer's FFN is a GShard MoE over E experts (the JAX
            # package reads no ``moe_every``)
            shapes.update(gate_w=(L, H, E), fc1_w=(L, E, H, F_),
                          fc1_b=(L, E, F_), fc2_w=(L, E, F_, H),
                          fc2_b=(L, E, H))
        self._stacked = _STACKED_MOE if E > 0 else _STACKED
        # under a global mesh each rank holds its shard of every split
        # parameter (the JAX placements, degraded where they do not
        # divide) and runs the Megatron forward (TensorParallel)
        mesh = get_mesh()
        self._tp = None
        if mesh is not None:
            place = dict(PLACEMENTS)
            if E > 0:
                place.update(moe_placements(E, F_, mesh))
            specs = {n: validate_spec(sp, shapes[n], mesh, name=n)
                     for n, sp in place.items()}
            specs = resolve_tp_specs(specs, c.num_heads, mesh)
            specs["head"] = specs["lm_head"]
            self._tp = TensorParallel(mesh, specs)
        tp = self._tp
        # under a mesh with pp > 1 each rank holds the rows of its stages
        # of every stacked parameter (the JAX pipeline's placements)
        self._pp = (PipelineStages(mesh, c) if mesh is not None
                    and mesh.degree("pp") > 1 else None)
        rows = range(L) if self._pp is None else self._pp.rows
        pos = {l: i for i, l in enumerate(rows)}

        def local(name, full, stacked):
            # this rank's shard of one layer's slice (or of the whole
            # parameter when it is not stacked)
            if tp is None:
                return full
            spec = tp.spec(name)
            return local_shard(full, P(*spec[1:]) if stacked else spec,
                               mesh, _FUSED.get(name, 1))

        def local_shape(name):
            shape = tuple(local(name, torch.empty(shapes[name],
                                                  device="meta"), False).shape)
            return ((len(rows),) + shape[1:] if name in self._stacked
                    else shape)

        def normal(name):
            # filled slice by slice on the generator's device, so a large
            # stacked weight never needs an fp32 copy of itself; a shard
            # keeps its piece of the same draw, and a pipeline stage its
            # rows of every layer drawn in order
            shape = shapes[name]
            stacked = name in self._stacked
            p = torch.empty(local_shape(name), dtype=dt, device=dev)
            for l in range(shape[0] if stacked else 1):
                r = torch.empty(shape[1:] if stacked else shape,
                                dtype=torch.float32, device=generator.device)
                r.normal_(0.0, std, generator=generator)
                if not stacked:
                    p.copy_(local(name, r, False))
                elif l in pos:
                    p[pos[l]].copy_(local(name, r, True))
            return nn.Parameter(p)

        def const(name, value):
            return nn.Parameter(torch.full(local_shape(name), value,
                                           dtype=dt, device=dev))

        self.wte = normal("wte")
        if not c.use_rope:
            self.wpe = normal("wpe")
        self.ln1_w = const("ln1_w", 1.0)
        self.ln1_b = const("ln1_b", 0.0)
        self.qkv_w = normal("qkv_w")
        self.qkv_b = const("qkv_b", 0.0)
        self.proj_w = normal("proj_w")
        self.proj_b = const("proj_b", 0.0)
        self.ln2_w = const("ln2_w", 1.0)
        self.ln2_b = const("ln2_b", 0.0)
        self.fc1_w = normal("fc1_w")
        self.fc1_b = const("fc1_b", 0.0)
        self.fc2_w = normal("fc2_w")
        self.fc2_b = const("fc2_b", 0.0)
        if E > 0:
            self.gate_w = normal("gate_w")
        self.lnf_w = const("lnf_w", 1.0)
        self.lnf_b = const("lnf_b", 0.0)
        if not c.tie_word_embeddings:
            self.lm_head = normal("lm_head")
        if tp is not None:
            # where each shard lies in the whole parameter (checkpoints
            # read it: jit.mesh.MeshPlan.shard): the spec, the fused
            # parts of the split dimension, a pipeline stage's rows
            for n, t in self._weights().items():
                t.placements = tp.spec(n)
                t.shard_fused = tp.fused(n)
                t.shard_rows = None
                if self._pp is not None and n in self._stacked:
                    t.placements = P("pp", *t.placements[1:])
                    t.shard_rows = list(self._pp.rows)
                t.is_distributed = _split(t.placements)
        self.dropout_generator = torch.Generator(device=dev).manual_seed(0)
        #: the generators sequence chunks draw their dropout masks from
        #: (:meth:`chunk_generator`); a CUDA-graph capture of the mesh
        #: step registers them beside ``dropout_generator``
        self.chunk_generators = {}

    def chunk_generator(self, gen, index):
        """The generator sequence chunk ``index`` draws its dropout masks
        from in place of ``gen``: one of its own on ``gen``'s device,
        seeded ``gen``'s seed offset by the chunk index (as the
        tensor-parallel RNG tracker's local seed is offset by the rank),
        made on first use.  A chunk draws its own masks only: they take a
        chunk's memory and differ from the other chunks'."""
        key = (str(gen.device), gen.initial_seed(), index)
        g = self.chunk_generators.get(key)
        if g is None:
            seed = (gen.initial_seed() + _CHUNK_SEED_STRIDE * (index + 1))
            g = self.chunk_generators[key] = torch.Generator(
                device=gen.device).manual_seed(seed % 2 ** 63)
        return g

    @property
    def device(self):
        return self._parameters["wte"].device

    @property
    def pipeline_stages(self):
        """The :class:`PipelineStages` this rank holds when the model was
        built under a mesh with ``pp > 1`` (its forward then runs the
        pipeline, every rank calling), else None."""
        return self._pp

    def _weights(self):
        """``{name: torch parameter}`` (the attributes are the paddle-style
        wrappers; every reader inside the model takes the torch
        parameters)."""
        return {n: t for n, t in self._parameters.items() if t is not None}

    @torch.no_grad()
    def load_numpy_state(self, state):
        """Load the JAX model's full ``{name: array}``; under a mesh each
        rank keeps its shard (the ``[q | k | v]`` columns of its heads for
        ``qkv_w``/``qkv_b``)."""
        if self._tp is None:
            return super().load_numpy_state(state)
        own = self._weights()
        missing = sorted(set(own) - set(state))
        unexpected = sorted(set(state) - set(own))
        if missing or unexpected:
            raise KeyError(f"load_numpy_state: missing {missing}, "
                           f"unexpected {unexpected}")
        for n, t in own.items():
            v = state[n]
            full = (v._data if isinstance(v, Tensor) else v
                    if isinstance(v, torch.Tensor)
                    else _to_torch(np.asarray(v), device=t.device))
            if self._pp is not None and n in self._stacked:
                full = full[self._pp.rows]
            t.copy_(self._tp.local(n, full.to(t.device)))
        return self

    def full_weight(self, name, t):
        """The whole parameter ``name`` in the JAX layout from this rank's
        piece ``t`` of it (its shard, its stages' rows): every rank
        calls, every rank gets it."""
        if self._tp is None:
            return t
        t = self._tp.full(name, t)
        if self._pp is not None and name in self._stacked:
            t = self._pp.full(t)
        return t

    @torch.no_grad()
    def gather_numpy_state(self):
        """``{name: numpy array}`` copies of the full parameters in the
        JAX layout (every rank takes part in the gathers; every rank gets
        the arrays).  bf16 comes back as fp32."""
        out = {}
        for n, t in self._weights().items():
            full = self.full_weight(n, t).detach()
            out[n] = (full.float() if full.dtype == torch.bfloat16
                      else full).cpu().numpy().copy()
        return out

    # -- training forward ---------------------------------------------------
    def forward(self, input_ids, *, generator=None, kernel=True):
        """Logits ``[B, S, V]`` in the model dtype for ``input_ids [B, S]``
        (positions ``0..S-1``; under a sequence split, this rank's chunk
        of each row, at its positions in the whole sequence), through the
        tied head.  A ``Tensor``
        input runs as the op ``"gpt_forward"`` over the ids and every
        parameter (so ``amp.auto_cast`` casts them as JAX's does) and
        gives a ``Tensor``; a torch input gives a torch tensor.

        Each block: LayerNorm, qkv, causal flash attention (or
        ``reference_attention`` when ``use_flash_attention=False``),
        projection, GELU-tanh FFN, with residuals.  In training mode with
        ``dropout > 0`` each block's two keep masks are drawn from
        ``generator`` (a ``torch.Generator`` on the model's device;
        default ``self.dropout_generator``; under a sequence split the
        chunk's own, :meth:`chunk_generator`) before the block runs, so a
        recomputed stage reuses them.  ``config.recompute`` replays
        activations in the backward through ``torch.utils.checkpoint``:
        ``True`` keeps only each block's input, ``"selective"`` also
        keeps qkv, the attention output and the FFN up-projection,
        ``"selective_lean"`` keeps qkv and the attention output.
        ``kernel=False`` swaps the flash kernels K1–K3 for their plain
        versions (used to hold the kernels against them in the model).
        A model built under a mesh with ``pp > 1`` runs its layers as the
        pipeline over ``pp``: every rank calls, and every rank gets the
        logits."""
        # the JAX op's operand order: wte, lnf_w, lnf_b, wpe, the stacked
        # weights, lm_head
        w = self._weights()
        names = [n for n in ("wte", "lnf_w", "lnf_b", "wpe", *self._stacked,
                             "lm_head") if n in w]

        def fn(ids, *ws):
            return self._forward(ids, dict(zip(names, ws)), generator,
                                 kernel)

        ws = [w[n] for n in names]
        wrap = isinstance(input_ids, Tensor)
        out = (apply_op("gpt_forward", fn, input_ids, *ws) if wrap
               else fn(input_ids, *ws))
        self._moe_wrap = wrap
        if isinstance(out, tuple):
            out, self._moe_aux = out
            return out
        self._moe_aux = None
        return out

    def moe_aux_loss(self):
        """The MoE load-balancing loss of the last forward, summed over
        the layers (fp32, unweighted), or a zero scalar for a dense model,
        as in the JAX package: add ``model.moe_aux_loss() * coeff`` to
        the training loss.  A ``Tensor`` after a ``Tensor`` forward, a
        torch tensor after a torch one."""
        aux = getattr(self, "_moe_aux", None)
        wrap = getattr(self, "_moe_wrap", True)
        if aux is None:
            aux = torch.zeros((), dtype=torch.float32, device=self.device)
            return Tensor._wrap(aux) if wrap else aux
        return aux

    def _moe_parallel(self, tp, tokens):
        """The :class:`incubate.moe.ExpertParallel` of this model's MoE
        layers under ``tp`` (None without a mesh): the experts' axis and
        their hidden units' axis from the placements, the tokens split
        over ``tokens``."""
        if tp is None or self.config.num_experts == 0:
            return None
        return _moe.ExpertParallel(tp.mesh, tokens, tp.expert_axis,
                                   tp.axis if tp.ffn else None)

    def _moe(self, x, lw, ep):
        c = self.config
        return _moe.moe_ffn(x, lw["gate_w"], lw["fc1_w"], lw["fc1_b"],
                            lw["fc2_w"], lw["fc2_b"], top_k=c.moe_top_k,
                            capacity_factor=c.moe_capacity_factor, ep=ep,
                            stats=self.moe_stats)

    def _forward(self, input_ids, w, generator, kernel):
        c = self.config
        tp = self._tp
        # under a sequence split this rank holds tokens [off, off + S) of
        # every row (distributed.env.sequence_split)
        sp = sequence_split()
        S = input_ids.shape[1]
        off = 0 if sp is None else sp.offset(S)
        if tp is None:
            h = w["wte"][input_ids]
            if not c.use_rope:
                h = h + w["wpe"][off:off + S]
        else:
            h = tp.embed(w["wte"], w.get("wpe"), input_ids,
                         torch.arange(off, off + S, device=input_ids.device))
        drop = self.training and c.dropout > 0
        gen = self.dropout_generator if generator is None else generator
        if drop and sp is not None:
            gen = self.chunk_generator(gen, sp.index)
        ep = (None if tp is None
              else self._moe_parallel(tp, row_axes()))
        stage = self._stage_fn(kernel, ep, sp, gen if drop else None)
        lws = {n: w[n] for n in self._stacked}
        if self._pp is None:
            h = stage(lws, h)
        else:
            h = self._pipelined(stage, lws, h)
        aux = None
        if c.num_experts > 0:
            h, aux = h
        lnf_w, lnf_b = w["lnf_w"], w["lnf_b"]
        head = w["wte"].T if c.tie_word_embeddings else w["lm_head"]
        if self._pp is not None and not self._pp.last:
            # every rank runs the head on the replicated output; only the
            # last stage's copy takes the head's gradient, so their sum
            # over pp counts it once (and a tied wte gets the first
            # stage's embedding gradient beside it)
            lnf_w, lnf_b, head = lnf_w.detach(), lnf_b.detach(), \
                head.detach()
        h = _norm(h, lnf_w, lnf_b, c.layer_norm_epsilon)
        if tp is None:
            logits = torch.matmul(h, head)
        else:
            logits = tp.logits(h, head, "wte" if c.tie_word_embeddings
                               else "lm_head")
        if aux is not None:
            return logits, aux
        return logits

    def _stage_fn(self, kernel, ep, sp, gen):
        """``stage(lws, h)``: the blocks of the stacked layer weights
        ``lws`` (``{name: [n, ...]}``) run in order on ``h``; an MoE model's
        returns ``(h, aux summed over them)``.  With ``gen``, each block's
        two dropout keep masks are drawn from it before the block runs."""
        c = self.config

        def stage(lws, h):
            auxs = []
            layers = {n: t.unbind(0) for n, t in lws.items()}
            for l in range(len(next(iter(layers.values())))):
                lw = {n: t[l] for n, t in layers.items()}
                keep = (None if gen is None else tuple(
                    _keep_mask(h.shape, c.dropout, gen, h.device)
                    for _ in range(2)))
                h = self._block(h, lw, keep, kernel, ep, sp)
                if c.num_experts > 0:
                    h, aux = h
                    auxs.append(aux)
            return (h, torch.stack(auxs).sum()) if auxs else h
        return stage

    def _pipelined(self, stage, lws, h):
        """``stage`` over this rank's rows as the pipeline of the config's
        schedule (``distributed.pipeline.pipeline_apply``: GPipe, or the
        interleaved one at ``virtual_pp_degree`` chunks), ``M = 2 * pp``
        microbatches lowered until they divide the batch (with the JAX
        warning); the output replicated over ``pp``."""
        st = self._pp
        M = 2 * st.pp
        while h.shape[0] % M and M > 1:
            M -= 1
        if M < 2 * st.pp:
            warnings.warn(
                f"pipeline microbatches degraded to {M} (batch "
                f"{h.shape[0]} not divisible by {2 * st.pp}); bubble "
                f"fraction increases — prefer batch % {2 * st.pp} == 0",
                RuntimeWarning, stacklevel=4)
        chunks = {n: t.reshape(st.V, st.per_chunk, *t.shape[1:])
                  for n, t in lws.items()}
        return pipeline_apply(
            stage, chunks, h, M, mesh=st.mesh, remat=False,
            schedule="interleaved" if st.V > 1 else "gpipe",
            num_chunks=st.V, with_aux=self.config.num_experts > 0)

    # -- the 1F1B / zero-bubble decomposition -------------------------------
    def pipeline_parts(self, tp_axis=None):
        """The model cut for ``distributed.pipeline.pipeline_value_and_grad``
        (``Pipeline1F1BTrainStep``): the embedding in the first stage,
        this rank's blocks in every stage, the final norm, head and
        token-sum cross entropy in the last.

        Returns ``(first_fn, mid_fn, last_fn, stage_params, extras,
        grad_names, specs, grad_fixup)`` as the JAX method does:
        ``stage_params`` are this rank's rows of the stacked parameters
        (the parameters themselves), ``extras`` the embedding and head
        weights (whole, or this rank's tensor-parallel shards), ``specs``
        and ``grad_fixup`` None (the shards are the parameters' own, so
        nothing is permuted).  With dropout (``mb_aware``) each block's
        masks come from ``dropout_generator`` as its forward runs, and a
        microbatch's backward uses its forward's graph, masks included.
        An MoE model's ``mid_fn`` returns ``(h, aux * moe_aux_weight)``
        (``aux_aware``).  ``tp_axis``: the manual tensor-parallel stage
        bodies (:meth:`_pipeline_parts_tp`)."""
        if self._pp is not None and self._pp.V > 1:
            raise ValueError(
                "pipeline_parts: this model holds the interleaved "
                "schedule's chunks (pp_schedule='interleaved'); the 1F1B "
                "and zero-bubble steps run contiguous stages")
        if tp_axis is not None:
            return self._pipeline_parts_tp(tp_axis)
        tp = self._tp
        first_fn, mid_fn, stage_params, extras = self._pipeline_common()

        def last_fn(ex, h, labels):
            h = _norm(h, ex["lnf_w"], ex["lnf_b"],
                      self.config.layer_norm_epsilon)
            tie = self.config.tie_word_embeddings
            head = ex["wte"].T if tie else ex["head"]
            logits = (torch.matmul(h, head) if tp is None else
                      tp.logits(h, head, "wte" if tie else "lm_head"))
            lg = logits.float()
            picked = lg.gather(-1, labels.long()[..., None])[..., 0]
            return torch.sum(torch.logsumexp(lg, -1) - picked)

        return (first_fn, mid_fn, last_fn, stage_params, extras,
                list(stage_params), None, None)

    def _pipeline_common(self):
        """``(first_fn, mid_fn, stage_params, extras)`` of
        :meth:`pipeline_parts`."""
        c = self.config
        tp = self._tp
        w = self._weights()
        stage_params = {n: w[n] for n in self._stacked}
        extras = {"wte": w["wte"], "lnf_w": w["lnf_w"], "lnf_b": w["lnf_b"]}
        if not c.use_rope:
            extras["wpe"] = w["wpe"]
        if not c.tie_word_embeddings:
            extras["head"] = w["lm_head"]
        drop = self.training and c.dropout > 0
        stage = self._stage_fn(True, self._moe_parallel(tp, row_axes()),
                               None, self.dropout_generator if drop else None)

        def first_fn(ex, ids):
            S = ids.shape[1]
            if tp is None:
                h = ex["wte"][ids]
                return h if c.use_rope else h + ex["wpe"][:S]
            return tp.embed(ex["wte"], ex.get("wpe"), ids,
                            torch.arange(S, device=ids.device))

        first_fn.like = lambda ids: torch.empty(
            (*ids.shape, c.hidden_size), dtype=_DTYPES[c.dtype],
            device=ids.device)

        def mid_fn(sp, h, m=0):
            out = stage(sp, h)
            if c.num_experts > 0:
                return out[0], out[1] * c.moe_aux_weight
            return out

        mid_fn.mb_aware = drop
        mid_fn.aux_aware = c.num_experts > 0
        return first_fn, mid_fn, stage_params, extras

    def _pipeline_parts_tp(self, axis):
        """:meth:`pipeline_parts` with manual tensor-parallel bodies over
        mesh axis ``axis``: the blocks' column/row splits (``copy_to_mp``,
        ``reduce_from_mp``, as every forward of the tensor-parallel GPT),
        the vocabulary-parallel embedding and the vocabulary-parallel
        cross entropy on the local logits (``mp_ops``), the JAX
        ``_pipeline_parts_tp``'s.  Each rank already holds its heads'
        ``[q | k | v]`` columns, so no permutation and no
        ``grad_fixup``."""
        c = self.config
        if c.num_experts > 0:
            raise NotImplementedError(
                "MoE blocks under the manual-TP 1F1B path are not "
                "supported; use incubate.MoELayer with the GSPMD schedules")
        mesh = self._tp.mesh
        mp = mesh.degree(axis)
        if c.num_heads % mp or c.ffn_hidden_size % mp or c.vocab_size % mp:
            raise ValueError(
                f"tensor parallel degree {mp} must divide num_heads "
                f"{c.num_heads}, ffn_hidden {c.ffn_hidden_size} and vocab "
                f"{c.vocab_size}")
        embed, mid_fn, stage_params, extras = self._pipeline_common()
        tie = c.tie_word_embeddings

        def first_fn(ex, ids):
            h = mp_ops.vocab_parallel_embedding(ids, ex["wte"], axis, mesh)
            if not c.use_rope:
                h = h + ex["wpe"][:ids.shape[1]]
            return h

        first_fn.like = embed.like

        def last_fn(ex, h, labels):
            hn = mp_ops.copy_to_mp(_norm(h, ex["lnf_w"], ex["lnf_b"],
                                         c.layer_norm_epsilon), axis, mesh)
            head = ex["wte"].T if tie else ex["head"]   # local [H, V/mp]
            return mp_ops.vocab_parallel_ce_sum(torch.matmul(hn, head),
                                                labels, axis, mesh)

        return (first_fn, mid_fn, last_fn, stage_params, extras,
                list(stage_params), None, None)

    def _block(self, h, lw, keep, kernel, ep=None, sp=None):
        """One transformer block, cut into stages at the activations that
        recompute keeps: ``qkv``, ``attn_out`` and ``ffn_up`` (JAX
        ``checkpoint_name``s).  A checkpointed stage saves only its
        inputs and replays the rest in the backward.  An MoE block
        returns ``(h, aux)``; its FFN has no ``ffn_up`` to keep, so
        ``"selective"`` replays it as ``"selective_lean"`` does (routing
        and dropout replay identically: the same inputs and masks).

        Under a sequence split ``sp`` the block holds this rank's chunk
        of every row; only attention crosses the chunks.  With
        ``context_parallel`` it is the ring (K1 on chunk pairs); else
        (``sequence_parallel``, or neither flag: the values GSPMD gives
        the JAX package) qkv is all-gathered along the sequence
        (reduce-scattered in the backward), K1 runs over the whole
        sequence and the block keeps this rank's rows of its output.
        LayerNorm, the FFN, dropout and the residual run on the local
        rows: the JAX ``P(dp, sep, None)`` residual."""
        c = self.config
        eps = c.layer_norm_epsilon
        drop = (None if keep is None else
                lambda x, i: _dropout(x, c.dropout, keep[i]))
        tp = self._tp
        col_in, row_out = _tp_io(tp)

        def qkv_of(h):
            x = col_in(_norm(h, lw["ln1_w"], lw["ln1_b"], eps), "attn")
            return torch.matmul(x, lw["qkv_w"]) + lw["qkv_b"]

        ring = sp is not None and c.context_parallel
        gather = sp is not None and not c.context_parallel

        def attend(qkv):
            b, s, H3 = qkv.shape
            hd = c.hidden_size // c.num_heads
            nh = H3 // 3 // hd
            if gather:
                qkv = mp_ops.all_gather_seq(qkv, sp.axis, sp.mesh)
            q, k, v = (t.reshape(b, -1, nh, hd)
                       for t in qkv.split(H3 // 3, -1))
            if c.use_rope:
                off = sp.offset(s) if ring else 0
                q, k = apply_rope(q, offset=off), apply_rope(k, offset=off)
            if ring:
                o = ring_attention(q, k, v, causal=True, axis=sp.axis,
                                   mesh=sp.mesh, kernel=kernel)
            elif c.use_flash_attention:
                o = flash_attention_fwd(q, k, v, causal=True, kernel=kernel)
            else:
                o = reference_attention(q, k, v, causal=True)
            if gather:
                o = o.narrow(1, sp.offset(s), s)
            return o.reshape(b, s, H3 // 3)

        def post_attn(h, o):
            a = row_out(torch.matmul(o, lw["proj_w"]), "attn") + lw["proj_b"]
            return h + (a if drop is None else drop(a, 0))

        def up_of(h2):
            x = col_in(_norm(h2, lw["ln2_w"], lw["ln2_b"], eps), "ffn")
            return torch.matmul(x, lw["fc1_w"]) + lw["fc1_b"]

        def ffn(h2, up):
            f = (row_out(torch.matmul(F.gelu(up, approximate="tanh"),
                                      lw["fc2_w"]), "ffn")
                 + lw["fc2_b"])
            return h2 + (f if drop is None else drop(f, 1))

        moe = self.config.num_experts > 0

        def moe_ffn(h2):
            x = _norm(h2, lw["ln2_w"], lw["ln2_b"], eps)
            f, aux = self._moe(x, lw, ep)
            return h2 + (f if drop is None else drop(f, 1)), aux

        def after_attn(h, o):
            h2 = post_attn(h, o)
            return moe_ffn(h2) if moe else ffn(h2, up_of(h2))

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
        if mode == "selective_lean" or moe:
            return ckpt(after_attn, h, o)
        # keeping ffn_up but not the residual stream between the two
        # stages, so each stage replays the projection from attn_out
        up = ckpt(lambda h, o: up_of(post_attn(h, o)), h, o)
        return ckpt(lambda h, o, up: ffn(post_attn(h, o), up), h, o, up)

    # -- serving entry points (paddle_tpu_torch.serving.LLMEngine) ----------
    def decode_state(self):
        """The weights the serving entry points read, as one dict of the
        parameters themselves (no copies)."""
        if self._pp is not None:
            raise NotImplementedError(
                "serving a GPT built under a mesh with pp > 1 (each rank "
                "holds its stages' layers only) is not ported yet: "
                "ROADMAP.md A7e-models; build the model without the mesh "
                "(set_mesh(None)) to serve it")
        w = self._weights()
        return {
            "lws": {n: w[n] for n in self._stacked},
            "wte": w["wte"],
            "wpe": w.get("wpe"),
            "lnf_w": w["lnf_w"],
            "lnf_b": w["lnf_b"],
            "head": w.get("lm_head"),
            "tp": self._tp,
        }

    def _ffn(self, h, lw, al=None, aids=None, tp=None):
        _, row_out = _tp_io(tp)
        x = _norm(h, lw["ln2_w"], lw["ln2_b"], self.config.layer_norm_epsilon)
        if self.config.num_experts > 0:
            # every row of the launch routes (padding and idle rows
            # included) and the loss is dropped, as JAX's ``_aux``; the
            # serving tokens are replicated over the mesh
            f, _ = self._moe(x, lw, self._moe_parallel(tp, ()))
            return h + f
        up = _mm_lora(x, lw, "fc1_w", al, aids) + lw["fc1_b"]
        return h + (row_out(_mm_lora(F.gelu(up, approximate="tanh"), lw,
                                     "fc2_w", al, aids), "ffn")
                    + lw["fc2_b"])

    def _layers(self, w, ids, pos, attend, adapters=None, adapter_ids=None):
        """Embed ``ids[B, T]``, whose tokens sit at positions ``pos``
        (int64 ``[B, T]``, or ``[1, T]`` shared by every row), and run
        every block over them.  ``attend(l, q, k, v)`` writes layer
        ``l``'s new K/V ``[B, T, nh, hd]`` into its cache in place and
        returns the attention output ``[B, T, nh, hd]``: the serving
        layouts differ only there.  Learned positions past the table (a
        padded tail) are clamped token by token, so the live tokens
        always get their own; RoPE turns each token by its own position.
        LoRA: ``adapters`` holds the slabs ``a_<t> [L, n_slots, d_in, R]``
        / ``b_<t> [L, n_slots, R, d_out]`` for ``t`` in qkv_w, proj_w,
        fc1_w, fc2_w (under ``tp``, this rank's cut:
        :meth:`TensorParallel.lora_local`) and ``adapter_ids [B]`` each
        row's slot (:func:`_mm_lora`; 0 = the base model).  Returns
        ``h[B, T, H]`` before the final norm."""
        c = self.config
        hd = c.hidden_size // c.num_heads
        B, T = ids.shape
        tp = w.get("tp")
        _, row_out = _tp_io(tp)
        wpos = (None if w["wpe"] is None
                else pos.clamp(max=w["wpe"].shape[0] - 1))
        if tp is None:
            h = w["wte"][ids]
            if w["wpe"] is not None:
                h = h + w["wpe"][wpos]
        else:
            h = tp.embed(w["wte"], w["wpe"], ids, wpos)
        for l in range(c.num_layers):
            lw = {n: t[l] for n, t in w["lws"].items()}
            al = (None if adapters is None
                  else {n: t[l] for n, t in adapters.items()})
            x = _norm(h, lw["ln1_w"], lw["ln1_b"], c.layer_norm_epsilon)
            qkv = _mm_lora(x, lw, "qkv_w", al, adapter_ids) + lw["qkv_b"]
            H = qkv.shape[-1] // 3     # this rank's heads under tp
            q, k, v = (t.reshape(B, T, H // hd, hd)
                       for t in qkv.split(H, dim=-1))
            if c.use_rope:
                q, k = _rope_grid(q, pos), _rope_grid(k, pos)
            o = attend(l, q, k, v)
            h = h + (row_out(_mm_lora(o.reshape(B, T, H).to(h.dtype), lw,
                                      "proj_w", al, adapter_ids), "attn")
                     + lw["proj_b"])
            h = self._ffn(h, lw, al, adapter_ids, tp)
        return h

    def _logits(self, w, h):
        """Final norm + LM head in the model dtype, then fp32 logits."""
        h = _norm(h, w["lnf_w"], w["lnf_b"], self.config.layer_norm_epsilon)
        tied = self.config.tie_word_embeddings
        head = w["wte"].T if tied else w["head"]
        tp = w.get("tp")
        if tp is None:
            return torch.matmul(h, head).float()
        return tp.logits(h, head, "wte" if tied else "head").float()

    def _cached_layers(self, w, ids, cache_k, cache_v, pos):
        """Run every block over ``ids[B, T]``, whose tokens sit at
        positions ``[pos, pos + T)`` (``pos`` a host int).  Each layer
        writes its K/V **in place** into ``cache_k``/``cache_v [L, B, S,
        nh, hd]`` at those positions (slice assignment: a view of an
        arena row writes through to the arena), then attends densely over
        the cache to keys ``kpos <= qpos``.  Returns ``h[B, T, H]``."""
        T = ids.shape[1]
        qpos = pos + torch.arange(T, device=ids.device)[None]      # [1, T]
        mask = _causal_mask(qpos, cache_k.shape[2])

        def attend(l, q, k, v):
            ck, cv = cache_k[l], cache_v[l]
            ck[:, pos:pos + T] = k.to(ck.dtype)
            cv[:, pos:pos + T] = v.to(cv.dtype)
            return _dense_attention(q, ck, cv, mask)

        return self._layers(w, ids, qpos, attend)

    @torch.no_grad()
    def prefill_slot(self, w, ids, length, cache_k, cache_v):
        """Prefill ONE right-padded prompt ``ids[1, Sb]`` of true length
        ``length`` (a host int) into a slot's cache row ``cache_k``/
        ``cache_v [L, 1, S, nh, hd]`` with ``S >= Sb`` — the engine passes
        a view of its arena row.  Positions ``[0, Sb)`` are written in
        place and attended over, then everything from ``length`` on is
        zeroed, so the row holds only live K/V.  Returns the fp32
        next-token logits ``[1, V]`` at position ``length - 1``."""
        Sb = ids.shape[1]
        h = self._cached_layers(w, ids, cache_k[:, :, :Sb],
                                cache_v[:, :, :Sb], 0)
        cache_k[:, :, length:] = 0
        cache_v[:, :, length:] = 0
        return self._logits(w, h[:, length - 1])

    @torch.no_grad()
    def decode_slots(self, w, tok, pos, cache_k, cache_v):
        """One decode step for B independent slot rows at per-row
        positions.  tok ``[B]`` and pos ``[B]`` int32, cache_k/cache_v
        ``[L, B, S, nh, hd]`` (the engine's arena).  Each row writes its
        K/V in place at ``pos[row]`` and attends to ``kpos <= pos[row]``.
        Returns the fp32 logits ``[B, V]``.  Rows are independent, so a
        slot's tokens are those of ``generate`` decoding its request
        alone."""
        pos_l = pos.long()
        rows = torch.arange(tok.shape[0], device=tok.device)
        mask = _causal_mask(pos_l[:, None], cache_k.shape[2])

        def attend(l, q, k, v):
            ck, cv = cache_k[l], cache_v[l]
            ck.index_put_((rows, pos_l), k[:, 0].to(ck.dtype))
            cv.index_put_((rows, pos_l), v[:, 0].to(cv.dtype))
            return _dense_attention(q, ck, cv, mask)

        h = self._layers(w, tok.long()[:, None], pos_l[:, None], attend)
        return self._logits(w, h[:, 0])

    @torch.no_grad()
    def prefill_paged(self, w, ids, start, length, bt, pool_k, pool_v,
                      scale_k=None, scale_v=None, adapters=None,
                      adapter_ids=None):
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
        over the gathered view dequantized to fp32.

        LoRA: ``adapters``/``adapter_ids [1]`` as in :meth:`_layers`."""
        C = ids.shape[1]
        bs = pool_k.shape[2]
        max_blocks = bt.shape[0]
        ar = torch.arange(C, device=ids.device)
        valid = ar < length
        tokpos = start + ar
        bt_l = bt.long()
        # padded tokens write (zeroed) into the trash block 0; the clamp
        # keeps a tail that runs past the table inside it
        blk = torch.where(valid, bt_l[(tokpos // bs).clamp(max=max_blocks - 1)],
                          0)
        off = tokpos % bs
        mask = _causal_mask(tokpos[None], max_blocks * bs)

        def attend(l, q, k, v):
            g = [_paged_write_gather(pool[l], None if sp is None else sp[l],
                                     new[0], blk, off, bt_l, keep=valid)
                 for pool, sp, new in ((pool_k, scale_k, k),
                                       (pool_v, scale_v, v))]
            return _dense_attention(q, *(t.flatten(0, 1)[None] for t in g),
                                    mask)

        h = self._layers(w, ids, tokpos[None], attend, adapters, adapter_ids)
        return self._logits(w, h[:, length - 1])

    @torch.no_grad()
    def decode_paged(self, w, tok, pos, bt, pool_k, pool_v, scale_k=None,
                     scale_v=None, kernel=True, adapters=None,
                     adapter_ids=None):
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
        dequantizing version with ``kernel=False``.

        LoRA: ``adapters``/``adapter_ids [B]`` as in :meth:`_layers`."""
        c = self.config
        scale = 1.0 / math.sqrt(c.hidden_size // c.num_heads)
        decode_attention = (_pa.paged_decode_attention if kernel
                            else _pa.paged_decode_attention_reference)
        tp = w.get("tp")
        if kernel and tp is not None and tp.attn:
            # each rank launches the kernel on its head slice
            def decode_attention(*a, scale):
                return _pa.sharded_paged_decode_attention(
                    tp.mesh, tp.axis, *a, scale=scale)
        pos_l = pos.long()
        rows = torch.arange(tok.shape[0], device=tok.device)
        blk = bt.long()[rows, pos_l // pool_k.shape[2]]             # [B]
        off = pos_l % pool_k.shape[2]

        def attend(l, q, k, v):
            scales = () if scale_k is None else (scale_k[l], scale_v[l])
            # idle rows all write the trash slot (0, 0); nothing live
            # reads it, so the duplicate indices are harmless
            for pool, sp, new in ((pool_k, scale_k, k), (pool_v, scale_v, v)):
                _paged_write(pool[l], None if sp is None else sp[l],
                             new[:, 0], blk, off)
            o = decode_attention((q[:, 0] * scale).contiguous(), pool_k[l],
                                 pool_v[l], bt, pos, *scales, scale=1.0)
            return o[:, None]

        h = self._layers(w, tok.long()[:, None], pos_l[:, None], attend,
                         adapters, adapter_ids)
        return self._logits(w, h[:, 0])

    @torch.no_grad()
    def verify_paged(self, w, toks, pos0, n_valid, bt, pool_k, pool_v,
                     scale_k=None, scale_v=None, adapters=None,
                     adapter_ids=None):
        """Speculative-decoding verify step: score ``K1`` token positions
        per row in one pass over the paged pools (the multi-query sibling
        of :meth:`decode_paged`; see ``serving.speculative``).

        ``toks[B, K1]`` holds each row's last committed token followed by
        its ``K1 - 1`` draft proposals; ``toks[b, j]`` sits at position
        ``pos0[b] + j``.  ``n_valid[B]`` (1..K1) caps how many of the
        positions are real: writes for ``j >= n_valid`` are routed to the
        trash block 0, so a row near its token budget never writes past
        the blocks its admission reserved.  Each valid token's K/V is
        written in place at ``bt[b, (pos0+j) // bs]``, offset ``(pos0+j)
        % bs`` (overwriting stale rejected-draft K/V of earlier rounds),
        and only then is the row's logical sequence gathered: query ``j``
        attends to ``kpos <= pos0 + j``.  Returns the fp32 logits ``[B,
        K1, V]`` at every position.  Quantized pools (with
        ``scale_k``/``scale_v``) quantize on insert and attend over the
        dequantized gather, as :meth:`prefill_paged` does.  LoRA:
        ``adapters``/``adapter_ids [B]`` as in :meth:`_layers`."""
        B, K1 = toks.shape
        bs = pool_k.shape[2]
        max_blocks = bt.shape[1]
        dev = toks.device
        ar = torch.arange(K1, device=dev)
        pos = pos0.long()[:, None] + ar[None, :]                     # [B, K1]
        valid = ar[None, :] < n_valid.long()[:, None]
        bt_l = bt.long()
        rows = torch.arange(B, device=dev)[:, None]
        # positions past n_valid may index past the table: the where()
        # routes them to the trash block before any write lands
        blk = torch.where(valid, bt_l[rows, (pos // bs).clamp(
            max=max_blocks - 1)], 0)
        off = pos % bs
        mask = _causal_mask(pos, max_blocks * bs)

        def attend(l, q, k, v):
            # scatter before the gather: query j sees the committed prefix
            # and every draft token at or before its own position
            g = [_paged_write_gather(pool[l], None if sp is None else sp[l],
                                     new, blk, off, bt_l)
                 for pool, sp, new in ((pool_k, scale_k, k),
                                       (pool_v, scale_v, v))]
            return _dense_attention(q, *(t.flatten(1, 2) for t in g), mask)

        return self._logits(w, self._layers(w, toks.long(), pos, attend,
                                            adapters, adapter_ids))

    @torch.no_grad()
    def generate(self, input_ids, max_new_tokens=32, do_sample=False,
                 temperature=1.0, top_k=0, top_p=1.0, eos_token_id=None,
                 seed=None):
        """Autoregressive decoding over a static KV cache ``[L, B, T +
        max_new_tokens, nh, hd]`` on the model's device: one prefill of
        ``input_ids [B, T]``, then one step a token.  Returns the int64
        token ids ``[B, T + max_new_tokens]``; after ``eos_token_id`` a
        row keeps emitting it.

        Sampling (``do_sample=True``) draws from one ``torch.Generator``
        on the model's device seeded with ``seed`` (an unseeded one when
        ``seed`` is None): one draw over ``[B, V]`` after the prefill,
        then one a step — the slot engine's order, so a batch-1 sampled
        ``generate`` and a sampled engine request with the same seed give
        the same tokens.  Greedy decoding makes no generator.  Past
        ``max_seq_len`` without RoPE raises ``ValueError``."""
        c = self.config
        dev = self.device
        ids = torch.as_tensor(np.asarray(input_ids)
                              if not isinstance(input_ids, torch.Tensor)
                              else input_ids).to(dev).long()
        if ids.dim() != 2:
            raise ValueError(f"input_ids must be [B, T], got {tuple(ids.shape)}")
        B, T = ids.shape
        n = int(max_new_tokens)
        if n < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {n}")
        S = T + n
        if S > c.max_seq_len and not c.use_rope:
            raise ValueError(f"generation length {S} exceeds max_seq_len "
                             f"{c.max_seq_len}")
        gen = None
        if do_sample:
            gen = torch.Generator(device=dev)
            if seed is None:
                gen.seed()
            else:
                gen.manual_seed(int(seed))
        knobs = dict(do_sample=bool(do_sample), temperature=float(temperature),
                     top_k=int(top_k), top_p=float(top_p))
        w = self.decode_state()
        hd = c.hidden_size // c.num_heads
        nh = w["lws"]["qkv_w"].shape[-1] // 3 // hd   # this rank's heads
        shape = (c.num_layers, B, S, nh, hd)
        ck = torch.zeros(shape, dtype=w["wte"].dtype, device=dev)
        cv = torch.zeros_like(ck)

        def next_token(h_last):
            return sample_tokens(self._logits(w, h_last), gen, **knobs)

        h = self._cached_layers(w, ids, ck, cv, 0)
        tok = next_token(h[:, -1])
        eos = -1 if eos_token_id is None else int(eos_token_id)
        done = tok == eos
        out = [tok]
        for i in range(n - 1):
            h = self._cached_layers(w, tok[:, None], ck, cv, T + i)
            tok = torch.where(done, eos, next_token(h[:, -1]))
            done = done | (tok == eos)
            out.append(tok)
        return torch.cat([ids, torch.stack(out, dim=1)], dim=1)


def _token_split():
    """``(mesh, axes, n)``: the axes the running forward's tokens are split
    over (``distributed.env.token_axes``: the mesh step's rows, then its
    sequence chunks) and their count of ranks; None when each rank sees
    every token."""
    axes = token_axes()
    if not axes:
        return None
    sp = sequence_split()
    mesh = sp.mesh if sp is not None else get_mesh()
    n = mesh.degree(axes)
    return None if n == 1 else (mesh, axes, n)


def _causal_lm_loss(logits, labels, loss_mask=None):
    lg = logits.float()
    picked = lg.gather(-1, labels.long()[..., None])[..., 0]
    loss = torch.logsumexp(lg, -1) - picked
    if loss_mask is None:
        return loss.mean()
    m = loss_mask.float()
    split = _token_split()
    if split is None:
        return (loss * m).sum() / m.sum().clamp_min(1.0)
    # the tokens are split over n ranks, whose masks may count unequally:
    # this rank's masked sum over the GLOBAL count, times n, so that the
    # mesh step's mean over the ranks (of the loss and of the gradients)
    # is the global masked mean the JAX step computes
    mesh, axes, n = split
    count = m.sum().detach().clone()
    communication.all_reduce(count, group=mesh.group(axes))
    return (loss * m).sum() * n / count.clamp_min(1.0)


class GPTPretrainingCriterion(Layer):
    """Causal-LM loss over ``logits [B, S, V]`` and ``labels [B, S]``: fp32
    ``logsumexp - picked`` per token, averaged, or averaged over
    ``loss_mask`` (at least one token) when it is given.  ``Tensor``
    inputs run as the op ``"gpt_loss"`` and give a ``Tensor``.  Inside
    the mesh train step, whose ranks each hold some rows or a chunk of
    the sequence, the masked average is the global batch's: one
    all-reduce of the mask's count."""

    def __init__(self, config=None):
        super().__init__()

    def forward(self, logits, labels, loss_mask=None):
        args = (logits, labels) + (() if loss_mask is None else (loss_mask,))
        if any(isinstance(a, Tensor) for a in args):
            return apply_op("gpt_loss", _causal_lm_loss, *args)
        return _causal_lm_loss(*args)
