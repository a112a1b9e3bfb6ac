"""Flash attention (port of ``paddle_tpu/kernels/flash_attention.py``).

Causal or full attention of ``[B, H, S, D]`` queries over keys of the
same length, with an online softmax over key tiles, and its backward
with the attention probabilities recomputed from the saved LSE
(flash-attention-2).  Three kernels, each beside its plain version:

* K1 :func:`flash_fwd` (replaces the Pallas ``_fwd_kernel``) — ``(out,
  lse)``; plain version :func:`_flash_fwd_reference`.
* K2 :func:`flash_bwd_dq` (``_bwd_dq_kernel``) — dQ; plain version
  :func:`_bwd_dq_reference`.
* K3 :func:`flash_bwd_dkv` (``_bwd_dkv_kernel``) — dK and dV; plain
  version :func:`_bwd_dkv_reference`.

The kernels are hand-written CUDA for ``sm_90a``; :func:`_library`
picks the source by kernel, head dim and dtype:

* bf16/fp16 at head dims 64, 96 and 128 (``KERNEL_HEAD_DIMS``, GPT-3's
  heads): K1–K3 in ``csrc/flash_attention.cu``, persistent,
  warp-specialised kernels (TMA loads under mbarriers, ``wgmma``
  products; K3 computes the scores transposed so that Pᵀ and dSᵀ feed
  its products from registers);
* bf16/fp16 at head dim 256 (``D256_HEAD_DIM``, ``nn.MultiHeadAttention
  (4096, 16)``'s heads): K1–K3 in ``csrc/flash_attention_d256.cu``, the
  same design recut for D 256 (K1 on 64-key tiles, K2 on 32-key tiles;
  K3's two consumer warpgroups own dV and dK and hand Pᵀ over in fp32);
* everything else — fp32 at every head dim, bf16/fp16 at the other
  multiples of 16 up to 256 — ``csrc/flash_attention_mma.cu``: FA2-style
  loops on warp-level ``mma.sync`` in bf16 and on CUDA cores in fp32,
  built by buckets of 32 dims.

The Hopper sources share ``csrc/flash_hopper.cuh``.  On a CPU tensor
each wrapper calls its plain version; on a CUDA tensor it launches the
kernel or raises.  Each wrapper counts its launches in ``.launches``.

Arithmetic follows the TPU kernel exactly where it rounds: every
product whose operands include a 16-bit tensor (bf16 or fp16) takes
both operands in bf16 and sums in fp32 (``_dot_f32``), so P is rounded
to bf16 before P·V and Pᵀ·dO and dS before dS·K and dSᵀ·Q; fp32 inputs
stay fp32.  The CUDA kernels compute in bf16 and fp32; fp16 runs the
bf16 kernels on operands rounded to bf16 (the same rounding), and they
write O, dQ, dK and dV as fp16 straight from their fp32 accumulators.
Where the fp16 operands are rounded is :func:`_dtype_code`'s choice:
K1–K3 at ``KERNEL_HEAD_DIMS`` read them as they are and round each tile
in shared memory (code 3); the other sources take copies the wrapper
rounds (code 2, :func:`_operands`).
The mask fill is the finite ``NEG_INF``; the outputs are ``acc /
max(l, 1e-30)`` and ``lse = m + log(max(l, 1e-30))``.

The kernels take q, k and v as strided views (last dim contiguous), so
the model hands them the ``[B, S, H, D]`` slices of its qkv projection
without a copy; outputs are written ``[B, S, H, D]``-contiguous and
returned as ``[B, H, S, D]`` views.  δ = rowsum(O∘dO) is a torch op in
:func:`_flash_bwd`, as it is XLA outside the Pallas calls in JAX.
"""

from __future__ import annotations

import ctypes
import math
import warnings

import torch

from ..profiler import counters
from . import _build, count_launch
from ._shapes import NEG_INF, check_divides, check_equal

#: head dims of the wgmma kernels (GPT-3 125M, 760M, 1.3B); the other
#: multiples of 16 up to ``MAX_HEAD_DIM`` run the mma.sync kernels
KERNEL_HEAD_DIMS = (64, 96, 128)
#: head dim whose K1–K3 (bf16/fp16) are ``flash_attention_d256.cu``'s
D256_HEAD_DIM = 256
MAX_HEAD_DIM = 256
#: the kernels take S % 128 == 0, the TPU kernel's rule; the public
#: entry sends other lengths to ``reference_attention``, as JAX does
SEQ_MULTIPLE = 128
#: the kernels' dtype flag: 2 runs the bf16 kernels on operands the
#: wrapper rounded to bf16, with fp16 outputs
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
#: fp16 operands read as they are and rounded to bf16 in the kernel, fp16
#: outputs (``flash_attention.cu``'s K1–K3)
F16_IN_KERNEL = 3


def reference_attention(q, k, v, causal=False, scale=None):
    """Plain O(S²) attention, ``[B, S, H, D]``: fp32 logits, softmax,
    probabilities cast to ``v``'s dtype for the value product."""
    d = q.shape[-1]
    sc = scale if scale is not None else 1.0 / math.sqrt(d)
    logits = torch.einsum("bshd,bthd->bhst", q.float() * sc, k.float())
    if causal:
        s, t = logits.shape[-2], logits.shape[-1]
        mask = torch.ones((s, t), dtype=torch.bool,
                          device=q.device).tril(t - s)
        logits = torch.where(mask, logits,
                             torch.full((), NEG_INF, device=q.device))
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhst,bthd->bshd", p.to(v.dtype), v)


# ---------------------------------------------------------------------------
# plain versions (BHSD layout, as the TPU kernels take it)
# ---------------------------------------------------------------------------
def _operand(x, low_precision):
    """An operand of ``_dot_f32``: rounded to bf16 when the product has a
    16-bit input, then widened so the product sums in fp32."""
    return x.to(torch.bfloat16).float() if low_precision else x.float()


def _dot(a, b, low_precision):
    return torch.matmul(_operand(a, low_precision), _operand(b, low_precision))


def _logits(q, k, causal, scale):
    """fp32 ``scale·QKᵀ`` with the causal mask, ``[B, H, S, S]`` (16-bit
    operands rounded to bf16, as ``_dot_f32`` takes them)."""
    low = q.dtype.itemsize <= 2
    s = _dot(q, k.transpose(-1, -2), low) * scale
    if causal:
        n = s.shape[-1]
        keep = torch.ones((n, n), dtype=torch.bool, device=q.device).tril()
        s = torch.where(keep, s, torch.full((), NEG_INF, device=q.device))
    return s


def _flash_fwd_reference(q, k, v, causal, scale):
    """Plain K1: ``(out [B,H,S,D] in q's dtype, lse [B,H,S,1] fp32)``."""
    low = q.dtype.itemsize <= 2
    s = _logits(q, k, causal, scale)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    out = _dot(p, v, low) / l
    return out.to(q.dtype), m + torch.log(l)


def _probs(q, k, lse, causal, scale):
    """P = exp(scale·QKᵀ − lse), recomputed as the backward kernels do."""
    return torch.exp(_logits(q, k, causal, scale) - lse)


def _bwd_dq_reference(q, k, v, do, lse, delta, causal, scale):
    """Plain K2: dQ = scale·[P∘(dO·Vᵀ − δ)]·K, in q's dtype."""
    low = q.dtype.itemsize <= 2
    p = _probs(q, k, lse, causal, scale)
    ds = p * (_dot(do, v.transpose(-1, -2), low) - delta)
    return (_dot(ds, k, low) * scale).to(q.dtype)


def _bwd_dkv_reference(q, k, v, do, lse, delta, causal, scale):
    """Plain K3: dV = Pᵀ·dO and dK = scale·dSᵀ·Q, in q's dtype."""
    low = q.dtype.itemsize <= 2
    p = _probs(q, k, lse, causal, scale)
    ds = p * (_dot(do, v.transpose(-1, -2), low) - delta)
    dv = _dot(p.transpose(-1, -2), do, low)
    dk = _dot(ds.transpose(-1, -2), q, low) * scale
    return dk.to(q.dtype), dv.to(q.dtype)


def _delta(out, do, dlse=None):
    """δ = rowsum(O∘dO) ``[B,H,S,1]`` fp32; an LSE cotangent g enters as
    δ − g (d lse_i / d s_ij = p_ij, so ds = p·(dp − δ + g))."""
    delta = (out.float() * do.float()).sum(-1, keepdim=True)
    if dlse is not None:
        delta = delta - dlse.float()[..., None]
    return delta


def _flash_bwd_reference(q, k, v, out, lse, do, causal, scale, dlse=None):
    """Plain K2 + K3 behind δ: ``(dq, dk, dv)``."""
    delta = _delta(out, do, dlse)
    dq = _bwd_dq_reference(q, k, v, do, lse, delta, causal, scale)
    dk, dv = _bwd_dkv_reference(q, k, v, do, lse, delta, causal, scale)
    return dq, dk, dv


# ---------------------------------------------------------------------------
# the CUDA kernels' wrappers
# ---------------------------------------------------------------------------
def _library(D, dtype, kernel="fwd"):
    """The CUDA source whose ``kernel`` (``"fwd"`` K1, ``"dq"`` K2,
    ``"dkv"`` K3) takes head dim ``D`` in ``dtype``.  Today the three
    kernels of one head dim and dtype share a source; callers name the
    kernel so that a source may hold only some of them."""
    if dtype == torch.float32:
        return "flash_attention_mma"
    if D in KERNEL_HEAD_DIMS:
        return "flash_attention"
    if D == D256_HEAD_DIM:
        return "flash_attention_d256"
    return "flash_attention_mma"


def _lib(D=KERNEL_HEAD_DIMS[0], dtype=torch.bfloat16, kernel="fwd"):
    return _bind(_build.load(_library(D, dtype, kernel)))


def _bind(lib):
    """Set the C signatures of the launches ``lib`` exports."""
    if lib.flash_fwd_launch.argtypes is None:
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        L = ctypes.c_longlong
        strides = [L] * 3
        # q, k, v pointers each with (b, h, s) strides; then the rest
        qkv = [P, *strides] * 3
        dims = [I, I, I, I, I, I, F]   # B, H, S, D, dtype, causal, scale
        signatures = {
            "flash_fwd_launch": [*qkv, P, *strides, P, *dims, P],
            "flash_bwd_dq_launch": [*qkv, P, *strides, P, P, P, *strides,
                                    *dims, P],
            "flash_bwd_dkv_launch": [*qkv, P, *strides, P, P, P, *strides,
                                     P, *dims, P]}
        for name, argtypes in signatures.items():
            fn = getattr(lib, name, None)
            if fn is not None:
                fn.argtypes, fn.restype = argtypes, ctypes.c_int
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        lib.flash_attention_smem_bytes.argtypes = [I, I, I]
        lib.flash_attention_smem_bytes.restype = ctypes.c_longlong
    return lib


_AXES = ("batch", "heads", "seq_len", "head_dim")


def _kernel_layout(t):
    """Whether the kernels can read ``t`` as it lies: they move rows in
    16-byte vectors, so the head dim must be contiguous and the data
    pointer and the (b, h, s) strides must be whole vectors."""
    vec = 16 // t.element_size()
    return (t.stride(3) == 1 and t.data_ptr() % 16 == 0
            and all(st % vec == 0 for st in t.stride()[:3]))


def _check_operands(kernel, q, k, v, do=None, lse=None, delta=None):
    """Preflight shared by the three wrappers; returns the device.  Shape
    checks hold on every device; the kernel's own limits (dtype, head
    dim, strides, alignment) on CUDA only."""
    if q.dim() != 4:
        raise ValueError(f"{kernel}: q must be [B, H, S, D], got shape "
                         f"{tuple(q.shape)}")
    B, H, S, D = q.shape
    named = {n: t for n, t in (("q", q), ("k", k), ("v", v), ("do", do),
                               ("lse", lse), ("delta", delta))
             if t is not None}
    dims = {}
    for name, t in named.items():
        stats = name in ("lse", "delta")
        if t.dim() != 4:
            raise ValueError(f"{kernel}: {name} must be 4-d, got shape "
                             f"{tuple(t.shape)}")
        axes = _AXES[:3] + (("trailing",) if stats else ("head_dim",))
        want = (B, H, S, 1 if stats else D)
        for axis, got, w in zip(axes, t.shape, want):
            dims[f"{name}_{axis}"] = (got, w)
    check_equal(kernel, **dims)
    check_divides(kernel, seq_len=(S, SEQ_MULTIPLE))
    devices = {t.device for t in named.values()}
    if len(devices) != 1:
        raise ValueError(f"{kernel}: operands on several devices "
                         f"{sorted(map(str, devices))}")
    dev = q.device
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"{kernel}: unsupported device {dev}")
    if D % 16 or not 16 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"{kernel}: dim 'head_dim'={D}: the CUDA kernels "
                         f"take multiples of 16 up to {MAX_HEAD_DIM} "
                         "(ROADMAP.md B-i)")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"{kernel}: q is {q.dtype}; the kernel takes "
                        "float32, bfloat16 or float16")
    for name, t in named.items():
        stats = name in ("lse", "delta")
        want = torch.float32 if stats else q.dtype
        if t.dtype != want:
            raise TypeError(f"{kernel}: {name} is {t.dtype}, want {want}")
        if stats:
            # K3 copies 64-row slices of both with 16-byte bulk copies
            if not t.is_contiguous() or t.data_ptr() % 16 != 0:
                raise ValueError(f"{kernel}: {name} must be contiguous with "
                                 "a 16-byte aligned data pointer")
            continue
        if not _kernel_layout(t):
            raise ValueError(
                f"{kernel}: {name} needs a contiguous head dim and a data "
                "pointer and (b, h, s) strides in 16-byte units; got "
                f"data_ptr % 16 = {t.data_ptr() % 16}, strides "
                f"{tuple(t.stride())}")
    if not 1 <= B * H <= 65535:
        raise ValueError(f"{kernel}: batch*heads {B * H} outside the "
                         "kernel's grid range [1, 65535]")
    return dev


def _strides(t):
    """(b, h, s) element strides of a ``[B, H, S, D]`` view."""
    return t.stride(0), t.stride(1), t.stride(2)


def _empty_bshd(q):
    """A ``[B, S, H, D]``-contiguous buffer seen as ``[B, H, S, D]``."""
    B, H, S, D = q.shape
    return torch.empty((B, S, H, D), dtype=q.dtype,
                       device=q.device).transpose(1, 2)


def _raise_if(lib, err, kernel):
    if err != 0:
        msg = lib.flash_attention_error_string(err).decode()
        raise RuntimeError(f"{kernel} launch failed: CUDA error {err} "
                           f"({msg})")


def _dtype_code(kernel, D, dtype):
    """The dtype code the launch of ``kernel`` (``"fwd"``, ``"dq"``,
    ``"dkv"``) at head dim ``D`` takes for ``dtype`` operands: fp16 K1–K3
    at ``KERNEL_HEAD_DIMS`` round their operands in the kernel
    (``F16_IN_KERNEL``); every other fp16 launch takes copies rounded by
    the wrapper (2)."""
    if dtype == torch.float16 and D in KERNEL_HEAD_DIMS:
        return F16_IN_KERNEL
    return _DTYPE_CODE[dtype]


def _dims(q, code, causal, scale):
    B, H, S, D = q.shape
    return B, H, S, D, code, int(bool(causal)), float(scale)


def _operands(code, *ts):
    """What a launch with dtype ``code`` reads: at code 2, copies of the
    fp16 operands rounded to bf16 (``_dot_f32`` rounds every 2-byte
    operand so); otherwise the operands as they are (at
    ``F16_IN_KERNEL`` the kernel rounds each fp16 tile itself)."""
    if code != _DTYPE_CODE[torch.float16]:
        return list(ts)
    return [t.to(torch.bfloat16) if t.dtype == torch.float16 else t
            for t in ts]


def flash_fwd(q, k, v, causal, scale):
    """K1: ``(out [B,H,S,D] in q's dtype, lse [B,H,S,1] fp32)`` of
    attention over ``[B, H, S, D]`` q/k/v (any strides with a contiguous
    head dim).  ``out`` is a view of a ``[B, S, H, D]``-contiguous
    buffer."""
    dev = _check_operands("flash_attention_fwd", q, k, v)
    if dev.type == "cpu":
        return _flash_fwd_reference(q, k, v, causal, scale)
    B, H, S, D = q.shape
    out = _empty_bshd(q)
    lse = torch.empty((B, H, S, 1), dtype=torch.float32, device=dev)
    code = _dtype_code("fwd", D, q.dtype)
    qb, kb, vb = _operands(code, q, k, v)
    lib = _lib(D, q.dtype, "fwd")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.flash_fwd_launch(
            qb.data_ptr(), *_strides(qb), kb.data_ptr(), *_strides(kb),
            vb.data_ptr(), *_strides(vb), out.data_ptr(), *_strides(out),
            lse.data_ptr(), *_dims(q, code, causal, scale), stream)
    _raise_if(lib, err, "flash_fwd")
    count_launch(flash_fwd)
    return out, lse


def flash_bwd_dq(q, k, v, do, lse, delta, causal, scale):
    """K2: dQ ``[B,H,S,D]`` in q's dtype from the saved ``lse`` and
    ``delta`` (both ``[B,H,S,1]`` fp32, contiguous)."""
    dev = _check_operands("flash_attention_bwd_dq", q, k, v, do, lse,
                          delta)
    if dev.type == "cpu":
        return _bwd_dq_reference(q, k, v, do, lse, delta, causal, scale)
    dq = _empty_bshd(q)
    code = _dtype_code("dq", q.shape[3], q.dtype)
    qb, kb, vb, dob = _operands(code, q, k, v, do)
    lib = _lib(q.shape[3], q.dtype, "dq")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.flash_bwd_dq_launch(
            qb.data_ptr(), *_strides(qb), kb.data_ptr(), *_strides(kb),
            vb.data_ptr(), *_strides(vb), dob.data_ptr(), *_strides(dob),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), *_strides(dq),
            *_dims(q, code, causal, scale), stream)
    _raise_if(lib, err, "flash_bwd_dq")
    count_launch(flash_bwd_dq)
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, causal, scale):
    """K3: ``(dk, dv)`` ``[B,H,S,D]`` in q's dtype (same inputs as K2)."""
    dev = _check_operands("flash_attention_bwd_dkv", q, k, v, do, lse,
                          delta)
    if dev.type == "cpu":
        return _bwd_dkv_reference(q, k, v, do, lse, delta, causal, scale)
    dk, dv = _empty_bshd(q), _empty_bshd(q)
    code = _dtype_code("dkv", q.shape[3], q.dtype)
    qb, kb, vb, dob = _operands(code, q, k, v, do)
    lib = _lib(q.shape[3], q.dtype, "dkv")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.flash_bwd_dkv_launch(
            qb.data_ptr(), *_strides(qb), kb.data_ptr(), *_strides(kb),
            vb.data_ptr(), *_strides(vb), dob.data_ptr(), *_strides(dob),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), *_strides(dk),
            dv.data_ptr(), *_dims(q, code, causal, scale), stream)
    _raise_if(lib, err, "flash_bwd_dkv")
    count_launch(flash_bwd_dkv)
    return dk, dv


#: kernel launches since each counter was last set to 0 (CUDA tensors
#: only; the CPU path never moves them).
flash_fwd.launches = 0
flash_bwd_dq.launches = 0
flash_bwd_dkv.launches = 0


def _flash_bwd(q, k, v, out, lse, do, causal, scale, dlse=None):
    """K2 and K3 behind δ (the JAX ``_flash_bwd``): ``(dq, dk, dv)``."""
    delta = _delta(out, do, dlse)
    dq = flash_bwd_dq(q, k, v, do, lse, delta, causal, scale)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, causal, scale)
    return dq, dk, dv


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------
class _FlashAttention(torch.autograd.Function):
    """``(out, lse[B,H,S])`` with a backward through K2/K3 — the JAX
    ``_flash_attention_bhsd`` and ``flash_attention_with_lse`` custom
    VJPs in one.  An unused LSE output gets no cotangent (``None``).
    ``kernel=False`` runs the plain versions in both directions."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, kernel):
        fwd = flash_fwd if kernel else _flash_fwd_reference
        out, lse = fwd(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale, ctx.kernel = causal, scale, kernel
        ctx.set_materialize_grads(False)
        return out, lse[..., 0]

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, out, lse = ctx.saved_tensors
        if do is None:
            do = torch.zeros_like(out)
        elif do.is_cuda and not _kernel_layout(do):
            do = do.contiguous()
        bwd = _flash_bwd if ctx.kernel else _flash_bwd_reference
        dq, dk, dv = bwd(q, k, v, out, lse, do, ctx.causal, ctx.scale,
                         dlse=dlse)
        return dq, dk, dv, None, None, None


def flash_attention_with_lse(q, k, v, causal, scale, *, kernel=True):
    """``(out, lse)`` flash attention in the ``[B, H, S, D]`` layout,
    differentiable through both outputs; lse is ``[B, H, S]`` fp32.  Its
    cotangent folds into the backward as δ − dlse (ring attention's
    merge gives every chunk one).  The launches count in K1–K3's
    ``.launches``; ``kernel=False`` swaps K1–K3 for their plain
    versions, as :func:`flash_attention_fwd`'s does."""
    return _FlashAttention.apply(q, k, v, causal, scale, kernel)


def flash_attention_fwd(q, k, v, causal=False, scale=None, *, kernel=True):
    """Public entry, ``[B, S, H, D]`` layout; differentiable.

    S % 128 != 0 goes to :func:`reference_attention`, as the JAX entry
    does (warned once; counted in ``kernels.flash.reference_fallbacks``).
    ``kernel=False`` swaps K1–K3 for their plain versions (used to hold
    the kernels against them inside the model)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    s = q.shape[1]
    if s % SEQ_MULTIPLE != 0:
        if not _warned_fallback[0]:
            _warned_fallback[0] = True
            warnings.warn(
                f"flash_attention: seq_len={s} is not a multiple of "
                f"{SEQ_MULTIPLE}; using O(S^2) reference attention. Pad the "
                "sequence to a 128 multiple for the flash kernels.",
                RuntimeWarning, stacklevel=2)
        counters.inc("kernels.flash.reference_fallbacks")
        return reference_attention(q, k, v, causal, scale)
    out, _ = _FlashAttention.apply(q.transpose(1, 2), k.transpose(1, 2),
                                   v.transpose(1, 2), causal, scale, kernel)
    return out.transpose(1, 2)


_warned_fallback = [False]
