"""PyTorch/CUDA port of ``paddle_tpu`` for one NVIDIA H100.

The JAX package ``paddle_tpu`` is the reference this package is held
against; it is never imported here.  The port goes slice by slice.  So
far it holds, with every Pallas kernel of the reference:

* paged-KV serving — ``GPTForCausalLM``'s paged prefill/decode entry
  points under ``LLMEngine(model, kv_layout="paged")``, with the paged
  decode attention as a hand-written CUDA kernel
  (``kernels/csrc/paged_attention.cu``);
* quantized paged serving — ``LLMEngine(..., kv_dtype="int8"|"fp8",
  weight_dtype="int8")``: 1-byte KV pools with per-token scales, read by
  the same kernel source's quantized variant, and int8 weight-only layer
  matmuls (``quantization.ptq_int8_decode_state``);
* RMSNorm — ``kernels.rms_norm.rms_norm``, a hand-written CUDA kernel
  (``kernels/csrc/rms_norm.cu``);
* GPT training — ``CompiledTrainStep(model, loss_fn, AdamW(...))`` over
  ``GPTForCausalLM.forward`` and ``GPTPretrainingCriterion``, with the
  flash-attention forward, dQ and dK/dV as hand-written CUDA kernels
  (``kernels/csrc/flash_attention.cu``);
* the training loop around it — learning-rate schedulers
  (``optimizer.lr``), gradient clipping (``nn.clip``), parameter groups
  and the dense optimizer family (``optimizer``), ``amp.GradScaler``,
  train metrics (``profiler.MetricsLogger``), ``FLAGS_check_nan_inf``
  and fused windows of K steps (``io.Window``), replayed on CUDA as
  one CUDA graph a window.

Every entry point runs on ``cuda`` unless the caller passes
``device="cpu"``; without a GPU and without an explicit device the model
raises instead of landing on the CPU.
"""

from . import amp, flags, io, nn, optimizer
from .jit import CompiledTrainStep
from .models import GPTConfig, GPTForCausalLM, GPTPretrainingCriterion
from .optimizer import Adam, AdamW
from .serving import LLMEngine

__all__ = ["GPTConfig", "GPTForCausalLM", "GPTPretrainingCriterion",
           "LLMEngine", "CompiledTrainStep", "Adam", "AdamW", "amp",
           "flags", "io", "nn", "optimizer"]
