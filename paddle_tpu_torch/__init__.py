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
  (``kernels/csrc/flash_attention.cu``; ``flash_attention_d256.cu`` and
  ``flash_attention_mma.cu`` for the other head dims and fp32);
* the training loop around it — learning-rate schedulers
  (``optimizer.lr``), gradient clipping (``nn.clip``), parameter groups
  and the dense optimizer family (``optimizer``), ``amp.GradScaler``,
  train metrics (``profiler.MetricsLogger``), ``FLAGS_check_nan_inf``
  and fused windows of K steps (``io.Window``), replayed on CUDA as
  one CUDA graph a window;
* the paddle-style eager surface — ``Tensor`` with ``stop_gradient``
  (``to_tensor``), op dispatch with AMP's O1/O2 lists
  (``amp.auto_cast``, ``amp.decorate``), ``backward``/``grad``,
  seeding and sampling over per-device generators, ``nn.Layer`` and
  its initializers, ``Linear``/``Embedding``/``LayerNorm``/``Dropout``,
  the transformer encoder, ``distributed.fleet.recompute`` — and BERT
  pretraining on it (``BertForPretraining``), whose attention takes the
  flash kernels;
* LoRA tenants, the host-RAM KV tier and KV migration in the paged
  engine;
* the serving fleet — ``ServingFleet(model, replicas=N,
  prefill_replicas=P, kv_layout="paged")`` behind a ``Router``, with
  disaggregated prefill/decode over KV migration, a ``FleetAutoscaler``,
  and the health, flight-recorder, request-trace and device-time plane
  under it (``profiler``);
* the device mesh — ``distributed.init_parallel_env``/``build_mesh``
  (one process a rank over ``torch.distributed``), the eager
  collectives, ``fleet``, the tensor-parallel GPT,
  ``LLMEngine(mesh=...)`` (K4/K4q on each rank's heads) and
  ``CompiledTrainStep(mesh=...)``;
* Mixture-of-Experts — ``incubate.moe`` (the GShard top-k MoE FFN,
  ``MoELayer``), the MoE GPT (``GPTConfig(num_experts=E)``) trained and
  served through the same entry points, its experts split over ``dp``
  on the mesh (expert parallelism) and their hidden units over ``mp``.

Every entry point runs on ``cuda`` unless the caller passes
``device="cpu"`` or calls ``set_device("cpu")``; without a GPU and
without an explicit device the model raises instead of landing on the
CPU.
"""

from . import amp, distributed, flags, incubate, io, nn, optimizer
from .core.autograd import grad
from .core.dtype import (bfloat16, bool_, float16, float32, float64, int8,
                         int16, int32, int64, uint8)
from .core.tensor import Parameter, Tensor, to_tensor
from .device import get_device, set_device
from .jit import CompiledTrainStep
from .models import (BertConfig, BertForPretraining, BertModel,
                     BertPretrainingCriterion, GPTConfig, GPTForCausalLM,
                     GPTPretrainingCriterion)
from .nn.functional.init_utils import ParamAttr
from .optimizer import Adam, AdamW
from .serving import LLMEngine, ServingFleet
from .tensor.creation import (arange, full, full_like, ones, ones_like,
                              zeros, zeros_like)
from .tensor.manipulation import concat, expand, reshape, transpose
from .tensor.math import add, matmul
from .tensor.random import (bernoulli, get_rng_state, normal, rand, randint,
                            randn, seed, set_rng_state, uniform)
from torch import enable_grad, no_grad

__all__ = ["Adam", "AdamW", "BertConfig", "BertForPretraining", "BertModel",
           "BertPretrainingCriterion", "CompiledTrainStep", "GPTConfig",
           "GPTForCausalLM", "GPTPretrainingCriterion", "LLMEngine",
           "ServingFleet",
           "ParamAttr", "Parameter", "Tensor", "add", "amp", "arange",
           "bernoulli", "bfloat16", "bool_", "concat", "distributed",
           "enable_grad", "expand", "flags", "float16", "float32", "float64",
           "full", "full_like", "get_device", "get_rng_state", "grad",
           "incubate", "int16", "int32", "int64", "int8", "io", "matmul", "nn",
           "no_grad", "normal", "ones", "ones_like", "optimizer", "rand",
           "randint", "randn", "reshape", "seed", "set_device",
           "set_rng_state", "to_tensor", "transpose", "uint8", "uniform",
           "zeros", "zeros_like"]
