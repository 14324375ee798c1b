"""flashattn_tpu_torch: the PyTorch/CUDA port of :mod:`flashattn_tpu` for
NVIDIA Hopper (H100).

The layout follows the JAX package, module for module.  Four paths are
ported: serving, the paged continuous-batching engine
(:mod:`.serving.engine`) over :class:`DecoderLM`'s paged methods, and
batched generation over its dense KV cache (:mod:`.training.generate`:
greedy and beam search);
quantized serving, the same engine over a model whose Linears
:func:`quantize_model_weights` made weight-only int8 / fp8
(:class:`QuantizedLinear`) and over int8 / fp8 page pools
(``ContinuousBatchingEngine(..., dtype=torch.int8)``); training,
:func:`make_train_step` over :func:`lm_loss` (optionally in bf16 over f32
masters, :func:`make_mixed_precision_loss`), :func:`make_moe_loss` or
:func:`make_distill_loss`, with the optimizers of :mod:`.optim` (SGD, Adam,
AdamW, Adafactor); and the same model with ``attn_impl="fused_softmax"``
(score matmul, :func:`attn_softmax`, matmul with V).  The model takes
rotary position embeddings (``pos_encoding="rope"``, :mod:`.ops.rope`)
and mixture-of-experts layers (``n_experts``, :mod:`.models.moe`) on
every path, in plain torch ops.  The encoder-decoder model
(:class:`EncoderDecoderLM`, :mod:`.models.seq2seq`: cross-attention through
:class:`MultiHeadAttention`'s ``kv``) trains by the same step and
generates by ``training.generate.greedy_generate_seq2seq``; the
machine-translation app (:mod:`.training.translation`, ``python -m
flashattn_tpu_torch.training.translation``) drives it or the decoder-only
model from tokenizer to BLEU, with checkpoints (:mod:`.utils.checkpoint`)
and the native C++ data loader (:mod:`.utils.native_loader`).
Parallelism (:mod:`.parallel`: named meshes, the TP / FSDP rules, sharded
and ring attention, the GPipe pipeline; ``training.ShardedTrainer``,
``ContinuousBatchingEngine(mesh=...)``) runs one process a rank over
``torch.distributed``.  The
dropout entry
points with bias, residual or activation (:func:`fused_dropout_res_bias`,
:func:`fused_dropout_act_bias`, ``F.dropout_res_bias``,
``F.dropout_act_bias``) are ported too, though no model calls them.  Every
kernel is a hand-written CUDA C++ kernel for ``sm_90a`` under ``csrc/``
with a plain PyTorch version beside it:

* fused LayerNorm forward and backward          (:mod:`.ops.layernorm`)
* flash attention forward and backward (dK/dV, dQ) (:mod:`.ops.flash_attention`)
* paged attention (decode / extend)             (:mod:`.ops.paged_attention`)
* fused dropout (Philox4x32-10), and with bias + residual or bias +
  GELU / ReLU, forward and backward             (:mod:`.ops.dropout`)
* fused masked / causal attention softmax, forward and backward
                                                (:mod:`.ops.softmax`)
* weight-only int8 / fp8 matmul, flash attention over an int8 / fp8 KV
  cache, stochastic-rounding int8 quantization  (:mod:`.ops.quant`)

On CUDA tensors the ops launch their kernels (built with nvcc at first use,
see :mod:`.ops._build`); on CPU tensors they run the plain versions.
:class:`DecoderLM` and :class:`EncoderDecoderLM` build on the CUDA device
unless the caller names another.  The package imports torch and never
jax; the MT app imports its tokenizer, BLEU and progress-bar packages only
inside the functions that use them.
"""

from . import operators
from .module import Module, Parameter
from .nn import functional as F
from .nn.basic import (
    Dropout,
    Embedding,
    FusedLayerNorm,
    LayerNorm1d,
    Linear,
    QuantizedLinear,
    quantize_linear,
)
from .ops.flash_attention import (
    flash_attention,
    flash_attention_reference,
    flash_attention_varlen,
    flash_attention_with_lse,
    mha_attention,
)
from .ops.dropout import (
    fused_dropout,
    fused_dropout_act_bias,
    fused_dropout_res_bias,
)
from .ops.layernorm import layernorm, layernorm_reference
from .ops.paged_attention import paged_attention, paged_attention_reference
from .ops.softmax import (
    attn_softmax,
    attn_softmax_pallas,
    attn_softmax_reference,
)
from .ops.quant import (
    FP8_MAX,
    QuantizedTensor,
    flash_attention_kv_int8,
    int8_weight_only_matmul,
    quantize_fp8,
    quantize_int8,
    quantize_int8_stochastic,
    quantize_kv,
    quantize_model_weights,
    requantize_fp8_to_int8,
)
from .models.moe import MoEFeedForward
from .models.transformer import (
    DecoderLM,
    FeedForward,
    MultiHeadAttention,
    TransformerLayer,
)
from .models.seq2seq import (
    CrossDecoderLayer,
    EncoderDecoderLM,
    EncoderLayer,
)
from .optim import (
    SGD,
    Adafactor,
    Adam,
    AdamW,
    clip_by_global_norm,
    global_norm,
    warmup_cosine,
)
from .serving.engine import ContinuousBatchingEngine
from .training import (
    lm_loss,
    make_distill_loss,
    make_eval_step,
    make_mixed_precision_loss,
    make_moe_loss,
    make_train_scan,
    make_train_step,
)
from .convert import load_jax_params

__version__ = "0.1.0"

__all__ = [
    "operators",
    "Module",
    "Parameter",
    "F",
    "Dropout",
    "Embedding",
    "FusedLayerNorm",
    "LayerNorm1d",
    "Linear",
    "QuantizedLinear",
    "quantize_linear",
    "flash_attention",
    "flash_attention_reference",
    "flash_attention_varlen",
    "flash_attention_with_lse",
    "mha_attention",
    "fused_dropout",
    "fused_dropout_act_bias",
    "fused_dropout_res_bias",
    "layernorm",
    "layernorm_reference",
    "paged_attention",
    "paged_attention_reference",
    "attn_softmax",
    "attn_softmax_pallas",
    "attn_softmax_reference",
    "FP8_MAX",
    "QuantizedTensor",
    "flash_attention_kv_int8",
    "int8_weight_only_matmul",
    "quantize_fp8",
    "quantize_int8",
    "quantize_int8_stochastic",
    "quantize_kv",
    "quantize_model_weights",
    "requantize_fp8_to_int8",
    "MoEFeedForward",
    "DecoderLM",
    "FeedForward",
    "MultiHeadAttention",
    "TransformerLayer",
    "CrossDecoderLayer",
    "EncoderDecoderLM",
    "EncoderLayer",
    "SGD",
    "Adafactor",
    "Adam",
    "AdamW",
    "clip_by_global_norm",
    "global_norm",
    "warmup_cosine",
    "ContinuousBatchingEngine",
    "lm_loss",
    "make_distill_loss",
    "make_eval_step",
    "make_mixed_precision_loss",
    "make_moe_loss",
    "make_train_scan",
    "make_train_step",
    "load_jax_params",
]
