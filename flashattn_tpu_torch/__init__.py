"""flashattn_tpu_torch: the PyTorch/CUDA port of :mod:`flashattn_tpu` for
NVIDIA Hopper (H100).

The layout follows the JAX package, module for module.  This slice ports the
serving path: the paged continuous-batching engine
(:mod:`.serving.engine`) over :class:`DecoderLM`'s paged methods, and the
three kernels that path runs, each a hand-written CUDA C++ kernel for
``sm_90a`` under ``csrc/`` with a plain PyTorch version beside it:

* fused LayerNorm forward           (:mod:`.ops.layernorm`)
* varlen flash-attention forward    (:mod:`.ops.flash_attention`)
* paged attention (decode / extend) (:mod:`.ops.paged_attention`)

On CUDA tensors the ops launch their kernels (built with nvcc at first use,
see :mod:`.ops._build`); on CPU tensors they run the plain versions.  The
package imports torch and never jax.
"""

from .nn import functional as F
from .nn.basic import Dropout, Embedding, FusedLayerNorm, LayerNorm1d, Linear
from .ops.flash_attention import (
    flash_attention,
    flash_attention_reference,
    flash_attention_varlen,
    flash_attention_with_lse,
)
from .ops.layernorm import layernorm, layernorm_reference
from .ops.paged_attention import paged_attention, paged_attention_reference
from .models.transformer import (
    DecoderLM,
    FeedForward,
    MultiHeadAttention,
    TransformerLayer,
)
from .serving.engine import ContinuousBatchingEngine
from .convert import load_jax_params

__version__ = "0.1.0"

__all__ = [
    "F",
    "Dropout",
    "Embedding",
    "FusedLayerNorm",
    "LayerNorm1d",
    "Linear",
    "flash_attention",
    "flash_attention_reference",
    "flash_attention_varlen",
    "flash_attention_with_lse",
    "layernorm",
    "layernorm_reference",
    "paged_attention",
    "paged_attention_reference",
    "DecoderLM",
    "FeedForward",
    "MultiHeadAttention",
    "TransformerLayer",
    "ContinuousBatchingEngine",
    "load_jax_params",
]
