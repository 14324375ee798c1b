from . import functional  # noqa: F401
from .basic import Dropout, Embedding, FusedLayerNorm, LayerNorm1d, Linear  # noqa: F401
