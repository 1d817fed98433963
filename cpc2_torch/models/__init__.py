"""Model modules of the port."""

from .ar import CPCAR, NoAr
from .cpc import CPCModel, ConcatenatedModel
from .encoder import CPCEncoder, ChannelNorm, encoded_seq_len
from .transformer import TransformerAR, build_transformer_ar

__all__ = ["CPCAR", "CPCEncoder", "CPCModel", "ChannelNorm", "ConcatenatedModel", "NoAr",
           "TransformerAR", "build_transformer_ar", "encoded_seq_len"]
