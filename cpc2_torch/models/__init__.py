"""Model modules of the port."""

from .ar import CPCAR, BiDIRAR, BiDIRARTangled, NoAr
from .cpc import (CPCBertModel, CPCModel, ConcatenatedModel,
                  compute_bert_mask, compute_mask_indices)
from .encoder import (CPCEncoder, ChannelNorm, LFBEncoder, MFCCEncoder,
                      encoded_seq_len)
from .transformer import (MultiHeadTransformerAR, TransformerAR,
                          build_transformer_ar)

__all__ = ["BiDIRAR", "BiDIRARTangled", "CPCAR", "CPCBertModel",
           "CPCEncoder", "CPCModel", "ChannelNorm", "ConcatenatedModel",
           "LFBEncoder", "MFCCEncoder", "MultiHeadTransformerAR", "NoAr",
           "TransformerAR", "build_transformer_ar", "compute_bert_mask",
           "compute_mask_indices", "encoded_seq_len"]
