"""Training criteria of the port, and the CTC decoding and PER tools."""

from .bert import CPCBertCriterion
from .criterion import (AdvSpeakerCriterion, CPCUnsupervisedCriterion,
                        CTCPhoneCriterion, ModelCriterionCombined,
                        MultiHeadPredictionNetwork, NoneCriterion,
                        PhoneCriterion, PredictionNetwork, SpeakerCriterion,
                        SupervisedCriterion, collapse_label_chain_padded,
                        sample_negative_indices)
from .custom_layers import (EqualizedConv1d, EqualizedLinear,
                            NormalizationLayer, upscale2d)
from .seq_alignment import (NeedlemanWunschAlignScore, beam_search,
                            collapse_label_chain, collapseLabelChain,
                            get_seq_PER, getPER,
                            needleman_wunsch_align_score)

__all__ = ["AdvSpeakerCriterion", "CPCBertCriterion",
           "CPCUnsupervisedCriterion", "CTCPhoneCriterion",
           "EqualizedConv1d", "EqualizedLinear", "ModelCriterionCombined",
           "MultiHeadPredictionNetwork", "NeedlemanWunschAlignScore",
           "NoneCriterion", "NormalizationLayer", "PhoneCriterion",
           "PredictionNetwork",
           "SpeakerCriterion", "SupervisedCriterion", "beam_search",
           "collapseLabelChain", "collapse_label_chain",
           "collapse_label_chain_padded", "getPER", "get_seq_PER",
           "needleman_wunsch_align_score", "sample_negative_indices",
           "upscale2d"]
