"""Host-side data pipeline: audio IO (WAV, FLAC and compressed formats),
corpus discovery, samplers and the batch loader (own copies of
`cpc2_tpu/data`)."""

from .audio_io import audio_info, load_audio, save_wav
from .corpus import (filter_seqs, find_all_seqs, parse_seq_labels,
                     parseSeqLabels)
from .dataset import (AudioBatchData, AudioLoader, PeakNorm,
                      filter_distributed)

__all__ = ["AudioBatchData", "AudioLoader", "PeakNorm", "audio_info",
           "filter_distributed", "filter_seqs", "find_all_seqs", "load_audio", "parseSeqLabels",
           "parse_seq_labels", "save_wav"]
