"""Host-side data pipeline: WAV IO, corpus discovery, samplers and the
batch loader (own copies of `cpc2_tpu/data`)."""

from .audio_io import audio_info, load_audio, save_wav
from .corpus import filter_seqs, find_all_seqs
from .dataset import AudioBatchData, AudioLoader

__all__ = ["AudioBatchData", "AudioLoader", "audio_info", "filter_seqs",
           "find_all_seqs", "load_audio", "save_wav"]
