from .audio_io import decode_file, decode_file_with_rate, file_length
from .dataset import (AudioBatchData, AudioLoader, filter_seqs, find_all_seqs,
                      findAllSeqs, filterSeqs, parse_seq_labels,
                      parseSeqLabels, same_speaker_batch_plan,
                      sequential_batch_plan, uniform_batch_plan)

__all__ = [
    "AudioBatchData", "AudioLoader", "decode_file", "decode_file_with_rate",
    "file_length", "filter_seqs", "find_all_seqs", "findAllSeqs",
    "filterSeqs", "parse_seq_labels", "parseSeqLabels",
    "same_speaker_batch_plan", "sequential_batch_plan", "uniform_batch_plan",
]
