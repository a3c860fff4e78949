"""The port's eval CLIs (cpc_audio_tpu/eval/): linear separability, ABX,
ZeroSpeech features, resampling and the Common Voice transfer."""
