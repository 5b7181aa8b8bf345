"""frontend_device_ms_per_audio_s (device trace, S3Gen frontend): the
device time of the program's `s3gen.tokenize` and `s3gen.embed_ref` spans
in the traced slice (the resampler, the mels, CAMPPlus and the S3
tokenizer, with their uploads and read-backs: stream time less the idle
inside) over the audio seconds vocoded in the slice."""
from portbench.metrics import program_spans


def read(run):
    return program_spans.device_ms_per_audio_s(run, {"s3gen.tokenize", "s3gen.embed_ref"})
