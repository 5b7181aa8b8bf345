"""hift_device_ms_per_audio_s (device trace, HiFT): the device time of the
program's `s3gen.hift` spans in the traced slice (HiFT with its float64
phase cumsum, and the trim-fade: stream time less the idle inside) over
the audio seconds vocoded in the slice."""
from portbench.metrics import program_spans


def read(run):
    return program_spans.device_ms_per_audio_s(run, {"s3gen.hift"})
