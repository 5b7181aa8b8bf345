"""flow_device_ms_per_audio_s (device trace, S3Gen flow): the device time
of the program's `s3gen.flow` spans in the traced slice (the flow encoder
and the CFM solver's estimator steps: the stream time between the CUDA
events of each span's enter and exit, less the idle gaps inside it) over
the audio seconds vocoded in the slice (the spans' generated tokens,
0.04 s each)."""
from portbench.metrics import program_spans


def read(run):
    return program_spans.device_ms_per_audio_s(run, {"s3gen.flow"})
