"""watermark_host_ms_per_audio_s (host clock, pipelines): the host time of
the program's `watermark` spans in the traced slice (the watermark, a
numpy pass on the host while the card waits) over the audio seconds
vocoded in the slice."""
from portbench.metrics import program_spans


def read(run):
    spans = program_spans.of_slice(run)
    if spans is None:
        return None
    audio_s = program_spans.audio_seconds(spans)
    ms = [(s.end_ns - s.start_ns) / 1e6 for s in spans if s.name == "watermark"]
    if audio_s <= 0 or not ms:
        return None
    return sum(ms) / audio_s
