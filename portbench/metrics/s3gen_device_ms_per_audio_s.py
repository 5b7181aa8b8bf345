"""s3gen_device_ms_per_audio_s (device trace, S3Gen): device time of the
operations launched inside the benchmark's S3Gen spans in the traced slice
(vocode; in voice conversion also the S3 tokenizer and the reference
voice's embedding), over the audio seconds vocoded in the slice."""

TOKEN_S = 0.04


def read(run):
    s, c = run.summary, run.slice_counters
    if s is None or "t0" not in c:
        return None
    audio_s = TOKEN_S * sum(sum(gs) for t, _, gs in run.counters.get("vocodes", ())
                            if c["t0"] <= t <= c["t1"])
    dev = s.device_s(lambda name, layer: layer.startswith("s3gen"))
    if audio_s <= 0 or dev <= 0:
        return None
    return 1e3 * dev / audio_s
