"""audio_s_per_s (host clock): the audio seconds of the requests completed
inside the window over the window's seconds (`run.served`, as the cell's
entry counts them). The window opens as a request is sent and closes as
one completes, so it holds whole requests only."""


def read(run):
    audio_s, seconds = run.served
    if audio_s is None or seconds <= 0:
        return None
    return audio_s / seconds
