"""launch_idle_pct (device trace, host launch path): the share of the
traced slice in which no operation ran on the card while the innermost
program span open on the host was a device span (the host was queueing
that span's work, and had not queued enough). The rest of
device_idle_pct falls in host spans (the watermark, host syncs, numpy
work between them) or outside every span."""
from portbench.metrics import program_spans


def read(run):
    gaps = program_spans.idle_gaps(run)
    if gaps is None or run.summary.window_s <= 0:
        return None
    idle = sum(sec for sec, span in gaps if span is not None and span.device)
    return 100.0 * idle / run.summary.window_s
