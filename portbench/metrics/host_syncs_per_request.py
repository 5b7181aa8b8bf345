"""host_syncs_per_request (traced slice, host-device boundary): the
program's `host.sync` spans (a read-back, or a blocking upload from
pageable memory: the host waits for the card's queue) of the requests
whose root span `vc.generate` lies in the traced slice, per request."""
from portbench.metrics import program_spans


def read(run):
    spans = program_spans.of_slice(run)
    if spans is None:
        return None
    roots = {s.request for s in spans if s.name == "vc.generate"}
    if not roots:
        return None
    return sum(1 for s in spans if s.name == "host.sync" and s.request in roots) / len(roots)
