"""mfu_pct (device trace and program counters, the whole step): the model's
operations done in the traced slice, each part over the peak of the
precision its products run in (the configuration's `products`), over the
slice's seconds: S3Gen's vocodes (the flow over every solver step and
HiFT) and the S3 tokenizer's encoder, as the entry recorded them with
their lengths. Operations come from the configuration's shapes
(roofline/model.py); CAMPPlus's are not counted."""
from portbench.roofline import model


def read(run):
    s, c = run.summary, run.slice_counters
    if s is None or "t0" not in c:
        return None
    cfg = run.config
    t0, t1 = c["t0"], c["t1"]
    flops = sum(model.s3gen_vocode_flops(cfg, p, g)
                for t, ps, gs in run.counters.get("vocodes", ()) if t0 <= t <= t1
                for p, g in zip(ps, gs))
    flops += sum(model.s3_tokenizer_flops(cfg, n)
                 for t, n in run.counters.get("tokenized", ()) if t0 <= t <= t1)
    busy_peak_s = flops / model.peak_flops(cfg["s3gen"]["products"])
    if busy_peak_s <= 0:
        return None
    return 100.0 * busy_peak_s / s.window_s
