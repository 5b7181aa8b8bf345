"""The program under test (chatterbox_tpu_torch) built as a configuration
file states it. This is the one place that maps the benchmark's files onto
the program's constructors."""
from __future__ import annotations


def s3gen_engine(cfg: dict, tree: dict):
    """The program's S3GenEngine at the file's sizes, float32 throughout
    (the batched flow's bf16 switch as the file states it)."""
    from chatterbox_tpu_torch.models.s3gen.flow import FlowDims
    from chatterbox_tpu_torch.models.s3gen.model import S3GenEngine
    from chatterbox_tpu_torch.models.s3tok.model import S3TokenizerConfig
    s = cfg["s3gen"]
    return S3GenEngine(tree, dims=FlowDims(**s["flow"]), meanflow=s["meanflow"],
                       tok_cfg=S3TokenizerConfig(**s["tokenizer"]),
                       batched_bf16_min_b=s["batched_bf16_min_b"])
