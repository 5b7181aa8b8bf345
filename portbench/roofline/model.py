"""Operations from the configuration's shapes, and the card's peaks
(portbench/roofline/peaks.json).

S3Gen and the S3 tokenizer are counted by running the plain reference on
the meta device under torch's FLOP counter at a request's exact lengths
(matrix products and convolutions; elementwise work is not counted), then
fitting the exact polynomial in the length that those shapes give.
"""
from __future__ import annotations

import functools
import json
from pathlib import Path

import numpy as np

PEAKS = json.loads((Path(__file__).resolve().parent / "peaks.json").read_text())


def peak_flops(products: str) -> float:
    return PEAKS["flops"][products]


# ---------------------------------------------------------------------------
# S3Gen, counted on the plain reference
# ---------------------------------------------------------------------------

def _counted(fn) -> float:
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as fc:
        fn()
    return float(fc.get_total_flops())


def _flow_flops(cfg_json: str, T: int) -> float:
    import torch
    from ..reference import flow as F
    from ..reference import s3gen as S
    from ..reference.nn import Init
    cfg = json.loads(cfg_json)
    p = S.s3gen_init(Init(0, "meta"), cfg, parts=("flow",))["flow"]
    m = lambda *s: torch.empty(s, device="meta")
    P = T // 4
    return _counted(lambda: F.flow_inference(
        p, torch.zeros((1, T), dtype=torch.long, device="meta"), P, m(1, 2 * P, 80),
        m(1, 192), m(1, 2 * T, 80), n_timesteps=cfg["s3gen"]["flow_steps"],
        dims=S.dims_of(cfg), meanflow=cfg["s3gen"]["meanflow"]))


def _hift_flops(cfg_json: str, G: int) -> float:
    import torch
    from ..reference import hift as H
    from ..reference import s3gen as S
    from ..reference.nn import Init
    cfg = json.loads(cfg_json)
    p = S.s3gen_init(Init(0, "meta"), cfg, parts=("mel2wav",))["mel2wav"]
    m = lambda *s: torch.empty(s, device="meta")
    src = H.SourceNoise(m(1, 1, H.NB_HARMONICS + 1),
                        m(1, 2 * G * H.TOTAL_UPSAMPLE, H.NB_HARMONICS + 1))
    return _counted(lambda: H.hift_inference(p, m(1, 2 * G, 80), src))


def _tokenizer_flops(cfg_json: str, n_tokens: int) -> float:
    import torch
    from ..reference import s3gen as S
    from ..reference import s3tok
    from ..reference.nn import Init
    cfg = json.loads(cfg_json)
    p = S.s3gen_init(Init(0, "meta"), cfg, parts=("tokenizer",))["tokenizer"]
    mel = torch.empty((1, 4 * n_tokens, cfg["s3gen"]["tokenizer"]["n_mels"]), device="meta")
    return _counted(lambda: s3tok.s3tokenizer_encode_mel(
        p, S.tok_cfg_of(cfg), mel, torch.tensor([4 * n_tokens], device="meta")))


@functools.lru_cache(maxsize=16)
def _fit(kind: str, cfg_json: str):
    """Coefficients of the exact polynomial (quadratic in the length for
    what attends, linear for HiFT) through counted points. The flow's work
    depends on the length of [prompt | gen] alone."""
    if kind == "flow":
        xs = (128, 512, 1024)
        return np.polyfit(xs, [_flow_flops(cfg_json, T) for T in xs], 2)
    if kind == "hift":
        xs = (64, 512)
        return np.polyfit(xs, [_hift_flops(cfg_json, g) for g in xs], 1)
    xs = (64, 256, 512)
    return np.polyfit(xs, [_tokenizer_flops(cfg_json, n) for n in xs], 2)


def s3gen_vocode_flops(cfg: dict, P: int, G: int) -> float:
    """The flow over [prompt | gen] (every solver step, CFG's two rows
    included) and HiFT over the generated region."""
    key = json.dumps(cfg, sort_keys=True)
    return float(np.polyval(_fit("flow", key), P + G) + np.polyval(_fit("hift", key), G))


def s3_tokenizer_flops(cfg: dict, n_tokens: int) -> float:
    """The S3 tokenizer's encoder over n_tokens (4 mel frames a token)."""
    return float(np.polyval(_fit("tok", json.dumps(cfg, sort_keys=True)), n_tokens))
