"""Frozen reference copy of chatterbox_tpu_torch/models/s3gen/campplus.py at commit f7b8e4d,
plain PyTorch / numpy, importing nothing of the program under test.

CAMPPlus speaker x-vector (the counterpart of
chatterbox_tpu/models/s3gen/campplus.py): kaldi fbank-80 with the
utterance mean removed -> FCM 2-D resnet stem -> a TDNN, then three dense
CAM-TDNN blocks (12 / 24 / 16 layers, growth 32, dilations 1 / 2 / 2) with
transit layers -> mean and std pooling -> a 192-d embedding. Batch norms
run in inference mode.

Inside, the layout is torch's channels-first: (B, 1, F, T) through the 2-D
stem, (B, C, T) after it. Parameters keep the JAX package's keys; the conv
weights are torch's (Cout, Cin, K) and (Cout, Cin, KH, KW).

The masked variant takes each row's valid sample count: positions past it
are zero before every time-mixing conv and every pooled statistic divides
by the valid length, so a zero-padded row gives its unpadded result.
"""
from __future__ import annotations

from typing import Optional

import torch

from .mels import kaldi_fbank_80
from . import nn

BLOCK_SPECS = ((12, 3, 1), (24, 3, 2), (16, 3, 2))  # (layers, kernel, dilation)
GROWTH = 32
BN_SIZE = 4
INIT_CHANNELS = 128
_C = 1                   # the channel axis, channels-first


def _bn(p, x, affine=True):
    return nn.batch_norm(p, x, affine=affine, dim=_C)


def _m(h: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    return h if mask is None else h * mask


# ---------------------------------------------------------------------------
# FCM stem (2-D convs over (freq, time))
# ---------------------------------------------------------------------------

def _res2d_init(init: nn.Init, c_in: int, c_out: int, stride: int) -> dict:
    p = {"conv1": init.conv2d(c_in, c_out, 3, bias=False), "bn1": init.batch_norm(c_out),
         "conv2": init.conv2d(c_out, c_out, 3, bias=False), "bn2": init.batch_norm(c_out)}
    if stride != 1 or c_in != c_out:
        p["shortcut_conv"] = init.conv2d(c_in, c_out, 1, bias=False)
        p["shortcut_bn"] = init.batch_norm(c_out)
    return p


def _res2d_apply(p: dict, x: torch.Tensor, stride: int, mask) -> torch.Tensor:
    """mask (B, 1, 1, T), applied again after each norm (whose shift makes
    padded positions nonzero) so the 3x3 convs never read them."""
    h = torch.relu(_bn(p["bn1"], nn.conv2d_cf(p["conv1"], x, (stride, 1), (1, 1))))
    h = _bn(p["bn2"], nn.conv2d_cf(p["conv2"], _m(h, mask), padding=(1, 1)))
    sc = x
    if "shortcut_conv" in p:
        sc = _bn(p["shortcut_bn"], nn.conv2d_cf(p["shortcut_conv"], x, (stride, 1)))
    return _m(torch.relu(h + sc), mask)


def fcm_init(init: nn.Init, m: int = 32) -> dict:
    return {"conv1": init.conv2d(1, m, 3, bias=False), "bn1": init.batch_norm(m),
            "layer1": [_res2d_init(init, m, m, 2), _res2d_init(init, m, m, 1)],
            "layer2": [_res2d_init(init, m, m, 2), _res2d_init(init, m, m, 1)],
            "conv2": init.conv2d(m, m, 3, bias=False), "bn2": init.batch_norm(m)}


def fcm_apply(p: dict, x: torch.Tensor, mask=None) -> torch.Tensor:
    """x (B, T, 80) fbank -> (B, 320, T); mask (B, 1, T) or None."""
    m4 = None if mask is None else mask[:, None]                  # (B, 1, 1, T)
    h = x.transpose(1, 2)[:, None]                                # (B, 1, 80, T)
    h = _m(torch.relu(_bn(p["bn1"], nn.conv2d_cf(p["conv1"], h, padding=(1, 1)))), m4)
    for layer in (p["layer1"], p["layer2"]):
        for i, blk in enumerate(layer):
            h = _res2d_apply(blk, h, 2 if i == 0 else 1, m4)
    h = _m(torch.relu(_bn(p["bn2"], nn.conv2d_cf(p["conv2"], h, (2, 1), (1, 1)))), m4)
    B, C, F, T = h.shape
    return h.reshape(B, C * F, T)                                 # channel c * F + f


# ---------------------------------------------------------------------------
# TDNN and CAM layers
# ---------------------------------------------------------------------------

def tdnn_init(init: nn.Init, c_in: int, c_out: int, k: int) -> dict:
    return {"conv": init.conv1d(c_in, c_out, k, bias=False), "bn": init.batch_norm(c_out)}


def tdnn_apply(p: dict, x, k: int, stride: int = 1, dilation: int = 1, mask=None):
    h = nn.conv1d_cf(p["conv"], x, stride=stride, padding=(k - 1) // 2 * dilation,
                     dilation=dilation)
    return _m(torch.relu(_bn(p["bn"], h)), mask)


def cam_layer_init(init: nn.Init, bn_ch: int, out_ch: int, k: int) -> dict:
    return {"local": init.conv1d(bn_ch, out_ch, k, bias=False),
            "lin1": init.conv1d(bn_ch, bn_ch // 2, 1),
            "lin2": init.conv1d(bn_ch // 2, out_ch, 1)}


def _seg_pool(x: torch.Tensor, seg_len: int = 100, t_valid=None) -> torch.Tensor:
    """Mean over fixed 100-frame segments, repeated back over each segment
    (avg_pool1d with ceil_mode); with t_valid (B,), each segment divides by
    its count of valid frames (at least 1)."""
    B, C, T = x.shape
    n_seg = -(-T // seg_len)
    xp = torch.nn.functional.pad(x, (0, n_seg * seg_len - T))
    starts = torch.arange(n_seg, device=x.device) * seg_len
    if t_valid is None:
        counts = torch.clamp(T - starts, 0, seg_len)[None, None]
    else:
        counts = torch.clamp(t_valid[:, None] - starts[None], 1, seg_len)[:, None]
    seg = xp.reshape(B, C, n_seg, seg_len).sum(-1) / counts
    return seg.repeat_interleave(seg_len, dim=-1)[..., :T]


def cam_layer_apply(p: dict, x, k: int, dilation: int, mask=None, t_valid=None):
    y = nn.conv1d_cf(p["local"], x, padding=(k - 1) // 2 * dilation, dilation=dilation)
    if t_valid is None:
        gmean = x.mean(-1, keepdim=True)
    else:
        gmean = x.sum(-1, keepdim=True) / t_valid[:, None, None]
    context = gmean + _seg_pool(x, t_valid=t_valid)
    m = torch.sigmoid(nn.conv1d_cf(p["lin2"], torch.relu(nn.conv1d_cf(p["lin1"], context))))
    return _m(y * m, mask)


def cam_dense_layer_init(init: nn.Init, c_in: int, out_ch: int, bn_ch: int, k: int) -> dict:
    return {"bn1": init.batch_norm(c_in), "lin1": init.conv1d(c_in, bn_ch, 1, bias=False),
            "bn2": init.batch_norm(bn_ch), "cam": cam_layer_init(init, bn_ch, out_ch, k)}


def cam_dense_layer_apply(p: dict, x, k: int, dilation: int, mask=None, t_valid=None):
    h = nn.conv1d_cf(p["lin1"], torch.relu(_bn(p["bn1"], x)))
    h = _m(torch.relu(_bn(p["bn2"], h)), mask)
    return cam_layer_apply(p["cam"], h, k, dilation, mask, t_valid)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def campplus_init(init: nn.Init, embedding_size: int = 192) -> dict:
    p = {"fcm": fcm_init(init), "tdnn": tdnn_init(init, 320, INIT_CHANNELS, 5),
         "blocks": [], "transits": []}
    ch = INIT_CHANNELS
    for num_layers, k, _ in BLOCK_SPECS:
        p["blocks"].append([cam_dense_layer_init(init, ch + i * GROWTH, GROWTH,
                                                 BN_SIZE * GROWTH, k)
                            for i in range(num_layers)])
        ch += num_layers * GROWTH
        p["transits"].append({"bn": init.batch_norm(ch),
                              "conv": init.conv1d(ch, ch // 2, 1, bias=False)})
        ch //= 2
    p["out_bn"] = init.batch_norm(ch)
    p["dense"] = {"conv": init.conv1d(ch * 2, embedding_size, 1, bias=False),
                  "bn": init.batch_norm(embedding_size)}
    return p


def _time_mask(t_valid: torch.Tensor, T: int, dtype) -> torch.Tensor:
    return (torch.arange(T, device=t_valid.device)[None] < t_valid[:, None]).to(dtype)[:, None]


def campplus_apply(params: dict, fbank: torch.Tensor,
                   t_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """fbank (B, T, 80), mean-normalized -> (B, 192) x-vector; t_valid
    (B,) the valid frame counts of zero-padded rows, or None."""
    mask = None
    if t_valid is not None:
        mask = _time_mask(t_valid, fbank.shape[1], fbank.dtype)  # (B, 1, T)
        fbank = fbank * mask.transpose(1, 2)
    h = fcm_apply(params["fcm"], fbank, mask)
    if t_valid is not None:
        # the k=5, stride-2 TDNN halves time: ceil(T / 2) valid frames
        t_valid = (t_valid + 1) // 2
        mask = _time_mask(t_valid, -(-h.shape[-1] // 2), h.dtype)
    h = tdnn_apply(params["tdnn"], h, k=5, stride=2, mask=mask)
    for (_, k, dil), layers, transit in zip(BLOCK_SPECS, params["blocks"],
                                            params["transits"]):
        for lp in layers:
            h = torch.cat([h, cam_dense_layer_apply(lp, h, k, dil, mask, t_valid)], dim=_C)
        h = _m(nn.conv1d_cf(transit["conv"], torch.relu(_bn(transit["bn"], h))), mask)
    h = _m(torch.relu(_bn(params["out_bn"], h)), mask)
    # statistics pooling: mean and unbiased std over time
    if t_valid is None:
        mean, var = h.mean(-1), h.var(-1, unbiased=True)
    else:
        tv = t_valid[:, None].to(h.dtype)
        mean = h.sum(-1) / tv
        var = (torch.square(h - mean[..., None]) * mask).sum(-1) / (tv - 1)
    stats = torch.cat([mean, torch.sqrt(var)], dim=-1)[..., None]    # (B, 2C, 1)
    e = nn.conv1d_cf(params["dense"]["conv"], stats)[..., 0]
    return nn.batch_norm(params["dense"]["bn"], e, affine=False)


def campplus_embed_wav(params: dict, wav_16k: torch.Tensor,
                       n_samples: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, T) 16 kHz waveform -> (B, 192) x-vector, the fbank frontend and
    its per-utterance mean included. n_samples (B,): the valid sample counts
    of rows padded with zeros (the result is then each row's unpadded one)."""
    fb = kaldi_fbank_80(wav_16k)
    if n_samples is None:
        return campplus_apply(params, fb - fb.mean(dim=1, keepdim=True))
    # snip_edges: the frames wholly inside the valid samples
    t_valid = torch.clamp((n_samples - 400) // 160 + 1, min=1)
    fmask = _time_mask(t_valid, fb.shape[1], fb.dtype).transpose(1, 2)   # (B, T, 1)
    fmean = (fb * fmask).sum(dim=1, keepdim=True) / t_valid[:, None, None]
    return campplus_apply(params, (fb - fmean) * fmask, t_valid)
