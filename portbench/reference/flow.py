"""Frozen reference copy of chatterbox_tpu_torch/models/s3gen/flow.py at commit f7b8e4d,
plain PyTorch / numpy, importing nothing of the program under test.

Flow front of S3Gen: speech tokens -> conformer encoder (mu) -> meanflow
or CFG flow matching -> mel (the counterpart of
chatterbox_tpu/models/s3gen/flow.py). Runs in float32: `flow_inference`
one utterance at its exact length, `flow_inference_batch` rows of different
prompt and generated lengths in one masked call (the batched vocode), each
row's valid frames its exact-length result up to rounding."""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch
import torch.utils.checkpoint

from . import nn
from .encoder import upsample_encoder_init, upsample_encoder_apply
from .unet import unet_init, unet_apply
from .cfm import solve_euler_cfg, solve_euler_meanflow

VOCAB_SIZE = 6561
OUTPUT_SIZE = 80
SPK_EMBED_DIM = 192
TOKEN_MEL_RATIO = 2
SIGMA_MIN = 1e-6             # the OT-CFM path's noise floor
TRAINING_CFG_RATE = 0.2      # classifier-free dropout while training


@dataclass(frozen=True)
class FlowDims:
    """Architecture sizes (defaults: the reference S3Gen)."""
    enc_dim: int = 512
    enc_heads: int = 8
    enc_ff: int = 2048
    enc_blocks: int = 6
    enc_up_blocks: int = 4
    unet_channels: int = 256
    unet_blocks: int = 4
    unet_mid: int = 12
    unet_heads: int = 8
    unet_head_dim: int = 64

    @classmethod
    def tiny_test(cls):
        return cls(enc_dim=32, enc_heads=2, enc_ff=64, enc_blocks=1,
                   enc_up_blocks=1, unet_channels=16, unet_blocks=1,
                   unet_mid=1, unet_heads=2, unet_head_dim=8)


def flow_init(init: nn.Init, meanflow: bool = True, dims: FlowDims = FlowDims()) -> dict:
    return {
        "input_embedding": init.embedding(VOCAB_SIZE, dims.enc_dim),
        "spk_embed_affine": init.linear(SPK_EMBED_DIM, OUTPUT_SIZE),
        "encoder": upsample_encoder_init(init, d=dims.enc_dim, n_heads=dims.enc_heads,
                                         ff=dims.enc_ff, n_blocks=dims.enc_blocks,
                                         n_up_blocks=dims.enc_up_blocks),
        "encoder_proj": init.linear(dims.enc_dim, OUTPUT_SIZE),
        "decoder": unet_init(init, channels=dims.unet_channels,
                             n_blocks=dims.unet_blocks, num_mid_blocks=dims.unet_mid,
                             n_heads=dims.unet_heads, head_dim=dims.unet_head_dim,
                             meanflow=meanflow),
    }


def flow_inference(params: dict, token: torch.Tensor, prompt_len: int,
                   prompt_feat: torch.Tensor, embedding: torch.Tensor,
                   z: torch.Tensor, n_timesteps: int = 2,
                   dims: FlowDims = FlowDims(), meanflow: bool = True) -> torch.Tensor:
    """token (B, T) [prompt | gen] ids; prompt_feat (B, T_feat, 80) prompt
    mels; embedding (B, 192) x-vector; z (B, 2T, 80) starting noise over the
    whole [prompt | gen] mel buffer. meanflow picks the 2-step meanflow
    solver (Turbo) or the cosine CFG solver (520M, 10 steps).
    Returns mels (B, 2T, 80); the generated region starts at 2*prompt_len."""
    emb = embedding / torch.linalg.norm(embedding, dim=-1, keepdim=True)
    spks = nn.linear(params["spk_embed_affine"], emb)
    x = nn.embedding(params["input_embedding"], token)
    h = upsample_encoder_apply(params["encoder"], x, d=dims.enc_dim,
                               n_heads=dims.enc_heads)
    mu = nn.linear(params["encoder_proj"], h)                  # (B, 2T, 80)
    T_mel = mu.shape[1]
    # conditioning: the prompt mels, then zeros
    n_prompt = min(prompt_len * TOKEN_MEL_RATIO, T_mel, prompt_feat.shape[1])
    conds = torch.zeros_like(mu)
    conds[:, :n_prompt] = prompt_feat[:, :n_prompt]
    solve = solve_euler_meanflow if meanflow else solve_euler_cfg
    return solve(params["decoder"], z, mu, spks, conds, n_timesteps=n_timesteps,
                 n_heads=dims.unet_heads)


def flow_inference_batch(params: dict, token: torch.Tensor, token_len: torch.Tensor,
                         prompt_len: torch.Tensor, prompt_feat: torch.Tensor,
                         embedding: torch.Tensor, z: torch.Tensor, n_timesteps: int = 2,
                         dims: FlowDims = FlowDims(), meanflow: bool = True) -> torch.Tensor:
    """The masked counterpart of flow_inference (JAX `flow_inference` with
    per-row lengths). token (B, T) rows [prompt_b | gen_b | pad]; token_len
    (B,) long P_b + G_b and prompt_len (B,) long P_b, on the device;
    prompt_feat (B, T_feat, 80) each voice's prompt mels, zero-padded;
    embedding (B, 192); z (B, 2T, 80) each row's starting noise over its
    [prompt | gen] frames. The encoder and the estimator run in their
    parameters' type (the batched vocode may cast both to bfloat16); mu
    and the Euler state stay float32. Returns mels (B, 2T, 80); row b's
    generated region is [2 P_b, 2 (P_b + G_b))."""
    B, T = token.shape
    dev = token.device
    emb = embedding / torch.linalg.norm(embedding, dim=-1, keepdim=True)
    spks = nn.linear(params["spk_embed_affine"], emb)
    mask_tok = torch.arange(T, device=dev)[None] < token_len[:, None]
    x = nn.embedding(params["input_embedding"], token) * mask_tok[..., None]
    enc_dt = params["encoder"]["after_norm"]["g"].dtype
    h = upsample_encoder_apply(params["encoder"], x.to(enc_dt), d=dims.enc_dim,
                               n_heads=dims.enc_heads, lens=token_len)
    mu = nn.linear(params["encoder_proj"], h.float())              # (B, 2T, 80)
    T_mel = mu.shape[1]
    frames = torch.arange(T_mel, device=dev)[None]
    mask_mel = frames < TOKEN_MEL_RATIO * token_len[:, None]
    pf = prompt_feat[:, :T_mel]
    if pf.shape[1] < T_mel:
        pf = torch.nn.functional.pad(pf, (0, 0, 0, T_mel - pf.shape[1]))
    # conditioning: each row's prompt mels, then zeros
    conds = torch.where((frames < TOKEN_MEL_RATIO * prompt_len[:, None])[..., None], pf, 0.0)
    solve = solve_euler_meanflow if meanflow else solve_euler_cfg
    return solve(params["decoder"], z, mu, spks, conds, n_timesteps=n_timesteps,
                 n_heads=dims.unet_heads, mask=mask_mel)


# ---------------------------------------------------------------------------
# training: the masked conditional-flow-matching loss
# ---------------------------------------------------------------------------

def cfm_interpolate(x1: torch.Tensor, z: torch.Tensor, t: torch.Tensor,
                    sigma_min: float = SIGMA_MIN):
    """The OT-CFM path point and its regression target for target x1,
    noise z (B, T, C) and per-row t (B,): x_t = (1 - (1 - sigma) t) z + t x1
    and u = x1 - (1 - sigma) z."""
    t_ = t[:, None, None]
    y = (1.0 - (1.0 - sigma_min) * t_) * z + t_ * x1
    u = x1 - (1.0 - sigma_min) * z
    return y, u


class FlowDraws(NamedTuple):
    """The random numbers of one flow loss call, in the order they are
    drawn: uniforms keep_u (B,) (a row keeps a conditioning prefix where
    >= 0.5), frac (B,) (its length, a fraction of 0.3 of the row's
    frames), t_u (B,) (the flow time before its cosine warp), standard
    normal z (B, T_mel, 80), and uniforms cfg_u (B,) (a row keeps mu, the
    speaker and the prefix where > the dropout rate)."""
    keep_u: torch.Tensor
    frac: torch.Tensor
    t_u: torch.Tensor
    z: torch.Tensor
    cfg_u: torch.Tensor


def draw_flow_noise(generator: torch.Generator, batch: int, t_mel: int) -> FlowDraws:
    """FlowDraws for a batch of `batch` rows of t_mel frames, from
    `generator` on its own device."""
    dev = generator.device
    u = lambda: torch.rand(batch, generator=generator, device=dev)
    keep_u, frac, t_u = u(), u(), u()
    z = torch.randn((batch, t_mel, OUTPUT_SIZE), generator=generator, device=dev)
    return FlowDraws(keep_u, frac, t_u, z, u())


def flow_loss_terms(params: dict, generator: Optional[torch.Generator], *,
                    token: torch.Tensor, token_len: torch.Tensor,
                    feat: torch.Tensor, feat_len: torch.Tensor,
                    embedding: torch.Tensor, dims: FlowDims = FlowDims(),
                    sigma_min: float = SIGMA_MIN,
                    training_cfg_rate: float = TRAINING_CFG_RATE,
                    remat: bool = False,
                    draws: Optional[FlowDraws] = None):
    """`flow_compute_loss` before its division: (the summed squared error
    over the valid frames, their count times 80). Every row's terms are its
    own, so a data-parallel step sums each over the processes' rows."""
    B, T_tok = token.shape
    dev = token.device
    emb = embedding / torch.linalg.norm(embedding, dim=-1, keepdim=True)
    spks = nn.linear(params["spk_embed_affine"], emb)
    mask_tok = torch.arange(T_tok, device=dev)[None] < token_len[:, None]
    x = nn.embedding(params["input_embedding"], token.clamp(min=0)) * mask_tok[..., None]

    def encode(p, x, lens):
        return upsample_encoder_apply(p, x, d=dims.enc_dim, n_heads=dims.enc_heads, lens=lens)

    def estimate(p, y, mask, mu, t, spks, conds):
        return unet_apply(p, y, mu, t, spks, conds, n_heads=dims.unet_heads, mask=mask)

    def run(fn, *args):
        if remat:
            return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    h = run(encode, params["encoder"], x, token_len)
    mu = nn.linear(params["encoder_proj"], h)                  # (B, 2 T_tok, 80)

    T_mel = mu.shape[1]
    x1 = feat[:, :T_mel]
    if x1.shape[1] < T_mel:
        x1 = torch.nn.functional.pad(x1, (0, 0, 0, T_mel - x1.shape[1]))
    frames = torch.arange(T_mel, device=dev)[None]
    mask = (frames < TOKEN_MEL_RATIO * token_len[:, None]).to(mu.dtype)   # (B, T_mel)
    x1 = x1 * mask[..., None]

    if draws is None:
        draws = draw_flow_noise(generator, B, T_mel)
    keep_u, frac, t_u, z, cfg_u = (d.to(dev) for d in draws)
    prefix = torch.floor(frac * 0.3 * feat_len).to(torch.int32)
    prefix = torch.where(keep_u >= 0.5, prefix, 0)
    conds = torch.where(frames[..., None] < prefix[:, None, None], x1, 0.0)

    t = 1.0 - torch.cos(t_u * 0.5 * math.pi)
    y, u = cfm_interpolate(x1, z, t, sigma_min)
    if training_cfg_rate > 0:
        cfg_keep = (cfg_u > training_cfg_rate).to(mu.dtype)
        mu = mu * cfg_keep[:, None, None]
        spks = spks * cfg_keep[:, None]
        conds = conds * cfg_keep[:, None, None]

    pred = run(estimate, params["decoder"], y, mask, mu, t, spks, conds)
    m = mask[..., None]
    return (((pred - u) * m) ** 2).sum(), mask.sum() * u.shape[-1]


def flow_compute_loss(params: dict, generator: Optional[torch.Generator], *,
                      token: torch.Tensor, token_len: torch.Tensor,
                      feat: torch.Tensor, feat_len: torch.Tensor,
                      embedding: torch.Tensor, dims: FlowDims = FlowDims(),
                      sigma_min: float = SIGMA_MIN,
                      training_cfg_rate: float = TRAINING_CFG_RATE,
                      remat: bool = False,
                      draws: Optional[FlowDraws] = None) -> torch.Tensor:
    """The masked conditional-flow-matching loss of the flow (float32
    scalar). token (B, T_tok) ids, token_len (B,) valid tokens, feat
    (B, T_mel, 80) target mels (channels-last), feat_len (B,) valid mel
    frames, embedding (B, 192) x-vectors:
      * the encoder front as at inference (token embedding, masked upsample
        conformer, 80-d projection = mu);
      * a conditioning prefix per row: with probability 1/2 the first
        floor(U[0, 1) 0.3 feat_len) target frames, else none;
      * t ~ U(0, 1) warped to 1 - cos(t pi / 2), x_t and u by
        `cfm_interpolate`;
      * classifier-free dropout: each row's mu, speaker and prefix zeroed
        with probability training_cfg_rate;
      * the squared error of the estimator's velocity over each row's
        valid frames, divided by their count times 80.
    The random numbers come from `generator` (`draw_flow_noise`) unless
    `draws` gives them. remat recomputes the encoder call and the estimator
    call in the backward pass."""
    num, count = flow_loss_terms(params, generator, token=token, token_len=token_len,
                                 feat=feat, feat_len=feat_len, embedding=embedding,
                                 dims=dims, sigma_min=sigma_min,
                                 training_cfg_rate=training_cfg_rate, remat=remat,
                                 draws=draws)
    return (num / (count + 1e-8)).float()
