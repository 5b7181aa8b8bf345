"""Flow front of S3Gen: speech tokens -> conformer encoder (mu) -> meanflow
or CFG flow matching -> mel (the counterpart of
chatterbox_tpu/models/s3gen/flow.py). Runs in float32: `flow_inference`
one utterance at its exact length, `flow_inference_batch` rows of different
prompt and generated lengths in one masked call (the batched vocode), each
row's valid frames its exact-length result up to rounding."""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ...nn import core as nn
from .encoder import upsample_encoder_init, upsample_encoder_apply
from .unet import unet_init
from .cfm import solve_euler_cfg, solve_euler_meanflow

VOCAB_SIZE = 6561
OUTPUT_SIZE = 80
SPK_EMBED_DIM = 192
TOKEN_MEL_RATIO = 2


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
