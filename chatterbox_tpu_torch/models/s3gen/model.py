"""S3Gen: decoded speech tokens + reference voice -> waveform (the
counterpart of the fused decode->vocode handoff of
chatterbox_tpu/models/s3gen/model.py: `_pack_body`, the `_fused` body and
`inference_from_decode`).

token filter and pack -> upsample-conformer flow encoder -> UNet flow
(2-step meanflow for Turbo, 10-step cosine CFM with CFG for the 520M
family) -> HiFT with iSTFT -> trim-fade. One utterance runs at its exact
length, so there are no buckets; the one host read is the count of valid
tokens (with the largest of them, checked against the flow's vocabulary).
The output stays float32. Convolutions run with cuDNN's TF32 off, so the
float32 S3Gen is float32 on the card too.

The engine also embeds a reference voice (`embed_ref`: resample, 24 kHz
prompt mels, the CAMPPlus x-vector and the S3 tokens of the prompt) and
tokenizes 16 kHz audio (`tokenize`). These run at the exact length: the
JAX package pads CAMPPlus's input to 0.5 s buckets with a mask that makes
the result the unpadded one.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ...audio.mels import mel_spectrogram_24k
from ...audio.resample import resample
from ...nn import core as nn
from ..s3tok.model import S3_SR, S3TokenizerConfig, s3tokenizer_init, s3tokenizer_tokenize
from .campplus import campplus_embed_wav, campplus_init
from .flow import FlowDims, TOKEN_MEL_RATIO, flow_init, flow_inference
from .hift import SourceNoise, hift_inference, hift_init

S3GEN_SR = 24_000
SIL_TOKEN = 4299                     # silence speech token
SPEECH_VOCAB_SIZE = 6561
SOS, EOS = 6561, 6562                # T3's start / stop speech tokens


def s3gen_init(seed: int = 0, device="cuda", meanflow: bool = True,
               dims: FlowDims = FlowDims(), hift_base: int = 512,
               tok_cfg: S3TokenizerConfig = S3TokenizerConfig()) -> dict:
    """Random float32 parameters: `flow` and `mel2wav`, then the frontend's
    `tokenizer` (S3 tokenizer) and `speaker_encoder` (CAMPPlus)."""
    init = nn.Init(seed, device)
    return {"flow": flow_init(init, meanflow=meanflow, dims=dims),
            "mel2wav": hift_init(init, base_channels=hift_base),
            "tokenizer": s3tokenizer_init(init, tok_cfg),
            "speaker_encoder": campplus_init(init)}


class RefDict(NamedTuple):
    """The reference-voice conditioning bundle (numpy arrays)."""
    prompt_token: np.ndarray      # (1, P) int
    prompt_token_len: np.ndarray  # (1,)
    prompt_feat: np.ndarray       # (1, T_feat, 80)
    embedding: np.ndarray         # (1, 192)


class S3GenNoise(NamedTuple):
    """Every random number of one vocode call."""
    z: torch.Tensor               # (1, T_mel, 80) flow starting noise
    source: SourceNoise           # HiFT harmonic phases and noise


def trim_fade(sr: int = S3GEN_SR) -> np.ndarray:
    """20 ms of silence then a 20 ms raised-cosine fade-in."""
    n = sr // 50
    fade = np.zeros(2 * n, np.float32)
    fade[n:] = (np.cos(np.linspace(np.pi, 0, n)) + 1) / 2
    return fade


def pack_tokens(gen_tokens: torch.Tensor, n_raw, prompt_token: torch.Tensor,
                append_sil: int = 0, cfg_slice: bool = False, sos: int = SOS,
                eos: int = EOS, vocab: int = SPEECH_VOCAB_SIZE) -> torch.Tensor:
    """[prompt | valid generated tokens | append_sil silence tokens] as one
    (1, P + G) row. Generated tokens count when they are among the first
    n_raw and below `vocab` (the Turbo filter). cfg_slice (the 520M tail)
    first keeps only the tokens strictly between the first `sos` and the
    first `eos` among the first n_raw, and vocodes one silence token when
    nothing is left.

    A kept id at or above the flow's SPEECH_VOCAB_SIZE embedding rows (only
    possible with vocab > SPEECH_VOCAB_SIZE) raises ValueError; the JAX
    package's gather returns NaN embeddings there instead."""
    gen = gen_tokens.reshape(-1).long()
    idx = torch.arange(gen.shape[0], device=gen.device)
    keep = idx < n_raw
    if cfg_slice:
        is_sos, is_eos = (gen == sos) & keep, (gen == eos) & keep
        start = torch.where(is_sos.any(), is_sos.int().argmax() + 1, 0)
        end = torch.where(is_eos.any(), is_eos.int().argmax(),
                          torch.as_tensor(n_raw, device=gen.device))
        keep = (idx >= start) & (idx < end)
    keep = keep & (gen < vocab)
    # the one host read: the count of kept ids and the largest of them
    n, top = torch.stack([keep.sum(), torch.where(keep, gen, -1).max()]).tolist()
    if top >= SPEECH_VOCAB_SIZE:
        raise ValueError(f"speech token id {top} is kept (vocab={vocab}) but the "
                         f"flow embeds only {SPEECH_VOCAB_SIZE} ids")
    # kept ids first, in order (a stable sort), without another host read
    gen = gen[torch.sort((~keep).to(torch.int8), stable=True).indices[:n]]
    if cfg_slice and append_sil == 0 and n == 0:
        append_sil = 1
    sil = torch.full((append_sil,), SIL_TOKEN, dtype=torch.long, device=gen.device)
    return torch.cat([prompt_token.reshape(-1).long(), gen, sil])[None]


class S3GenEngine:
    """Owns the parameters of an S3Gen: meanflow (Turbo, 2 steps by default)
    or CFM with CFG (520M, 10 steps), and the frontend (`tokenizer`,
    `speaker_encoder`) that embed_ref and tokenize need."""

    def __init__(self, params: dict, dims: FlowDims = FlowDims(), meanflow: bool = True,
                 tok_cfg: S3TokenizerConfig = S3TokenizerConfig()):
        self.params = params
        self.dims = dims
        self.meanflow = meanflow
        self.tok_cfg = tok_cfg
        self.n_timesteps = 2 if meanflow else 10
        self.device = params["flow"]["input_embedding"]["w"].device
        self._fade = torch.from_numpy(trim_fade()).to(self.device)

    def draw_noise(self, n_mel: int, n_gen_mel: int, generator) -> S3GenNoise:
        """Random numbers for n_mel flow frames ([prompt | gen]) of which the
        last n_gen_mel are vocoded."""
        z = torch.randn((1, n_mel, 80), generator=generator, device=self.device)
        return S3GenNoise(z, SourceNoise.draw(1, n_gen_mel, generator, self.device))

    @torch.no_grad()
    def inference_from_decode(self, gen_tokens: torch.Tensor, n_tokens,
                              ref: RefDict, *, generator=None,
                              noise: Optional[S3GenNoise] = None,
                              n_timesteps: Optional[int] = None,
                              append_sil: int = 0, cfg_slice: bool = False,
                              sos: int = SOS, eos: int = EOS,
                              vocab: int = SPEECH_VOCAB_SIZE):
        """Vocode a T3 decode result. gen_tokens (L,) on the device, n_tokens
        the generated count (tensor or int); append_sil, cfg_slice, sos, eos
        and vocab pick the token tail (pack_tokens, which raises ValueError
        for a kept id the flow cannot embed). Returns (wav (1, T) float32
        numpy, n_gen vocoded tokens)."""
        P = int(np.asarray(ref.prompt_token_len).reshape(-1)[0])
        prompt = torch.as_tensor(np.asarray(ref.prompt_token)[:, :P], device=self.device)
        token = pack_tokens(gen_tokens.to(self.device), n_tokens, prompt, append_sil,
                            cfg_slice, sos, eos, vocab)
        n_gen = token.shape[1] - P
        if n_gen == 0:
            return np.zeros((1, 0), np.float32), 0
        n_mel = token.shape[1] * TOKEN_MEL_RATIO
        if noise is None:
            noise = self.draw_noise(n_mel, n_gen * TOKEN_MEL_RATIO, generator)
        feat = torch.as_tensor(np.asarray(ref.prompt_feat, np.float32), device=self.device)
        emb = torch.as_tensor(np.asarray(ref.embedding, np.float32), device=self.device)
        with nn.no_tf32_convs():
            mels = flow_inference(self.params["flow"], token, P, feat, emb, noise.z,
                                  n_timesteps=n_timesteps or self.n_timesteps,
                                  dims=self.dims, meanflow=self.meanflow)
            wav, _, _ = hift_inference(self.params["mel2wav"],
                                       mels[:, P * TOKEN_MEL_RATIO:], noise.source)
        n_fade = min(self._fade.shape[0], wav.shape[1])
        wav = torch.cat([wav[:, :n_fade] * self._fade[:n_fade], wav[:, n_fade:]], dim=1)
        return wav.float().cpu().numpy(), n_gen

    @torch.no_grad()
    def embed_ref(self, ref_wav: np.ndarray, ref_sr: int) -> RefDict:
        """A reference voice -> RefDict: its S3 tokens, 24 kHz prompt mels
        (two frames a token) and CAMPPlus x-vector."""
        ref_wav = np.asarray(ref_wav, np.float32).reshape(-1)
        if len(ref_wav) > 10 * ref_sr:
            print("WARNING: s3gen received ref longer than 10s")
        wav = torch.from_numpy(ref_wav).to(self.device)
        with nn.no_tf32_convs():
            wav24 = resample(wav, ref_sr, S3GEN_SR)
            wav16 = resample(wav, ref_sr, S3_SR)
            embedding = campplus_embed_wav(self.params["speaker_encoder"], wav16[None])
            # a whole number of 40 ms tokens; the zero tail of under 40 ms
            # stands in for the reference's mel == 2 * token repair
            n_tok = int(np.ceil(wav16.shape[0] / (S3_SR / 25)))
            wav16p = torch.nn.functional.pad(wav16, (0, int(n_tok * S3_SR / 25) - wav16.shape[0]))
            n24 = n_tok * (S3GEN_SR // 25)
            wav24p = torch.nn.functional.pad(wav24, (0, max(0, n24 - wav24.shape[0])))[:n24]
            ref_mels = mel_spectrogram_24k(wav24p[None]).transpose(1, 2)
            tokens, token_len = s3tokenizer_tokenize(
                self.params["tokenizer"], self.tok_cfg, wav16p[None],
                torch.tensor([wav16p.shape[0]], device=self.device))
        tokens = tokens.cpu().numpy().astype(np.int32)
        token_len = token_len.cpu().numpy().astype(np.int32)
        ref_mels = ref_mels.cpu().numpy()
        # mel_len == 2 * token_len
        if ref_mels.shape[1] != 2 * tokens.shape[1]:
            n_keep = ref_mels.shape[1] // 2
            tokens = tokens[:, :n_keep]
            token_len = np.minimum(token_len, n_keep)
        return RefDict(prompt_token=tokens, prompt_token_len=token_len,
                       prompt_feat=ref_mels, embedding=embedding.cpu().numpy())

    @torch.no_grad()
    def tokenize(self, wav_16k: np.ndarray, max_len: Optional[int] = None):
        """16 kHz audio -> (tokens (1, n) int32, token_len (1,) int32 numpy),
        at most max_len tokens."""
        wav = torch.from_numpy(np.asarray(wav_16k, np.float32).reshape(-1)).to(self.device)
        n_tok = int(np.ceil(wav.shape[0] / (S3_SR / 25)))
        wav = torch.nn.functional.pad(wav, (0, int(n_tok * S3_SR / 25) - wav.shape[0]))
        with nn.no_tf32_convs():
            tokens, token_len = s3tokenizer_tokenize(
                self.params["tokenizer"], self.tok_cfg, wav[None],
                torch.tensor([wav.shape[0]], device=self.device), max_len)
        token_len = token_len.cpu().numpy().astype(np.int32)
        return tokens.cpu().numpy().astype(np.int32)[:, :int(token_len[0])], token_len
