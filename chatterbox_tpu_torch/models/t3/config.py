"""T3 model configuration (the port's own copy of chatterbox_tpu's frozen
dataclasses; the numbers are the reference model zoo's)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class BackboneConfig:
    family: str                 # "llama" | "gpt2"
    hidden_size: int
    num_layers: int
    num_heads: int
    head_dim: int
    intermediate_size: int
    # llama-only
    num_kv_heads: int = 0
    rms_norm_eps: float = 1e-5
    rope_theta: float = 500000.0
    rope_scaling_factor: float = 8.0
    rope_low_freq_factor: float = 1.0
    rope_high_freq_factor: float = 4.0
    rope_original_max_pos: int = 8192
    # gpt2-only
    layer_norm_eps: float = 1e-5
    max_positions: int = 8196
    vocab_size: int = 0

    @property
    def is_gpt(self) -> bool:
        return self.family == "gpt2"


LLAMA_520M = BackboneConfig(
    family="llama", hidden_size=1024, num_layers=30, num_heads=16,
    head_dim=64, intermediate_size=4096, num_kv_heads=16,
)

GPT2_MEDIUM = BackboneConfig(
    family="gpt2", hidden_size=1024, num_layers=24, num_heads=16,
    head_dim=64, intermediate_size=4096, vocab_size=50276,
)

GPT2_SMALL = BackboneConfig(
    family="gpt2", hidden_size=768, num_layers=12, num_heads=12,
    head_dim=64, intermediate_size=3072, vocab_size=50276,
)

GPT2_TINY_TEST = BackboneConfig(
    family="gpt2", hidden_size=64, num_layers=2, num_heads=4,
    head_dim=16, intermediate_size=256, vocab_size=96,
)

LLAMA_TINY_TEST = BackboneConfig(
    family="llama", hidden_size=64, num_layers=2, num_heads=4,
    head_dim=16, intermediate_size=256, num_kv_heads=4,
)

# smallest shapes the fused int8 decode-layer kernels take (D % 512 == 0;
# GPT-2 I % 1024 == 0, llama I % 512 == 0): CPU parity tests
GPT2_FUSED_TEST = BackboneConfig(
    family="gpt2", hidden_size=512, num_layers=2, num_heads=8,
    head_dim=64, intermediate_size=2048, vocab_size=96,
)

LLAMA_FUSED_TEST = BackboneConfig(
    family="llama", hidden_size=512, num_layers=2, num_heads=8,
    head_dim=64, intermediate_size=1024, num_kv_heads=8,
)

BACKBONES = {
    "Llama_520M": LLAMA_520M,
    "GPT2_medium": GPT2_MEDIUM,
    "GPT2_small": GPT2_SMALL,
    "GPT2_tiny_test": GPT2_TINY_TEST,
    "Llama_tiny_test": LLAMA_TINY_TEST,
    "GPT2_fused_test": GPT2_FUSED_TEST,
    "Llama_fused_test": LLAMA_FUSED_TEST,
}


@dataclass(frozen=True)
class T3Config:
    start_text_token: int = 255
    stop_text_token: int = 0
    text_tokens_dict_size: int = 704
    max_text_tokens: int = 2048
    start_speech_token: int = 6561
    stop_speech_token: int = 6562
    speech_tokens_dict_size: int = 8194
    max_speech_tokens: int = 4096

    backbone_name: str = "Llama_520M"
    input_pos_emb: Optional[str] = "learned"
    speech_cond_prompt_len: int = 150

    encoder_type: str = "voice_encoder"
    speaker_embed_size: int = 256
    use_perceiver_resampler: bool = True
    emotion_adv: bool = True

    @property
    def backbone(self) -> BackboneConfig:
        return BACKBONES[self.backbone_name]

    @property
    def is_multilingual(self) -> bool:
        return self.text_tokens_dict_size == 2454

    @classmethod
    def english_only(cls) -> "T3Config":
        """Llama-520M with CFG, perceiver, emotion input and learned
        positions (the original Chatterbox)."""
        return cls()

    @classmethod
    def multilingual(cls) -> "T3Config":
        """The 23-language model: english_only's Llama-520M with a
        2454-token grapheme text vocabulary."""
        return cls(text_tokens_dict_size=2454)

    @classmethod
    def turbo(cls) -> "T3Config":
        """GPT2-medium Turbo."""
        return cls(
            text_tokens_dict_size=50276, backbone_name="GPT2_medium",
            speech_tokens_dict_size=6563, input_pos_emb=None,
            speech_cond_prompt_len=375, use_perceiver_resampler=False,
            emotion_adv=False,
        )

    @classmethod
    def nano(cls) -> "T3Config":
        """GPT2-small Nano."""
        return cls(
            text_tokens_dict_size=50276, backbone_name="GPT2_small",
            speech_tokens_dict_size=6563, input_pos_emb=None,
            speech_cond_prompt_len=375, use_perceiver_resampler=False,
            emotion_adv=False,
        )

    @classmethod
    def tiny_test(cls, family: str = "gpt2") -> "T3Config":
        """A CPU-fast config for tests and smoke runs (not in the reference
        zoo); the speech table still covers the real special ids 6561 /
        6562."""
        if family == "gpt2":
            return cls(
                text_tokens_dict_size=64, backbone_name="GPT2_tiny_test",
                speech_tokens_dict_size=6564, input_pos_emb=None,
                speech_cond_prompt_len=8, use_perceiver_resampler=False,
                emotion_adv=False, max_text_tokens=64, max_speech_tokens=128,
            )
        return cls(
            text_tokens_dict_size=64, backbone_name="Llama_tiny_test",
            speech_tokens_dict_size=6564, input_pos_emb="learned",
            speech_cond_prompt_len=8, use_perceiver_resampler=True,
            emotion_adv=True, max_text_tokens=64, max_speech_tokens=128,
        )
