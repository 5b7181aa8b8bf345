"""chatterbox_tpu_torch: the PyTorch/CUDA port of chatterbox_tpu for NVIDIA
Hopper (H100). Plain tensor code is PyTorch; the TPU package's Pallas kernels
become hand-written CUDA kernels (csrc/, bound in kernels/). Entry points run
on "cuda" unless the caller passes another device."""
from .api.pipelines import (ChatterboxMultilingualTTS, ChatterboxTTS,  # noqa: F401
                            ChatterboxTurboTTS, ChatterboxVC, Conditionals, T3CondHost)
from .models.s3gen.model import RefDict  # noqa: F401

__version__ = "0.1.0"
