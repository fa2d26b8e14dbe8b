"""Inference entry points: video sampling, long-context perplexity, the
lm-eval bridge and the DiT FID sampler."""

from .fid import build_sample_npz, latents_to_uint8
from .harness import SimpleLMEval
from .ppl import PerplexityEvaluator, token_nll
from .video_inference import sample_video_latents

__all__ = [
    "PerplexityEvaluator",
    "SimpleLMEval",
    "build_sample_npz",
    "latents_to_uint8",
    "sample_video_latents",
    "token_nll",
]
