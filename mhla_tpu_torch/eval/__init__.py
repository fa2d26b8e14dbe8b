"""Inference entry points: video sampling, long-context perplexity and the
lm-eval bridge."""

from .harness import SimpleLMEval
from .ppl import PerplexityEvaluator, token_nll
from .video_inference import sample_video_latents

__all__ = ["PerplexityEvaluator", "SimpleLMEval", "sample_video_latents", "token_nll"]
