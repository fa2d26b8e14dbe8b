"""Inference entry points: video sampling."""

from .video_inference import sample_video_latents

__all__ = ["sample_video_latents"]
