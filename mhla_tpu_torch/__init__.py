"""mhla_tpu_torch: the PyTorch / CUDA port of ``mhla_tpu``.

The JAX package ``mhla_tpu`` is the reference; this package mirrors its
structure and names so that each module has one counterpart there:

- ``mhla_tpu_torch.ops``     — functional MHLA operators (plain PyTorch)
- ``mhla_tpu_torch.kernels`` — hand-written Hopper kernels and their wrappers
- ``mhla_tpu_torch.layers``  — ``nn.Module`` layers (causal and video MHLA,
  softmax attention, norms, MLP)
- ``mhla_tpu_torch.models``  — the causal MHLA LM, generation, the Wan video
  model, weight bridges
- ``mhla_tpu_torch.diffusion``, ``mhla_tpu_torch.eval`` — the video samplers
  and the video inference entry point
- ``mhla_tpu_torch.train``, ``mhla_tpu_torch.data`` — the LM trainer

The package imports ``torch``, ``numpy`` and the standard library only; it
never imports ``jax`` or ``mhla_tpu``.
"""

__version__ = "0.1.0"
