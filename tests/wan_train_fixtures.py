"""Shared pieces of the video-training tests (``test_torch_wan_train.py``,
``test_torch_wan_train_entry.py``, ``test_torch_lora.py``): the tiny model forms, one seeded set of
weights for both packages, batches, both packages' flow losses, the
entry point's tiny arguments and, compiled once per process and model
form, ``jax.jit`` of the JAX loss's value and gradient (compiling dominates
the JAX side at these sizes: ~12 s, against ~0.2 s a call).

Weights, latents, timesteps, noise and dropout masks come from numpy (or
from one JAX key, converted) and go to both packages. Head dim 128 takes the
fused island on both sides: the JAX side runs its Pallas bodies in interpret
mode, the port its plain versions.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mhla_tpu.diffusion import flow_q_sample as jax_flow_q_sample
from mhla_tpu.models.wan import WanModel as JaxWanModel
from mhla_tpu.models.wan import build_wan_config as jax_build_wan_config
from mhla_tpu_torch.models import WanModel, build_wan_config, wan_params_from_jax
from mhla_tpu_torch.train import wan_train

from test_torch_wan import TINY, _random_params, _to_jax

LATENT = (2, 8, 12, 16)  # patch (1, 2, 2) -> grid (2, 4, 6): nothing for grid_adjust to crop
# float32 gradients through 2 or 3 blocks (XLA vs ATen GEMMs, other summation orders)
TOL = 1e-4
FULL = dict(TINY)  # 2 layers, both MHLA
HYBRID = dict(TINY, num_layers=3, linear_attn_idx=(1, 2))  # layer 0 dense softmax
# layers: radial-sparse softmax, MHLA, dense softmax; no dense guard, as the
# video trainer builds the model. 4 frames of 24 tokens (grid (4, 4, 6)), so
# that frame distances 2 and 3 are banded: with 2 frames the mask keeps all
SPARSE = dict(TINY, num_layers=3, linear_attn_idx=(1,), sparse_attn_idx=(0,),
              sparse_dense_from_t=None)
SPARSE_LATENT = (4, 8, 12, 16)
FORMS = {"full": (FULL, LATENT), "hybrid": (HYBRID, LATENT), "sparse": (SPARSE, SPARSE_LATENT)}
_FORM_NAMES = list(FORMS)
WAN_OPT = dict(learning_rate=1e-4, weight_decay=0.01, grad_clip=0.1, warmup_steps=1,
               total_steps=10, optimizer="adamw")


def _models(kw, seed, jax_dtype=jnp.float32, torch_dtype=torch.float32, remat=False,
            latent=LATENT):
    jax_model = _jax_model(tuple(sorted(kw.items())), jax_dtype)
    shapes = jax.eval_shape(
        lambda: jax_model.init(
            jax.random.PRNGKey(0), jnp.zeros((1, *latent)), jnp.zeros((1,)),
            jnp.zeros((1, kw["text_len"], kw["text_dim"])),
        )
    )
    params_np = _random_params(shapes, seed=seed)
    port = WanModel(build_wan_config(dtype=torch_dtype, remat=remat, **kw))
    port.load_state_dict(wan_params_from_jax(params_np))
    return jax_model, _to_jax(params_np), port


def _batch(seed, b=2, latent=LATENT):
    """Latents, text embeddings, timesteps in (0, 1), noise and a dropout
    mask that drops the second sample's text."""
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(b, *latent)).astype(np.float32)
    ctx = (rng.normal(size=(b, TINY["text_len"], TINY["text_dim"])) * 0.5).astype(np.float32)
    t01 = rng.uniform(0.1, 0.9, size=(b,)).astype(np.float32)
    noise = rng.normal(size=z.shape).astype(np.float32)
    drop = np.arange(b) % 2 == 1
    return z, ctx, t01, noise, drop


def _jax_loss(jax_model, dtype):
    """The loss of ``mhla_tpu.train.wan_train.main``'s ``loss_fn`` with the
    step's draws taken from the batch instead of a key."""

    def loss(p, batch, _rng=None):
        z, ctx, t01, noise, drop = batch
        ctx = jnp.where(drop[:, None, None], 0.0, ctx)
        x_t = jax_flow_q_sample(z, t01, noise)
        v = jax_model.apply(p, x_t.astype(dtype), t01 * 1000.0, ctx.astype(dtype))
        mse = jnp.mean(jnp.square(v.astype(jnp.float32) - (noise - z)), axis=(1, 2, 3, 4))
        return mse.mean(), {}

    return loss


def _port_loss(model, batch):
    z, ctx, t01, noise, drop = batch
    return wan_train.video_loss(model, z, ctx, t01, drop, noise=noise), {}


def _torch_batch(batch):
    return tuple(torch.from_numpy(a) for a in batch)


def _jax_batch(batch):
    return tuple(jnp.asarray(a) for a in batch)


# the sizes of tests/test_harnesses.py::TestWanTrain
_TINY_ARGS = [
    "--device=cpu", "--model.model=Wan_T2V_1300M", "--model.dim=48", "--model.ffn_dim=96",
    "--model.num_heads=4", "--model.block_layout=(2,2,2)", "--bf16=false",
    "--data.latent_frames=4", "--data.latent_height=8", "--data.latent_width=8",
    "--data.latent_dim=4", "--data.text_len=8", "--data.text_dim=32", "--train.log_interval=1",
    "--train.save_interval=100", "--optimizer.total_steps=2", "--optimizer.warmup_steps=1",
]
_HYBRID_ARGS = _TINY_ARGS + ["--model.num_layers=2", "--model.linear_attn_idx=(0,)"]

@functools.lru_cache(maxsize=None)
def _jax_model(kw_items, jax_dtype):
    return JaxWanModel(jax_build_wan_config(remat=False, dtype=jax_dtype, **dict(kw_items)))


@functools.lru_cache(maxsize=None)
def _jitted_value_and_grad(kw_items, jax_dtype):
    loss = _jax_loss(_jax_model(kw_items, jax_dtype), jax_dtype)
    return jax.jit(jax.value_and_grad(lambda p, b: loss(p, b)[0]))


def jax_value_and_grad(kw, params, batch, jax_dtype=jnp.float32):
    """(loss, gradient tree) of the JAX training loss of the model form
    ``kw`` at ``params`` on the numpy ``batch``, through one ``jax.jit``
    per form and dtype (traced with the interpret-mode flag the calling
    test sets)."""
    fn = _jitted_value_and_grad(tuple(sorted(kw.items())), jax_dtype)
    return fn(params, _jax_batch(batch))
