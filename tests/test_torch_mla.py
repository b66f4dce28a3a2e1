"""The port's Multi-head Latent Attention (``repro_torch.layers.mla``)
against the JAX package's, on the CPU in fp32 at deepseek-v2's reduced
config: ``mla_block`` in train, prefill (output and the packed latent
cache) and decode (the absorbed form: output and cache) mode, and its
gradient against ``jax.grad``; plus the twins of ``tests/test_mla.py``
(prefill-then-decode against the train forward, the compressed cache,
finite gradients).

Weights come from the JAX package's ``init_params`` and cross over with
``params_from_numpy``; inputs are drawn with numpy from fixed seeds.
Tolerance ``atol=1e-4, rtol=1e-3`` port vs JAX; the twins keep the
reference's ``atol=3e-5, rtol=1e-3``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.layers import mla as jmla
from repro.layers.params import init_params as jax_init_params
from repro_torch.configs import get_config
from repro_torch.layers import mla
from repro_torch.layers.params import params_from_numpy, tree_leaves_with_path, tree_unflatten

TOL = dict(atol=1e-4, rtol=1e-3)
REF_TOL = dict(atol=3e-5, rtol=1e-3)
ARCH = "deepseek-v2-236b"
B, S = 2, 20


def _np(t):
    return t.detach().cpu().float().numpy()


@functools.lru_cache(maxsize=None)
def _setup():
    jcfg, cfg = jax_get_config(ARCH).reduced(), get_config(ARCH).reduced()
    jp = jax_init_params(jmla.mla_schema(jcfg), jax.random.PRNGKey(0))
    x = (np.random.default_rng(1).standard_normal((B, S + 1, cfg.d_model)) * 0.5).astype(
        np.float32)
    pos = np.broadcast_to(np.arange(S + 1, dtype=np.int32), (B, S + 1)).copy()
    return jcfg, cfg, jp, x, pos


def _empty_caches(jcfg, cfg, max_len):
    shape, dtype, _ = mla.init_mla_cache_spec(cfg, B, max_len)
    jshape, jdtype, _ = jmla.init_mla_cache_spec(jcfg, B, max_len)
    assert shape == jshape and dtype == getattr(torch, str(jnp.dtype(jdtype)))
    return torch.zeros(shape, dtype=dtype), jnp.zeros(jshape, jdtype)


def test_mla_train_matches_jax():
    jcfg, cfg, jp, x, pos = _setup()
    y, cache = mla.mla_block(params_from_numpy(jp), cfg, torch.from_numpy(x),
                             torch.from_numpy(pos), mode="train")
    jy, _ = jmla.mla_block(jp, jcfg, jnp.asarray(x), jnp.asarray(pos), mode="train")
    assert cache is None
    np.testing.assert_allclose(_np(y), np.asarray(jy), **TOL)


def test_mla_prefill_and_decode_match_jax():
    """Prefill S positions, then decode position S in the absorbed form;
    the port writes its cache in place and returns that same tensor."""
    jcfg, cfg, jp, x, pos = _setup()
    p = params_from_numpy(jp)
    cache, jcache = _empty_caches(jcfg, cfg, S + 4)
    y, out = mla.mla_block(p, cfg, torch.from_numpy(x[:, :S]), torch.from_numpy(pos[:, :S]),
                           cache=cache, cache_pos=0, mode="prefill")
    jy, jcache = jmla.mla_block(jp, jcfg, jnp.asarray(x[:, :S]), jnp.asarray(pos[:, :S]),
                                cache=jcache, cache_pos=jnp.int32(0), mode="prefill")
    assert out is cache
    np.testing.assert_allclose(_np(y), np.asarray(jy), **TOL)
    np.testing.assert_allclose(_np(cache), np.asarray(jcache), **TOL)

    y, out = mla.mla_block(p, cfg, torch.from_numpy(x[:, S:]), torch.from_numpy(pos[:, S:]),
                           cache=cache, cache_pos=S, mode="decode")
    jy, jcache = jmla.mla_block(jp, jcfg, jnp.asarray(x[:, S:]), jnp.asarray(pos[:, S:]),
                                cache=jcache, cache_pos=jnp.int32(S), mode="decode")
    assert out is cache
    np.testing.assert_allclose(_np(y), np.asarray(jy), **TOL)
    np.testing.assert_allclose(_np(cache), np.asarray(jcache), **TOL)


def test_mla_gradient_matches_jax():
    jcfg, cfg, jp, x, pos = _setup()
    xs16, pos16 = x[:1, :16], pos[:1, :16]
    jg = jax.jit(jax.grad(lambda pp: jnp.sum(jmla.mla_block(
        pp, jcfg, jnp.asarray(xs16), jnp.asarray(pos16))[0] ** 2)))(jp)
    paths, leaves = zip(*tree_leaves_with_path(params_from_numpy(jp)))
    xs = [t.requires_grad_() for t in leaves]
    y, _ = mla.mla_block(tree_unflatten(paths, xs), cfg, torch.from_numpy(xs16),
                         torch.from_numpy(pos16))
    grads = torch.autograd.grad(torch.sum(y ** 2), xs)
    for path, g in zip(paths, grads):
        np.testing.assert_allclose(_np(g), np.asarray(jg[path[0]]), err_msg="/".join(path),
                                   **TOL)


def test_mla_rejects_an_unknown_mode():
    jcfg, cfg, jp, x, pos = _setup()
    with pytest.raises(ValueError, match="unknown mode"):
        mla.mla_block(params_from_numpy(jp), cfg, torch.from_numpy(x), torch.from_numpy(pos),
                      mode="verify")


# ----------------------------------------------------------------------
# Twins of tests/test_mla.py
# ----------------------------------------------------------------------
@pytest.mark.slow
def test_prefill_decode_matches_train_forward():
    """The absorbed decode path (attention in the latent space) reproduces
    the decompressed path up to fp32 association."""
    _, cfg, jp, x, pos = _setup()
    assert cfg.attention == "mla"
    p = params_from_numpy(jp)
    xt, post = torch.from_numpy(x), torch.from_numpy(pos)
    y_full, _ = mla.mla_block(p, cfg, xt, post, mode="train")
    shape, dtype, _ = mla.init_mla_cache_spec(cfg, B, S + 4)
    cache = torch.zeros(shape, dtype=dtype)
    y_pre, cache = mla.mla_block(p, cfg, xt[:, :S], post[:, :S], cache=cache, cache_pos=0,
                                 mode="prefill")
    np.testing.assert_allclose(_np(y_pre), _np(y_full[:, :S]), **REF_TOL)
    y_dec, _ = mla.mla_block(p, cfg, xt[:, S:S + 1], post[:, S:S + 1], cache=cache,
                             cache_pos=S, mode="decode")
    np.testing.assert_allclose(_np(y_dec[:, 0]), _np(y_full[:, S]), **REF_TOL)


def test_cache_is_compressed():
    """Cache bytes per token = r_kv + rope_dim, not 2 * heads * head_dim."""
    cfg = get_config(ARCH)
    shape, _, _ = mla.init_mla_cache_spec(cfg, 1, 1)
    per_token = shape[-1]
    assert per_token == cfg.kv_lora_rank + cfg.rope_head_dim  # 576
    full_kv = 2 * cfg.num_heads * cfg.head_dim  # 32768
    assert per_token * 50 < full_kv  # >50x smaller


@pytest.mark.slow
def test_mla_grads_finite():
    cfg = get_config(ARCH).reduced()
    jp = jax_init_params(jmla.mla_schema(jax_get_config(ARCH).reduced()), jax.random.PRNGKey(2))
    p = params_from_numpy(jp)
    leaves = [t.requires_grad_() for _, t in tree_leaves_with_path(p)]
    x = (np.random.default_rng(3).standard_normal((1, 16, cfg.d_model)) * 0.5).astype(np.float32)
    pos = torch.arange(16, dtype=torch.int32)[None]
    y, _ = mla.mla_block(p, cfg, torch.from_numpy(x), pos)
    grads = torch.autograd.grad(torch.sum(y ** 2), leaves)
    assert all(bool(torch.isfinite(g).all()) for g in grads)
