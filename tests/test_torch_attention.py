"""The port's LM layers against the JAX package's, on the CPU in fp32: the
twins of ``tests/test_attention.py`` (flash vs direct softmax and its VJP
vs autograd through the direct softmax, decode at a position,
prefill-then-decode of a full block, the rope properties) and port-vs-JAX
checks of the flash VJP (against ``jax.grad``, at the reference's VJP
tolerance ``atol=5e-5, rtol=1e-3``),
``rmsnorm``, ``layernorm``, ``apply_rope``, ``mlp_block``,
``flash_attention``, ``decode_attention`` and ``attention_block`` (train,
prefill, decode).

Inputs are drawn with numpy from fixed seeds; the JAX package's
``init_params`` makes the weights and ``params_from_numpy`` carries them
across, so both packages compute on the same numbers.  Tolerance: port vs
JAX ``atol=2e-4, rtol=1e-3`` (fp32, sums in another order); the twins of
the reference's own checks keep its tolerances (``atol=2e-5, rtol=1e-4``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.layers import attention as jattn
from repro.layers import common as jcommon
from repro.layers import mlp as jmlp
from repro.layers import rope as jrope
from repro.layers.params import init_params as jax_init_params
from repro_torch.configs import get_config
from repro_torch.layers import attention as tattn
from repro_torch.layers import common as tcommon
from repro_torch.layers import mlp as tmlp
from repro_torch.layers import rope as trope
from repro_torch.layers.params import params_from_numpy

TOL = dict(atol=2e-4, rtol=1e-3)
REF_TOL = dict(atol=2e-5, rtol=1e-4)


def _t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float32).copy())


def _np(t):
    return t.detach().cpu().float().numpy()


def direct(q, k, v, causal=True):
    """Plain softmax attention in grouped layout (torch, fp32)."""
    D = q.shape[-1]
    s = torch.einsum("bqkgd,bskd->bqkgs", q, k) / np.sqrt(D)
    if causal:
        S, Sk = q.shape[1], k.shape[1]
        mask = torch.arange(S)[:, None] >= torch.arange(Sk)[None, :]
        s = torch.where(mask[None, :, None, None, :], s, -1e30)
    return torch.einsum("bqkgs,bskd->bqkgd", torch.softmax(s, -1), v)


def _qkv(seed, B, sq, kh, g, d, dv=None, sk=None):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, sq, kh, g, d)).astype(np.float32)
    k = rng.standard_normal((B, sk or sq, kh, d)).astype(np.float32)
    v = rng.standard_normal((B, sk or sq, kh, dv or d)).astype(np.float32)
    return q, k, v


# The reference draws 12 cases of this grid with hypothesis; the port runs
# a fixed spread of it: ragged Q and KV chunks, one chunk, G = 1, Kh = 3.
FLASH_CASES = [
    # sq, kh, g, d, chunk, q_chunk, causal
    (3, 1, 1, 8, 8, 16, True),
    (17, 2, 3, 16, 8, 16, True),
    (33, 3, 2, 8, 16, 24, False),
    (48, 2, 4, 16, 16, 16, True),
    (50, 1, 4, 8, 64, 512, True),
    (64, 3, 1, 16, 64, 24, False),
    (70, 2, 2, 8, 16, 24, True),
    (41, 1, 3, 16, 8, 512, False),
]


@pytest.mark.parametrize("sq,kh,g,d,chunk,q_chunk,causal", FLASH_CASES)
def test_flash_matches_direct(sq, kh, g, d, chunk, q_chunk, causal):
    q, k, v = _qkv(sq * 7 + d, 2, sq, kh, g, d)
    out = tattn.flash_attention(_t(q), _t(k), _t(v), causal=causal, chunk=chunk, q_chunk=q_chunk)
    np.testing.assert_allclose(_np(out), _np(direct(_t(q), _t(k), _t(v), causal)), **REF_TOL)


@pytest.mark.parametrize("sq,kh,g,d,chunk,q_chunk,causal", FLASH_CASES)
def test_flash_matches_jax(sq, kh, g, d, chunk, q_chunk, causal):
    q, k, v = _qkv(sq * 11 + d, 2, sq, kh, g, d, dv=d + 4)  # Dv != Dqk (the MLA case)
    out = tattn.flash_attention(_t(q), _t(k), _t(v), causal=causal, chunk=chunk, q_chunk=q_chunk)
    want = jattn.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                                 chunk=chunk, q_chunk=q_chunk)
    assert out.shape == want.shape
    np.testing.assert_allclose(_np(out), np.asarray(want), **TOL)


def test_flash_q_offset_matches_jax():
    """Queries that start later than the keys (a cached prefix)."""
    q, k, v = _qkv(3, 1, 12, 2, 2, 8, sk=40)
    out = tattn.flash_attention(_t(q), _t(k), _t(v), q_offset=28, chunk=16, q_chunk=8)
    want = jattn.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_offset=28,
                                 chunk=16, q_chunk=8)
    np.testing.assert_allclose(_np(out), np.asarray(want), **TOL)


def test_flash_vjp_matches_direct_grads():
    """Twin of tests/test_attention.py::test_flash_vjp_matches_direct_grads:
    the backward (the reference's ``_flash_bwd``) against autograd through a
    direct softmax, Dv != Dqk (the MLA case)."""
    q, k, v = _qkv(0, 2, 48, 2, 3, 16, dv=20)
    args = [_t(a).requires_grad_() for a in (q, k, v)]
    f = torch.sin(tattn.flash_attention(*args, causal=True, chunk=16, q_chunk=16)).sum()
    gf = torch.autograd.grad(f, args)
    r = torch.sin(direct(*args)).sum()
    gr = torch.autograd.grad(r, args)
    for a, b in zip(gf, gr):
        np.testing.assert_allclose(_np(a), _np(b), atol=5e-5, rtol=1e-3)


# Q padding (sq not a multiple of q_chunk), several KV chunks, a ragged
# last KV chunk, one Q chunk, G = 1, non-causal
FLASH_VJP_CASES = [
    # sq, kh, g, d, dv, chunk, q_chunk, causal
    (48, 2, 3, 16, 20, 16, 16, True),
    (37, 2, 2, 8, 8, 16, 24, True),
    (50, 1, 4, 8, 12, 16, 512, True),
    (33, 3, 1, 16, 16, 8, 16, False),
    (20, 1, 2, 8, 8, 64, 8, True),
]


@pytest.mark.parametrize("sq,kh,g,d,dv,chunk,q_chunk,causal", FLASH_VJP_CASES)
def test_flash_vjp_matches_jax(sq, kh, g, d, dv, chunk, q_chunk, causal):
    """``dq``, ``dk``, ``dv`` of ``sum(sin(flash_attention))`` against
    ``jax.grad`` of the JAX package's ``flash_attention`` (its custom VJP),
    at the reference's VJP tolerance."""
    q, k, v = _qkv(sq * 13 + d, 2, sq, kh, g, d, dv=dv)
    kw = dict(causal=causal, chunk=chunk, q_chunk=q_chunk)
    args = [_t(a).requires_grad_() for a in (q, k, v)]
    mine = torch.autograd.grad(torch.sin(tattn.flash_attention(*args, **kw)).sum(), args)
    theirs = jax.grad(lambda *a: jnp.sum(jnp.sin(jattn.flash_attention(*a, **kw))),
                      argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for a, b in zip(mine, theirs):
        assert a.shape == b.shape and a.dtype == torch.float32
        np.testing.assert_allclose(_np(a), np.asarray(b), atol=5e-5, rtol=1e-3)


def test_flash_vjp_returns_the_input_dtypes():
    """bf16 inputs get bf16 gradients (the reference casts ``dq``, ``dk``,
    ``dv`` back to the inputs' dtypes); the query positions get none."""
    q, k, v = (_t(a).bfloat16().requires_grad_() for a in _qkv(1, 1, 12, 1, 2, 8))
    out = tattn.flash_attention(q, k, v, chunk=8, q_chunk=8)
    grads = torch.autograd.grad(out.float().sum(), (q, k, v))
    assert [g.dtype for g in grads] == [torch.bfloat16] * 3
    assert all(bool(torch.isfinite(g.float()).all()) for g in grads)


def test_decode_attention_matches_full_at_position():
    B, S, Kh, G, D = 2, 32, 2, 2, 8
    q_all, k, v = (_t(a) for a in _qkv(1, B, S, Kh, G, D))
    full = direct(q_all, k, v, causal=True)
    pos = 17
    # cache semantics: positions > pos are garbage and must be masked
    k_cache, v_cache = k.clone(), v.clone()
    k_cache[:, pos + 1:] = 99.0
    v_cache[:, pos + 1:] = 99.0
    out = tattn.decode_attention(q_all[:, pos:pos + 1], k_cache, v_cache, pos)
    np.testing.assert_allclose(_np(out[:, 0]), _np(full[:, pos]), **REF_TOL)
    want = jattn.decode_attention(jnp.asarray(_np(q_all[:, pos:pos + 1])),
                                  jnp.asarray(_np(k_cache)), jnp.asarray(_np(v_cache)),
                                  jnp.int32(pos))
    np.testing.assert_allclose(_np(out), np.asarray(want), **TOL)


def _block_params(arch, seed):
    cfg = jax_get_config(arch).reduced()
    jp = jax_init_params(jattn.gqa_schema(cfg), jax.random.PRNGKey(seed))
    if cfg.qkv_bias:  # the schema zeroes the biases; non-zero ones check the bias path
        rng = np.random.default_rng(seed)
        jp = {k: (jnp.asarray(rng.standard_normal(v.shape).astype(np.float32) * 0.1)
                  if k in ("bq", "bk", "bv") else v) for k, v in jp.items()}
    if cfg.qk_norm:
        rng = np.random.default_rng(seed + 1)
        jp = {k: (jnp.asarray(1 + 0.1 * rng.standard_normal(v.shape).astype(np.float32))
                  if k in ("q_norm", "k_norm") else v) for k, v in jp.items()}
    return cfg, get_config(arch).reduced(), jp, params_from_numpy(jp)


def test_prefill_then_decode_consistency_full_block():
    """attention_block: decode at position S must equal a train forward
    over S+1 tokens at its last position."""
    _, cfg, _, p = _block_params("qwen2-0.5b", 2)
    B, S = 2, 24
    x = _t(np.random.default_rng(3).standard_normal((B, S + 1, cfg.d_model)))
    positions = torch.arange(S + 1, dtype=torch.int32).expand(B, S + 1)
    y_full, _ = tattn.attention_block(p, cfg, x, positions, mode="train")

    shape, dtype, _ = tattn.init_kv_cache_spec(cfg, B, S + 4)
    cache = (torch.zeros(shape, dtype=dtype), torch.zeros(shape, dtype=dtype))
    y_pre, cache = tattn.attention_block(p, cfg, x[:, :S], positions[:, :S], cache=cache,
                                         cache_pos=0, mode="prefill")
    np.testing.assert_allclose(_np(y_pre), _np(y_full[:, :S]), **REF_TOL)
    y_dec, _ = tattn.attention_block(p, cfg, x[:, S:S + 1], positions[:, S:S + 1], cache=cache,
                                     cache_pos=S, mode="decode")
    np.testing.assert_allclose(_np(y_dec[:, 0]), _np(y_full[:, S]), **REF_TOL)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "qwen3-1.7b"])  # QKV bias; qk_norm
def test_attention_block_matches_jax(arch):
    jcfg, cfg, jp, p = _block_params(arch, 4)
    B, S, Smax = 2, 20, 26
    xn = np.random.default_rng(5).standard_normal((B, S + 1, cfg.d_model)).astype(np.float32)
    pos_n = np.broadcast_to(np.arange(S + 1, dtype=np.int32), (B, S + 1))
    x, positions = _t(xn), torch.from_numpy(pos_n.copy())

    y, _ = tattn.attention_block(p, cfg, x, positions, mode="train")
    jy, _ = jattn.attention_block(jp, jcfg, jnp.asarray(xn), jnp.asarray(pos_n), mode="train")
    np.testing.assert_allclose(_np(y), np.asarray(jy), **TOL)

    shape, dtype, _ = tattn.init_kv_cache_spec(cfg, B, Smax)
    cache = (torch.zeros(shape, dtype=dtype), torch.zeros(shape, dtype=dtype))
    jcache = (jnp.zeros(shape, jnp.float32), jnp.zeros(shape, jnp.float32))
    y, cache = tattn.attention_block(p, cfg, x[:, :S], positions[:, :S], cache=cache,
                                     cache_pos=0, mode="prefill")
    jy, jcache = jattn.attention_block(jp, jcfg, jnp.asarray(xn[:, :S]),
                                       jnp.asarray(pos_n[:, :S]), cache=jcache,
                                       cache_pos=jnp.int32(0), mode="prefill")
    np.testing.assert_allclose(_np(y), np.asarray(jy), **TOL)
    for mine, theirs in zip(cache, jcache):
        np.testing.assert_allclose(_np(mine), np.asarray(theirs), **TOL)

    y, cache = tattn.attention_block(p, cfg, x[:, S:], positions[:, S:], cache=cache,
                                     cache_pos=S, mode="decode")
    jy, jcache = jattn.attention_block(jp, jcfg, jnp.asarray(xn[:, S:]), jnp.asarray(pos_n[:, S:]),
                                       cache=jcache, cache_pos=jnp.int32(S), mode="decode")
    np.testing.assert_allclose(_np(y), np.asarray(jy), **TOL)
    for mine, theirs in zip(cache, jcache):
        np.testing.assert_allclose(_np(mine), np.asarray(theirs), **TOL)


def test_rope_properties():
    B, S, H, D = 2, 16, 3, 8
    x = _t(np.random.default_rng(4).standard_normal((B, S, H, D)))
    pos = torch.arange(S, dtype=torch.int32).expand(B, S)
    y = trope.apply_rope(x, pos, theta=1e4)
    # norm preservation per pair
    np.testing.assert_allclose(np.linalg.norm(_np(x), axis=-1), np.linalg.norm(_np(y), axis=-1),
                               rtol=1e-5)
    # relative property: <rope(q,i), rope(k,j)> depends only on i-j
    q = _t(np.random.default_rng(5).standard_normal((1, 1, 1, D)))
    k = _t(np.random.default_rng(6).standard_normal((1, 1, 1, D)))

    def dot_at(i, j):
        qi = trope.apply_rope(q, torch.tensor([[i]]), theta=1e4)
        kj = trope.apply_rope(k, torch.tensor([[j]]), theta=1e4)
        return float(torch.sum(qi * kj))

    assert dot_at(3, 1) == pytest.approx(dot_at(10, 8), abs=1e-4)
    assert dot_at(5, 5) == pytest.approx(float(torch.sum(q * k)), abs=1e-4)


@pytest.mark.parametrize("shape", [(2, 9, 3, 16), (2, 9, 16)], ids=["heads", "squeezed"])
@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_apply_rope_matches_jax(shape, theta):
    rng = np.random.default_rng(7)
    xn = rng.standard_normal(shape).astype(np.float32)
    pos = rng.integers(0, 4000, size=shape[:2]).astype(np.int32)
    y = trope.apply_rope(_t(xn), torch.from_numpy(pos), theta=theta)
    want = jrope.apply_rope(jnp.asarray(xn), jnp.asarray(pos), theta=theta)
    np.testing.assert_allclose(_np(y), np.asarray(want), **TOL)


def test_rmsnorm_and_layernorm_match_jax():
    rng = np.random.default_rng(8)
    xn = (3 * rng.standard_normal((2, 5, 64))).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(64)).astype(np.float32)
    np.testing.assert_allclose(
        _np(tcommon.rmsnorm(_t(xn), _t(scale), 1e-6)),
        np.asarray(jcommon.rmsnorm(jnp.asarray(xn), jnp.asarray(scale), 1e-6)), **TOL)
    for b in (bias, None):
        np.testing.assert_allclose(
            _np(tcommon.layernorm(_t(xn), _t(scale), None if b is None else _t(b))),
            np.asarray(jcommon.layernorm(jnp.asarray(xn), jnp.asarray(scale),
                                         None if b is None else jnp.asarray(b))), **TOL)
    # bf16 in, bf16 out, fp32 statistics
    assert tcommon.rmsnorm(_t(xn).bfloat16(), _t(scale)).dtype == torch.bfloat16


@pytest.mark.parametrize("act", ["silu", "gelu", "relu"])
def test_mlp_block_matches_jax(act):
    jcfg = dataclasses.replace(jax_get_config("qwen2-0.5b").reduced(), mlp_act=act)
    cfg = dataclasses.replace(get_config("qwen2-0.5b").reduced(), mlp_act=act)
    jp = jax_init_params(jmlp.mlp_schema(jcfg), jax.random.PRNGKey(9))
    p = params_from_numpy(jp)
    assert sorted(p) == (["wg", "wi", "wo"] if act == "silu" else ["wi", "wo"])
    xn = np.random.default_rng(10).standard_normal((2, 7, cfg.d_model)).astype(np.float32)
    np.testing.assert_allclose(_np(tmlp.mlp_block(p, cfg, _t(xn))),
                               np.asarray(jmlp.mlp_block(jp, jcfg, jnp.asarray(xn))), **TOL)


def test_gelu_is_the_tanh_approximation():
    x = np.linspace(-4, 4, 101).astype(np.float32)
    np.testing.assert_allclose(_np(tcommon.act_fn("gelu")(_t(x))),
                               np.asarray(jax.nn.gelu(jnp.asarray(x))), atol=1e-6)


def test_cross_entropy_matches_jax():
    rng = np.random.default_rng(11)
    logits = rng.standard_normal((2, 6, 50)).astype(np.float32)
    targets = rng.integers(0, 50, size=(2, 6)).astype(np.int32)
    mask = (rng.uniform(size=(2, 6)) > 0.3).astype(np.int32)
    loss, metrics = tcommon.cross_entropy(_t(logits), torch.from_numpy(targets),
                                          torch.from_numpy(mask))
    jloss, jmetrics = jcommon.cross_entropy(jnp.asarray(logits), jnp.asarray(targets),
                                            jnp.asarray(mask))
    np.testing.assert_allclose(float(loss), float(jloss), **TOL)
    for key in ("tokens", "z_mean"):
        np.testing.assert_allclose(float(metrics[key]), float(jmetrics[key]), **TOL)
