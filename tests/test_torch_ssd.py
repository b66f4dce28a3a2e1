"""The port's Mamba2 SSD layer (``repro_torch.layers.ssd``) against the JAX
package's, on the CPU in fp32: ``ssd_chunked`` (a length that needs
padding, a carried initial state), ``ssd_reference``, ``ssd_decode_step``
and ``mamba_block`` in train, prefill and decode mode (outputs and the
conv / SSM caches) at mamba2-130m's reduced config, its gradient against
``jax.grad``, and the softplus of large arguments; plus the twins of
``tests/test_ssd.py`` (chunked vs recurrence, prefill then decode,
the state carry, block decode after prefill).

Inputs are drawn with numpy from fixed seeds; block weights come from the
JAX package's ``init_params`` through ``params_from_numpy``.  Tolerance
``atol=1e-4, rtol=1e-3`` (the reference's ``test_ssd.py``); the twin of its
block test keeps its ``atol=2e-4``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.layers import ssd as jssd
from repro.layers.params import init_params as jax_init_params
from repro_torch.configs import get_config
from repro_torch.layers import ssd
from repro_torch.layers.params import params_from_numpy, tree_leaves_with_path, tree_unflatten

TOL = dict(atol=1e-4, rtol=1e-3)
BLOCK_TOL = dict(atol=2e-4, rtol=1e-3)
ARCH = "mamba2-130m"


def _np(t):
    return t.detach().cpu().float().numpy()


def make_inputs(seed, B, S, H, P, N):
    """(x, dt, A, Bm, Cm) as numpy arrays: the reference's distributions."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.logaddexp(rng.standard_normal((B, S, H)), 0).astype(np.float32)
    A = (-np.exp(rng.standard_normal(H) * 0.5)).astype(np.float32)
    Bm = (rng.standard_normal((B, S, H, N)) * 0.3).astype(np.float32)
    Cm = (rng.standard_normal((B, S, H, N)) * 0.3).astype(np.float32)
    return x, dt, A, Bm, Cm


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("S,chunk,h0", [(37, 16, False), (24, 8, True), (5, 64, False)])
def test_ssd_chunked_matches_jax(S, chunk, h0):
    """37 = 2·16 + 5 pads the last chunk with dt = 0 steps; a carried
    initial state; one chunk shorter than ``chunk``."""
    inputs = make_inputs(S, 2, S, 3, 4, 8)
    state = (np.random.default_rng(5).standard_normal((2, 3, 4, 8)).astype(np.float32)
             if h0 else None)
    y, hT = ssd.ssd_chunked(*_t(inputs), chunk=chunk,
                            h0=None if state is None else torch.from_numpy(state))
    jy, jhT = jssd.ssd_chunked(*_j(inputs), chunk=chunk,
                               h0=None if state is None else jnp.asarray(state))
    assert y.shape == (2, S, 3, 4) and hT.dtype == torch.float32
    np.testing.assert_allclose(_np(y), np.asarray(jy), **TOL)
    np.testing.assert_allclose(_np(hT), np.asarray(jhT), **TOL)


def test_ssd_reference_and_decode_step_match_jax():
    inputs = make_inputs(7, 2, 12, 3, 4, 8)
    y, hT = ssd.ssd_reference(*_t(inputs))
    jy, jhT = jssd.ssd_reference(*_j(inputs))
    np.testing.assert_allclose(_np(y), np.asarray(jy), **TOL)
    np.testing.assert_allclose(_np(hT), np.asarray(jhT), **TOL)
    x, dt, A, Bm, Cm = inputs
    h, y1 = ssd.ssd_decode_step(hT, *_t((x[:, 3], dt[:, 3], A, Bm[:, 3], Cm[:, 3])))
    jh, jy1 = jssd.ssd_decode_step(jhT, *_j((x[:, 3], dt[:, 3], A, Bm[:, 3], Cm[:, 3])))
    np.testing.assert_allclose(_np(h), np.asarray(jh), **TOL)
    np.testing.assert_allclose(_np(y1), np.asarray(jy1), **TOL)


@functools.lru_cache(maxsize=None)
def _block_setup(ngroups=1):
    jcfg = jax_get_config(ARCH).reduced(ssm_ngroups=ngroups)
    cfg = get_config(ARCH).reduced(ssm_ngroups=ngroups)
    jp = jax_init_params(jssd.mamba_schema(jcfg), jax.random.PRNGKey(2))
    # the schema zeroes dt_bias and A_log; seeded ones check their paths
    rng = np.random.default_rng(3)
    jp = dict(jp, dt_bias=jnp.asarray(rng.standard_normal(cfg.ssm_heads).astype(np.float32)),
              A_log=jnp.asarray(0.5 * rng.standard_normal(cfg.ssm_heads).astype(np.float32)),
              conv_b=jnp.asarray(0.1 * rng.standard_normal(jp["conv_b"].shape)
                                 .astype(np.float32)))
    x = (rng.standard_normal((2, 45, cfg.d_model)) * 0.5).astype(np.float32)
    return jcfg, cfg, jp, x


def _caches(jcfg, cfg, B):
    (cs, _), (ss, _) = ssd.init_ssm_cache_spec(cfg, B)
    (jcs, _), (jss, _) = jssd.init_ssm_cache_spec(jcfg, B)
    assert (cs, ss) == (jcs, jss)
    return (torch.zeros(cs), torch.zeros(ss)), (jnp.zeros(jcs), jnp.zeros(jss))


@pytest.mark.parametrize("ngroups", [1, 2])
def test_mamba_block_matches_jax(ngroups):
    """Train over 45 positions (two 32-chunks, the second padded), then
    prefill 44 and decode position 44: outputs, conv windows and SSM
    states; the port's caches are written in place.  Two B/C groups check
    their broadcast to heads (``jnp.repeat``: group g feeds a run of
    heads, which is ``repeat_interleave``)."""
    jcfg, cfg, jp, x = _block_setup(ngroups)
    p = params_from_numpy(jp)
    jblock = jax.jit(jssd.mamba_block, static_argnums=1, static_argnames="mode")
    y, nc = ssd.mamba_block(p, cfg, torch.from_numpy(x), mode="train")
    jy, _ = jblock(jp, jcfg, jnp.asarray(x), mode="train")
    assert nc is None
    np.testing.assert_allclose(_np(y), np.asarray(jy), **TOL)

    cache, jcache = _caches(jcfg, cfg, 2)
    for mode, sl in (("prefill", slice(0, 44)), ("decode", slice(44, 45))):
        y, out = ssd.mamba_block(p, cfg, torch.from_numpy(x[:, sl]), cache=cache, mode=mode)
        jy, jcache = jblock(jp, jcfg, jnp.asarray(x[:, sl]), cache=jcache, mode=mode)
        assert out[0] is cache[0] and out[1] is cache[1]
        np.testing.assert_allclose(_np(y), np.asarray(jy), err_msg=mode, **TOL)
        for got, want in zip(cache, jcache):
            np.testing.assert_allclose(_np(got), np.asarray(want), err_msg=mode, **TOL)


def test_mamba_block_gradient_matches_jax():
    jcfg, cfg, jp, x = _block_setup()
    x = x[:1, :40]
    jg = jax.jit(jax.grad(
        lambda pp: jnp.sum(jssd.mamba_block(pp, jcfg, jnp.asarray(x))[0] ** 2)))(jp)
    paths, leaves = zip(*tree_leaves_with_path(params_from_numpy(jp)))
    xs = [t.requires_grad_() for t in leaves]
    y, _ = ssd.mamba_block(tree_unflatten(paths, xs), cfg, torch.from_numpy(x))
    grads = torch.autograd.grad(torch.sum(y ** 2), xs)
    for path, g in zip(paths, grads):
        np.testing.assert_allclose(_np(g), np.asarray(jg[path[0]]), err_msg="/".join(path),
                                   **TOL)


def test_segsum_keeps_short_segments_exact_over_a_long_chunk():
    """Over a 128-step chunk of dA ~ -0.7 the running sums reach ~ -90; the
    port sums each segment on its own, so exp(segsum) of short segments
    keeps fp32 precision (the difference of running sums, the reference's
    form, keeps ~1e-5 of it).  Against float64 truth."""
    rng = np.random.default_rng(9)
    dA = -np.logaddexp(rng.standard_normal((2, 3, 128)), 0)
    want = np.exp(ssd._segsum(torch.from_numpy(dA)).numpy())  # float64
    got = np.exp(ssd._segsum(torch.from_numpy(dA.astype(np.float32))).numpy())
    near = np.tril(np.ones((128, 128), bool)) & ~np.tril(np.ones((128, 128), bool), -9)
    np.testing.assert_allclose(got[..., near], want[..., near], rtol=2e-6)
    assert np.all(np.triu(got[0, 0], 1) == 0.0)


def test_softplus_matches_jax_beyond_torch_threshold():
    v = np.array([-50.0, -3.0, 0.0, 1e-3, 5.0, 19.9, 20.1, 40.0, 300.0], np.float32)
    np.testing.assert_allclose(_np(ssd._softplus(torch.from_numpy(v))),
                               np.asarray(jax.nn.softplus(jnp.asarray(v))), rtol=1e-6)


# ----------------------------------------------------------------------
# Twins of tests/test_ssd.py
# ----------------------------------------------------------------------
@pytest.mark.slow
@pytest.mark.parametrize("s,chunk,h,p,n", [(16, 4, 1, 4, 4), (32, 16, 3, 8, 16),
                                           (64, 64, 4, 4, 16), (64, 8, 2, 8, 4)])
def test_chunked_equals_recurrence(s, chunk, h, p, n):
    inputs = _t(make_inputs(s + h, 2, s, h, p, n))
    y_ref, h_ref = ssd.ssd_reference(*inputs)
    y, hT = ssd.ssd_chunked(*inputs, chunk=chunk)
    np.testing.assert_allclose(_np(y), _np(y_ref), **TOL)
    np.testing.assert_allclose(_np(hT), _np(h_ref), **TOL)


@pytest.mark.slow
def test_prefill_then_decode_continues_exactly():
    x, dt, A, Bm, Cm = _t(make_inputs(0, 2, 48, 3, 8, 16))
    y_ref, _ = ssd.ssd_reference(x, dt, A, Bm, Cm)
    _, h = ssd.ssd_chunked(x[:, :32], dt[:, :32], A, Bm[:, :32], Cm[:, :32], chunk=16)
    outs = []
    for t in range(32, 48):
        h, y = ssd.ssd_decode_step(h, x[:, t], dt[:, t], A, Bm[:, t], Cm[:, t])
        outs.append(y)
    np.testing.assert_allclose(_np(torch.stack(outs, 1)), _np(y_ref[:, 32:]), **TOL)


def test_state_carry_is_the_overlap_buffer():
    """Two chunked calls with the carried state equal one call — the
    tilted-fusion hand-off property on the sequence axis."""
    x, dt, A, Bm, Cm = _t(make_inputs(1, 1, 64, 2, 4, 8))
    y_all, h_all = ssd.ssd_chunked(x, dt, A, Bm, Cm, chunk=16)
    y1, h1 = ssd.ssd_chunked(x[:, :32], dt[:, :32], A, Bm[:, :32], Cm[:, :32], chunk=16)
    y2, h2 = ssd.ssd_chunked(x[:, 32:], dt[:, 32:], A, Bm[:, 32:], Cm[:, 32:], chunk=16, h0=h1)
    np.testing.assert_allclose(_np(torch.cat([y1, y2], 1)), _np(y_all), **TOL)
    np.testing.assert_allclose(_np(h2), _np(h_all), **TOL)


@pytest.mark.slow
def test_mamba_block_decode_matches_prefill_tail():
    cfg = get_config(ARCH).reduced()
    p = params_from_numpy(jax_init_params(jssd.mamba_schema(jax_get_config(ARCH).reduced()),
                                          jax.random.PRNGKey(2)))
    B, S = 2, 33
    x = torch.from_numpy((np.random.default_rng(3).standard_normal((B, S, cfg.d_model)) * 0.5)
                         .astype(np.float32))
    y_full, _ = ssd.mamba_block(p, cfg, x, mode="train")
    (cs, _), (ss, _) = ssd.init_ssm_cache_spec(cfg, B)
    cache = (torch.zeros(cs), torch.zeros(ss))
    y_pre, cache = ssd.mamba_block(p, cfg, x[:, :32], cache=cache, mode="prefill")
    np.testing.assert_allclose(_np(y_pre), _np(y_full[:, :32]), **BLOCK_TOL)
    y_dec, _ = ssd.mamba_block(p, cfg, x[:, 32:33], cache=cache, mode="decode")
    np.testing.assert_allclose(_np(y_dec[:, 0]), _np(y_full[:, 32]), **BLOCK_TOL)
