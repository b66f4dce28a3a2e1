"""The port's MoE layer (``repro_torch.layers.moe``) against the JAX
package's, on the CPU in fp32: ``moe_block`` at S > 1 with capacity drops
(every metric, ``moe_dropped_frac`` exactly equal), at S == 1 (the dense
decode path), with shared experts, its gradient against ``jax.grad``, and
the router's tie order; plus the twins of ``tests/test_moe.py`` (the loop
reference, no drops at high capacity, the shared experts' path, the aux
loss balanced vs collapsed, differentiability).

Weights come from the JAX package's ``init_params`` and cross over with
``params_from_numpy``; inputs are drawn with numpy from fixed seeds.
Tolerance ``atol=1e-4, rtol=1e-3`` (the reference's ``test_moe.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.layers import moe as jmoe
from repro.layers.params import init_params as jax_init_params
from repro_torch.configs import get_config
from repro_torch.layers import moe
from repro_torch.layers.params import params_from_numpy, tree_leaves_with_path, tree_unflatten

TOL = dict(atol=1e-4, rtol=1e-3)


def _np(t):
    return t.detach().cpu().float().numpy()


def small_cfgs(**kw):
    """(JAX config, port config): the reference's ``small_cfg`` (arctic,
    reduced to 4 experts top-2 at d_model 16) with ``kw`` replaced."""
    base = dict(num_experts=4, experts_per_token=2, d_model=16, moe_d_ff=32,
                capacity_factor=1.5, dense_residual=False)
    jcfg = dataclasses.replace(jax_get_config("arctic-480b").reduced(**base), **kw)
    cfg = dataclasses.replace(get_config("arctic-480b").reduced(**base), **kw)
    return jcfg, cfg


def _setup(seed, shape, **kw):
    jcfg, cfg = small_cfgs(**kw)
    jp = jax_init_params(jmoe.moe_schema(jcfg), jax.random.PRNGKey(seed))
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jcfg, cfg, jp, params_from_numpy(jp), x


def _run_both(jcfg, cfg, jp, p, x):
    jy, jm = jmoe.moe_block(jp, jcfg, jnp.asarray(x))
    y, m = moe.moe_block(p, cfg, torch.from_numpy(x))
    return (y, m), (jy, jm)


@pytest.mark.parametrize("shared", [0, 2])
@pytest.mark.parametrize("seq", [12, 1])
def test_moe_block_matches_jax(seq, shared):
    """S > 1 at capacity factor 0.5 (tokens are dropped) and S == 1 (the
    dense decode path), with and without 2 shared experts: the output and
    every metric; ``moe_dropped_frac`` exactly."""
    jcfg, cfg, jp, p, x = _setup(10 + seq + shared, (3, seq, 16), capacity_factor=0.5,
                                 num_shared_experts=shared)
    (y, m), (jy, jm) = _run_both(jcfg, cfg, jp, p, x)
    np.testing.assert_allclose(_np(y), np.asarray(jy), **TOL)
    assert sorted(m) == sorted(jm)
    for key in ("moe_aux_loss", "moe_z_loss", "moe_expert_frac_max"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]), err_msg=key, **TOL)
    assert float(m["moe_dropped_frac"]) == float(jm["moe_dropped_frac"])
    if seq > 1:
        assert float(m["moe_dropped_frac"]) > 0.1
    else:
        assert float(m["moe_dropped_frac"]) == 0.0


def test_capacity_matches_jax():
    for cf in (0.5, 1.25, 8.0):
        jcfg, cfg = small_cfgs(capacity_factor=cf)
        for seq in (1, 7, 12, 64):
            assert moe.capacity(cfg, seq) == jmoe.capacity(jcfg, seq)


def test_router_breaks_ties_as_jax_top_k():
    """An all-zero router ties every expert: ``jax.lax.top_k`` picks the
    lowest indices, and so must the port (its stable descending sort)."""
    jcfg, cfg, jp, p, x = _setup(3, (2, 6, 16), num_experts=6, experts_per_token=3)
    jp = dict(jp, router=jnp.zeros_like(jp["router"]))
    p = dict(p, router=torch.zeros_like(p["router"]))
    _, (gates, idx, _), _ = moe._router(p, cfg, torch.from_numpy(x))
    _, (jgates, jidx, _), _ = jmoe._router(jp, jcfg, jnp.asarray(x))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert idx[0, 0].tolist() == [0, 1, 2]
    np.testing.assert_allclose(_np(gates), np.asarray(jgates), **TOL)


def test_moe_gradient_matches_jax():
    jcfg, cfg, jp, p, x = _setup(21, (2, 8, 16), num_shared_experts=1)
    jg = jax.jit(jax.grad(
        lambda pp: jnp.sum(jmoe.moe_block(pp, jcfg, jnp.asarray(x))[0] ** 2)))(jp)
    paths, leaves = zip(*tree_leaves_with_path(p))
    xs = [t.clone().requires_grad_() for t in leaves]
    y, _ = moe.moe_block(tree_unflatten(paths, xs), cfg, torch.from_numpy(x))
    grads = torch.autograd.grad(torch.sum(y ** 2), xs)
    for path, g in zip(paths, grads):
        want = jg
        for key in path:
            want = want[key]
        np.testing.assert_allclose(_np(g), np.asarray(want), err_msg="/".join(path), **TOL)


# ----------------------------------------------------------------------
# Twins of tests/test_moe.py
# ----------------------------------------------------------------------
def loop_reference(p, cfg, x):
    """Token-by-token routing with the same capacity-drop rule (numpy)."""
    B, S, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    cap = moe.capacity(cfg, S)
    logits = np.einsum("bsd,de->bse", x, _np(p["router"]))
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    out = np.zeros((B, S, d), np.float32)
    silu = lambda t: t / (1 + np.exp(-t))
    for b in range(B):
        counts = np.zeros(e, np.int64)
        for s in range(S):
            pr = probs[b, s]
            top = np.argsort(-pr, kind="stable")[:k]
            gates = pr[top] / pr[top].sum()
            for j, ei in enumerate(top):
                if counts[ei] >= cap:
                    continue  # dropped
                counts[ei] += 1
                xi = x[b, s]
                h = silu(xi @ _np(p["wg"][ei])) * (xi @ _np(p["wi"][ei]))
                out[b, s] += gates[j] * (h @ _np(p["wo"][ei]))
    return out


def test_moe_matches_loop_reference():
    _, cfg, _, p, x = _setup(1, (2, 12, 16))
    y, metrics = moe.moe_block(p, cfg, torch.from_numpy(x))
    np.testing.assert_allclose(_np(y), loop_reference(p, cfg, x), **TOL)
    assert 0.0 <= float(metrics["moe_dropped_frac"]) < 1.0


def test_no_drops_at_high_capacity():
    _, cfg, _, p, x = _setup(2, (2, 16, 16), capacity_factor=8.0)
    _, metrics = moe.moe_block(p, cfg, torch.from_numpy(x))
    assert float(metrics["moe_dropped_frac"]) == 0.0


def test_shared_experts_add_dense_path():
    _, cfg, _, p, x = _setup(4, (1, 8, 16), num_shared_experts=2)
    y_with, _ = moe.moe_block(p, cfg, torch.from_numpy(x))
    p0 = dict(p, shared={k: torch.zeros_like(v) for k, v in p["shared"].items()})
    y_without, _ = moe.moe_block(p0, cfg, torch.from_numpy(x))
    assert float((y_with - y_without).abs().max()) > 1e-6


def test_aux_loss_balanced_vs_collapsed():
    """Load-balance loss ~1 for near-uniform routing, > 1.5 for a router
    collapsed onto expert 0; the collapsed router ties the other experts
    on purpose, so against JAX only its aux loss is compared."""
    jcfg, cfg, jp, p, x = _setup(6, (2, 64, 16))
    rng = np.random.default_rng(0)
    uni = (rng.standard_normal(tuple(p["router"].shape)) * 0.01).astype(np.float32)
    _, m_uni = moe.moe_block(dict(p, router=torch.from_numpy(uni)), cfg, torch.from_numpy(x))
    assert float(m_uni["moe_aux_loss"]) == pytest.approx(1.0, abs=0.15)
    col = np.zeros(tuple(p["router"].shape), np.float32)
    col[:, 0] = 20.0
    x_pos = np.abs(x) + 0.5
    _, m_col = moe.moe_block(dict(p, router=torch.from_numpy(col)), cfg, torch.from_numpy(x_pos))
    _, jm_col = jmoe.moe_block(dict(jp, router=jnp.asarray(col)), jcfg, jnp.asarray(x_pos))
    assert float(m_col["moe_aux_loss"]) > 1.5
    np.testing.assert_allclose(float(m_col["moe_aux_loss"]), float(jm_col["moe_aux_loss"]), **TOL)


@pytest.mark.slow
def test_moe_is_differentiable():
    _, cfg, _, p, x = _setup(8, (1, 8, 16))
    leaves = [t.requires_grad_() for _, t in tree_leaves_with_path(p)]
    y, _ = moe.moe_block(p, cfg, torch.from_numpy(x))
    grads = torch.autograd.grad(torch.sum(y ** 2), leaves)
    norms = [float(g.abs().max()) for g in grads]
    assert all(np.isfinite(norms)) and max(norms) > 0
