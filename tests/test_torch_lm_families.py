"""The port's MoE / MLA (``models.lm``), Mamba2 (``models.mamba_lm``) and
Zamba2 (``models.zamba``) language models against the JAX package's, on
the CPU in fp32 at the reduced configs of arctic-480b (MoE top-2 with a
dense residual), deepseek-v2-236b (MLA, MoE with shared experts, a dense
``first_k_dense`` prologue), mamba2-130m and zamba2-2.7b (Mamba2 segments
and two shared attention blocks): forward and loss (the total loss with
the router's aux and z terms, and the MoE metrics), prefill then decode
(logits and every cache leaf), decode against ``forward`` over one more
token, prefill plus greedy decode through both packages' step functions,
the loss gradient against ``jax.grad`` (deepseek-v2 and mamba2), the
router's gradient under remat, and the twins of
``tests/test_models_smoke.py::test_train_step_decreases_loss`` for mamba2
and zamba2.

Parameters are drawn with numpy from a fixed seed after the JAX package's
schema (its initialisers' distributions: fan-in scaled normals, ones,
zeros) and carried across with ``params_from_numpy``; tokens are drawn
with numpy too.
Tolerance ``atol=2e-4, rtol=1e-3`` (fp32, sums in another order; the
reference's own decode-vs-forward tolerance); gradients within a relative
L2 of 1e-4 per leaf.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.distributed import steps as jsteps
from repro.layers.params import init_params as jax_init_params
from repro.models.registry import get_model as jax_get_model
from repro_torch.config import TrainConfig
from repro_torch.configs import get_config
from repro_torch.data.synthetic import lm_batch
from repro_torch.distributed import steps as tsteps
from repro_torch.distributed.steps import compute_grads, init_train_state, make_train_step
from repro_torch.layers.params import params_from_numpy, tree_leaves_with_path
from repro_torch.models import lm, mamba_lm, zamba
from repro_torch.models.registry import get_model

TOL = dict(atol=2e-4, rtol=1e-3)
GRAD_REL_L2 = 1e-4
B, S = 2, 24
ARCHS = ["arctic-480b", "deepseek-v2-236b", "mamba2-130m", "zamba2-2.7b"]
MODULES = {"arctic-480b": lm, "deepseek-v2-236b": lm, "mamba2-130m": mamba_lm,
           "zamba2-2.7b": zamba}


def _np(t):
    return t.detach().cpu().float().numpy()


def _flat(tree, prefix=""):
    """{path: leaf} of a nested dict (the port's or the JAX package's)."""
    out = {}
    for key in sorted(tree):
        if isinstance(tree[key], dict):
            out.update(_flat(tree[key], f"{prefix}{key}/"))
        else:
            out[prefix + key] = tree[key]
    return out


def _numpy_params(schema, rng):
    """A parameter tree for a JAX ParamSpec schema, drawn with numpy: each
    leaf as the JAX package's initialiser shapes and scales it.  The
    schema zeroes ``dt_bias`` and ``A_log``; seeded ones check their
    paths."""
    out = {}
    for key in sorted(schema):
        spec = schema[key]
        if isinstance(spec, dict):
            out[key] = _numpy_params(spec, rng)
        elif key in ("dt_bias", "A_log"):
            out[key] = (0.5 * rng.standard_normal(spec.shape)).astype(np.float32)
        elif spec.init in ("zeros", "ones"):
            out[key] = np.full(spec.shape, float(spec.init == "ones"), np.float32)
        else:
            fan_in = int(np.prod([d for d, ax in zip(spec.shape[:-1], spec.axes[:-1])
                                  if ax not in ("layers", "expert")])) or 1
            scale = spec.scale if spec.scale is not None else (
                1.0 if spec.init == "embed" else 1.0 / np.sqrt(fan_in))
            out[key] = (rng.standard_normal(spec.shape) * scale).astype(np.float32)
    return out


@functools.lru_cache(maxsize=None)
def _setup(arch):
    """(jax cfg, port cfg, jax params, port params, numpy tokens (B, S+1))."""
    jcfg, cfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    npp = _numpy_params(jax_get_model(jcfg).schema(jcfg), np.random.default_rng(0))
    jp = jax.tree_util.tree_map(jnp.asarray, npp)
    tokens = np.random.default_rng(2).integers(0, cfg.vocab_size, size=(B, S + 1)).astype(
        np.int32)
    return jcfg, cfg, jp, params_from_numpy(npp), tokens


def _jax_cache(jcfg, max_len):
    return jax_init_params(jax_get_model(jcfg).cache_schema(jcfg, B, max_len),
                           jax.random.PRNGKey(0))


def _loss_batch(tokens):
    return {"tokens": tokens[:, :S], "targets": tokens[:, 1:],
            "mask": (np.arange(S)[None] % 5 != 0).astype(np.int32).repeat(B, 0)}


def test_get_model_maps_the_families():
    for arch in ARCHS:
        assert get_model(get_config(arch)) is MODULES[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_jax(arch):
    jcfg, cfg, jp, p, tokens = _setup(arch)
    model, jmodel = get_model(cfg), jax_get_model(jcfg)
    logits, cache, metrics = model.forward(p, cfg, torch.from_numpy(tokens[:, :S]))
    jlogits, _, jmetrics = jmodel.forward(jp, jcfg, jnp.asarray(tokens[:, :S]))
    assert cache is None
    assert logits.shape == (B, S, cfg.vocab_size)
    np.testing.assert_allclose(_np(logits), np.asarray(jlogits), **TOL)
    assert sorted(metrics) == sorted(jmetrics)
    for key, val in jmetrics.items():
        np.testing.assert_allclose(float(metrics[key]), float(val), err_msg=key, **TOL)

    lb = _loss_batch(tokens)
    loss, metrics = model.loss(p, cfg, {k: torch.from_numpy(v) for k, v in lb.items()})
    jloss, jmetrics = jmodel.loss(jp, jcfg, {k: jnp.asarray(v) for k, v in lb.items()})
    np.testing.assert_allclose(float(loss), float(jloss), **TOL)
    np.testing.assert_allclose(float(metrics["total_loss"]), float(jmetrics["total_loss"]), **TOL)
    if cfg.is_moe:
        # the router's terms are in the total: it exceeds the cross-entropy
        assert float(loss) > float(metrics["loss"])


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch):
    """Prefill S tokens, then decode token S: logits and every cache leaf
    (the port's written in place, into the tree it was given)."""
    jcfg, cfg, jp, p, tokens = _setup(arch)
    model, jmodel = get_model(cfg), jax_get_model(jcfg)
    max_len = S + 4
    cache = tsteps.init_cache(cfg, B, max_len)
    jcache = _jax_cache(jcfg, max_len)
    assert {k: tuple(v.shape) for k, v in _flat(cache).items()} == \
        {k: tuple(v.shape) for k, v in _flat(jcache).items()}
    logits, out = model.prefill(p, cfg, {"tokens": torch.from_numpy(tokens[:, :S])}, cache)
    jlogits, jcache = jmodel.prefill(jp, jcfg, {"tokens": jnp.asarray(tokens[:, :S])}, jcache)
    assert out is cache and logits.shape == (B, cfg.vocab_size)
    np.testing.assert_allclose(_np(logits), np.asarray(jlogits), **TOL)
    for key, val in _flat(jcache).items():
        np.testing.assert_allclose(_np(_flat(cache)[key]), np.asarray(val), err_msg=key, **TOL)

    tok = tokens[:, S:S + 1]
    logits, out = model.decode_step(p, cfg, torch.from_numpy(tok), cache, S)
    jlogits, jcache = jmodel.decode_step(jp, jcfg, jnp.asarray(tok), jcache, jnp.int32(S))
    assert out is cache
    np.testing.assert_allclose(_np(logits), np.asarray(jlogits), **TOL)
    for key, val in _flat(jcache).items():
        np.testing.assert_allclose(_np(_flat(cache)[key]), np.asarray(val), err_msg=key, **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_prefill_logits(arch):
    """prefill over S tokens then decode token S == forward over S + 1 (the
    twin of tests/test_models_smoke.py's, for these families).  Decode's
    MoE path is dropless, so the MoE configs run at a capacity factor of E
    (capacity S·k: the forward drops nothing either)."""
    _, cfg, _, p, tokens = _setup(arch)
    if cfg.is_moe:
        cfg = get_config(arch).reduced(capacity_factor=float(cfg.num_experts))
    model = get_model(cfg)
    toks = torch.from_numpy(tokens)
    logits_full, _, _ = model.forward(p, cfg, toks, mode="train")
    cache = tsteps.init_cache(cfg, B, S + 4)
    _, cache = model.prefill(p, cfg, {"tokens": toks[:, :S]}, cache)
    logits_dec, _ = model.decode_step(p, cfg, toks[:, S:S + 1], cache, S)
    np.testing.assert_allclose(_np(logits_dec), _np(logits_full[:, S]), **TOL)


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "zamba2-2.7b"])
def test_serving_slice_matches_jax_end_to_end(arch):
    """Prefill plus 3 greedy decode steps through both packages' step
    functions: the same token ids at every step, logits within tolerance."""
    jcfg, cfg, jp, p, tokens = _setup(arch)
    gen, max_len = 4, S + 4
    jprefill, jdecode = jsteps.make_prefill_step(jcfg), jsteps.make_decode_step(jcfg)
    prefill, decode = tsteps.make_prefill_step(cfg), tsteps.make_decode_step(cfg)
    jlogits, jcache = jprefill(jp, {"tokens": jnp.asarray(tokens[:, :S])},
                               _jax_cache(jcfg, max_len))
    logits, cache = prefill(p, {"tokens": torch.from_numpy(tokens[:, :S])},
                            tsteps.init_cache(cfg, B, max_len))
    for i in range(gen):
        np.testing.assert_allclose(_np(logits), np.asarray(jlogits), **TOL)
        jtok = jnp.argmax(jlogits, -1)[:, None].astype(jnp.int32)
        tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
        if i < gen - 1:
            jlogits, jcache = jdecode(jp, jtok, jcache, jnp.int32(S + i))
            logits, cache = decode(p, tok, cache, S + i)


def _rel_l2(got, want):
    den = float(np.linalg.norm(want))
    num = float(np.linalg.norm(got - want))
    return num / den if den else num


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "mamba2-130m"])
def test_loss_gradients_match_jax(arch):
    """``steps.compute_grads`` against ``jax.grad`` of the JAX package's
    ``loss`` (the router's terms included), every leaf within a relative
    L2 of 1e-4."""
    jcfg, cfg, jp, p, tokens = _setup(arch)
    lb = _loss_batch(tokens)
    jmodel = jax_get_model(jcfg)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda pp: jmodel.loss(pp, jcfg, {k: jnp.asarray(v) for k, v in lb.items()})[0]))(jp)
    metrics, grads = compute_grads(cfg, p, {k: torch.from_numpy(v) for k, v in lb.items()})
    np.testing.assert_allclose(float(metrics["total_loss"]), float(jloss), **TOL)
    jflat = _flat(jgrads)
    flat = _flat(grads)
    assert sorted(flat) == sorted(jflat)
    worst = {key: _rel_l2(_np(g), np.asarray(jflat[key])) for key, g in flat.items()}
    assert max(worst.values()) <= GRAD_REL_L2, sorted(worst.items(), key=lambda kv: -kv[1])[:3]
    if cfg.is_moe:
        assert float(np.abs(_np(flat["blocks/moe/router"])).max()) > 0


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_keeps_the_router_gradient(remat):
    """A checkpointed block returns its MoE metrics with their graph: the
    aux terms reach the router's gradient, which equals the one without
    remat."""
    _, cfg, _, p, tokens = _setup("deepseek-v2-236b")
    lb = {k: torch.from_numpy(v) for k, v in _loss_batch(tokens).items()}
    _, grads = compute_grads(cfg, p, lb)
    cfg_r = get_config("deepseek-v2-236b").reduced(remat=remat)
    _, grads_r = compute_grads(cfg_r, p, lb)
    for (path, g), (_, g_r) in zip(tree_leaves_with_path(grads), tree_leaves_with_path(grads_r)):
        torch.testing.assert_close(g_r, g, atol=1e-6, rtol=1e-5,
                                   msg=lambda m: f"{'/'.join(path)}: {m}")
    # the aux loss alone moves the router: its weight scaled up, the
    # router's gradient changes under remat as without it
    cfg_aux = get_config("deepseek-v2-236b").reduced(remat=remat, router_aux_weight=10.0)
    _, grads_aux = compute_grads(cfg_aux, p, lb)
    assert not torch.allclose(grads_aux["blocks"]["moe"]["router"],
                              grads_r["blocks"]["moe"]["router"])


@pytest.mark.slow
@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-2.7b"])
def test_train_step_decreases_loss(arch):
    """Twin of tests/test_models_smoke.py::test_train_step_decreases_loss:
    12 steps on one fixed batch bring the loss below 0.9x its first."""
    cfg = get_config(arch).reduced(remat="none")
    tcfg = TrainConfig(learning_rate=3e-3, warmup_steps=2, total_steps=30)
    state = init_train_state(cfg, tcfg, torch.Generator().manual_seed(0), "cpu")
    step = make_train_step(cfg, tcfg)
    batch = lm_batch(cfg, 1, 2, 64)
    losses = []
    for _ in range(12):
        state, metrics = step(state, batch)
        losses.append(float(metrics["total_loss"]))
    assert losses[-1] < losses[0] * 0.9, losses
