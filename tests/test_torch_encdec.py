"""The port's encoder-decoder model (``models.encdec``, seamless-m4t-large-v2)
against the JAX package's, on the CPU in fp32 at the reduced config (2
encoder + 2 decoder layers): ``encode``, ``loss`` (with its metrics) and
its gradient, ``prefill`` then ``decode_step`` (logits and every cache
leaf, the cross-attention keys and values included), decode against the
teacher-forced decoder, and the slice end to end (prefill plus 4 greedy
decode steps through both packages' step functions: identical token ids,
logits within tolerance); the full schema's parameter count; the
parameter and cache schemas; the cross cache's length; and
``launch.serve`` / ``launch.train`` on the CPU.

Parameters are made by the JAX package's ``init_params`` and carried across
with ``params_from_numpy``; ``src`` and the tokens are drawn with numpy from
fixed seeds.  The encoder runs over ``S_ENC`` frames, the decoder over
``S`` tokens (two different lengths, so a mix-up shows).  Tolerance
``atol=2e-4, rtol=1e-3`` (fp32, sums in another order; the reference's own
decode-vs-forward tolerance); gradients within a relative L2 of 1e-4 per
leaf.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.distributed import steps as jsteps
from repro.layers.params import count_params as jax_count_params
from repro.layers.params import init_params as jax_init_params
from repro.layers.params import param_axes as jax_param_axes
from repro.models import encdec as jencdec
from repro_torch.configs import get_config
from repro_torch.distributed import steps as tsteps
from repro_torch.distributed.steps import compute_grads
from repro_torch.layers.params import count_params, param_axes, params_from_numpy
from repro_torch.models import encdec
from repro_torch.models.registry import get_model

ARCH = "seamless-m4t-large-v2"
TOL = dict(atol=2e-4, rtol=1e-3)
GRAD_REL_L2 = 1e-4
B, S, S_ENC = 2, 24, 20


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


@functools.lru_cache(maxsize=None)
def _setup():
    """(jax cfg, port cfg, jax params, port params, numpy src, numpy tokens)."""
    jcfg, cfg = jax_get_config(ARCH).reduced(), get_config(ARCH).reduced()
    jp = jax_init_params(jencdec.schema(jcfg), jax.random.PRNGKey(0))
    rng = np.random.default_rng(2)
    src = rng.standard_normal((B, S_ENC, cfg.d_model)).astype(np.float32)
    tokens = rng.integers(0, cfg.vocab_size, size=(B, S + 1)).astype(np.int32)
    return jcfg, cfg, jp, params_from_numpy(jp), src, tokens


def _jax_cache(jcfg, max_len):
    return jax_init_params(jencdec.cache_schema(jcfg, B, max_len, enc_len=S_ENC),
                           jax.random.PRNGKey(0))


def _loss_batch(src, tokens):
    return {"src": src, "tokens": tokens[:, :S], "targets": tokens[:, 1:],
            "mask": (np.arange(S)[None] % 5 != 0).astype(np.int32).repeat(B, 0)}


def test_get_model_returns_encdec():
    assert get_model(get_config(ARCH)) is encdec


def test_encode_matches_jax():
    jcfg, cfg, jp, p, src, _ = _setup()
    got = encdec.encode(p, cfg, torch.from_numpy(src))
    want = jencdec.encode(jp, jcfg, jnp.asarray(src))
    assert got.shape == (B, S_ENC, cfg.d_model)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


def test_loss_and_metrics_match_jax():
    jcfg, cfg, jp, p, src, tokens = _setup()
    lb = _loss_batch(src, tokens)
    loss, metrics = encdec.loss(p, cfg, {k: torch.from_numpy(v) for k, v in lb.items()})
    jloss, jmetrics = jencdec.loss(jp, jcfg, {k: jnp.asarray(v) for k, v in lb.items()})
    assert sorted(metrics) == sorted(jmetrics)
    for key, val in jmetrics.items():
        np.testing.assert_allclose(float(metrics[key]), float(val), **TOL)
    np.testing.assert_allclose(float(loss), float(jloss), **TOL)


def test_loss_gradients_match_jax():
    jcfg, cfg, jp, p, src, tokens = _setup()
    lb = _loss_batch(src, tokens)
    _, grads = compute_grads(cfg, p, {k: torch.from_numpy(v) for k, v in lb.items()})
    jgrads = jax.grad(lambda q: jencdec.loss(q, jcfg, {k: jnp.asarray(v)
                                                       for k, v in lb.items()})[0])(jp)
    mine, theirs = _flat(grads), _flat(jgrads)
    assert sorted(mine) == sorted(theirs)
    for key, want in theirs.items():
        want = np.asarray(want, np.float64)
        err = np.linalg.norm(_np(mine[key]).astype(np.float64) - want)
        assert err <= GRAD_REL_L2 * max(np.linalg.norm(want), 1e-30), key


def test_prefill_and_decode_match_jax():
    """Logits and every cache leaf (``k``/``v`` and the cross ``xk``/``xv``)
    after prefill and after one decode step."""
    jcfg, cfg, jp, p, src, tokens = _setup()
    max_len = S + 4
    batch = {"src": src, "tokens": tokens[:, :S]}
    cache = tsteps.init_cache(cfg, B, max_len, "cpu", enc_len=S_ENC)
    logits, cache = encdec.prefill(p, cfg, {k: torch.from_numpy(v) for k, v in batch.items()},
                                   cache)
    jlogits, jcache = jencdec.prefill(jp, jcfg, {k: jnp.asarray(v) for k, v in batch.items()},
                                      _jax_cache(jcfg, max_len))
    assert logits.shape == (B, cfg.vocab_size)
    np.testing.assert_allclose(_np(logits), np.asarray(jlogits), **TOL)
    mine, theirs = _flat(cache), _flat(jcache)
    assert sorted(mine) == sorted(theirs) == ["layers/k", "layers/v", "layers/xk", "layers/xv"]
    for key, val in theirs.items():
        np.testing.assert_allclose(_np(mine[key]), np.asarray(val), **TOL)

    tok = tokens[:, S:S + 1]
    logits, cache = encdec.decode_step(p, cfg, torch.from_numpy(tok), cache, S)
    jlogits, jcache = jencdec.decode_step(jp, jcfg, jnp.asarray(tok), jcache, jnp.int32(S))
    np.testing.assert_allclose(_np(logits), np.asarray(jlogits), **TOL)
    for key, val in _flat(jcache).items():
        np.testing.assert_allclose(_np(_flat(cache)[key]), np.asarray(val), **TOL)


def test_decode_matches_the_teacher_forced_decoder():
    """prefill over S tokens then decode token S == the decoder over S + 1
    tokens (teacher forced, the same encoder output) at position S."""
    _, cfg, _, p, src, tokens = _setup()
    src_t, toks = torch.from_numpy(src), torch.from_numpy(tokens)
    full, _ = encdec._decoder(p, cfg, toks, encdec.encode(p, cfg, src_t), mode="train")
    cache = tsteps.init_cache(cfg, B, S + 4, "cpu", enc_len=S_ENC)
    _, cache = encdec.prefill(p, cfg, {"src": src_t, "tokens": toks[:, :S]}, cache)
    dec, _ = encdec.decode_step(p, cfg, toks[:, S:S + 1], cache, S)
    np.testing.assert_allclose(_np(dec), _np(full[:, S]), **TOL)


def test_serving_slice_matches_jax_end_to_end():
    """Prefill plus 4 greedy decode steps through the JAX package's step
    functions (``launch/serve``'s) and the port's: the same token ids at
    every step, logits within tolerance."""
    jcfg, cfg, jp, p, src, tokens = _setup()
    gen = 5
    max_len = S + gen
    batch = {"src": src, "tokens": tokens[:, :S]}
    jprefill, jdecode = jsteps.make_prefill_step(jcfg), jsteps.make_decode_step(jcfg)
    prefill, decode = tsteps.make_prefill_step(cfg), tsteps.make_decode_step(cfg)
    jlogits, jcache = jprefill(jp, {k: jnp.asarray(v) for k, v in batch.items()},
                               _jax_cache(jcfg, max_len))
    logits, cache = prefill(p, {k: torch.from_numpy(v) for k, v in batch.items()},
                            tsteps.init_cache(cfg, B, max_len, "cpu", enc_len=S_ENC))
    jtok = jnp.argmax(jlogits, -1)[:, None].astype(jnp.int32)
    tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
    for i in range(gen):
        np.testing.assert_allclose(_np(logits), np.asarray(jlogits), **TOL)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
        if i == gen - 1:
            break
        jlogits, jcache = jdecode(jp, jtok, jcache, jnp.int32(S + i))
        logits, cache = decode(p, tok, cache, S + i)
        jtok = jnp.argmax(jlogits, -1)[:, None].astype(jnp.int32)
        tok = torch.argmax(logits, -1)[:, None].to(torch.int32)


def test_full_schema_param_count():
    cfg = get_config(ARCH)
    n = count_params(encdec.schema(cfg))
    assert 1.2 <= n / 1e9 <= 2.4, f"{n / 1e9:.2f}B params out of [1.2, 2.4]"
    assert n == jax_count_params(jencdec.schema(jax_get_config(ARCH)))


@pytest.mark.parametrize("reduced", [False, True])
def test_schemas_and_axes_match_jax(reduced):
    """Parameter and cache schemas: the same leaves with the same shapes,
    logical axes, initialisers and dtypes; ``param_axes`` trees equal."""
    cfg = get_config(ARCH).reduced() if reduced else get_config(ARCH)
    jcfg = jax_get_config(ARCH).reduced() if reduced else jax_get_config(ARCH)
    assert _flat(param_axes(encdec.schema(cfg))) == _flat(
        jax.tree_util.tree_map(lambda s: s.axes, jencdec.schema(jcfg),
                               is_leaf=lambda s: hasattr(s, "axes")))
    for mine, theirs in ((encdec.schema(cfg), jencdec.schema(jcfg)),
                         (encdec.cache_schema(cfg, 3, 40, enc_len=17),
                          jencdec.cache_schema(jcfg, 3, 40, enc_len=17))):
        mine, theirs = _flat(mine), _flat(theirs)
        assert sorted(mine) == sorted(theirs)
        for key, spec in theirs.items():
            got = mine[key]
            assert (got.shape, got.axes, got.init, got.scale) == \
                (spec.shape, spec.axes, spec.init, spec.scale), key
            assert got.dtype == (None if spec.dtype is None else str(spec.dtype)), key
    assert _flat(param_axes(encdec.cache_schema(cfg, 3, 40, enc_len=17))) == _flat(
        jax_param_axes(jencdec.cache_schema(jcfg, 3, 40, enc_len=17)))


def test_cross_cache_holds_exactly_the_src_length():
    """A cache sized to another encoder length is refused at prefill (it
    would leave zero rows that decode's softmax weighs); an encdec cache
    needs ``enc_len``, which no other family takes."""
    _, cfg, _, p, src, tokens = _setup()
    batch = {"src": torch.from_numpy(src), "tokens": torch.from_numpy(tokens[:, :S])}
    for enc_len in (S_ENC + 4, S_ENC - 1):
        cache = tsteps.init_cache(cfg, B, S + 4, "cpu", enc_len=enc_len)
        with pytest.raises(ValueError, match=f"holds {enc_len} encoder positions but src has "
                                             f"{S_ENC}"):
            encdec.prefill(p, cfg, batch, cache)
    cache = tsteps.init_cache(cfg, B, S + 4, "cpu", enc_len=S_ENC)
    encdec.prefill(p, cfg, batch, cache)
    assert cache["layers"]["xk"].shape[2] == S_ENC and cache["layers"]["xk"].abs().amin(
        dim=(0, 1, 3, 4)).gt(0).all()  # every encoder row written
    with pytest.raises(ValueError, match="needs enc_len"):
        tsteps.init_cache(cfg, B, S + 4, "cpu")
    with pytest.raises(ValueError, match="encdec family only"):
        tsteps.init_cache(get_config("qwen2-0.5b").reduced(), B, S + 4, "cpu", enc_len=S_ENC)


def test_cache_axes_and_shapes_shape_the_cross_cache_at_max_len():
    cfg = get_config(ARCH).reduced()
    axes, shapes = tsteps.cache_axes_and_shapes(cfg, 3, 40)
    jaxes, jshapes = jsteps.cache_axes_and_shapes(jax_get_config(ARCH).reduced(), 3, 40)
    assert _flat(axes) == _flat(jaxes)
    for key, want in _flat(jshapes).items():
        got = _flat(shapes)[key]
        assert got.device.type == "meta"
        assert (tuple(got.shape), str(got.dtype).removeprefix("torch.")) == \
            (tuple(want.shape), str(want.dtype)), key


def test_serve_cli_runs(capsys):
    from repro_torch.launch.serve import main

    assert main(["--arch", ARCH, "--batch", "2", "--prompt-len", "16", "--gen", "4",
                 "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert f"arch={ARCH} batch=2 prompt=16 gen=4" in out and "sample token ids:" in out


def test_train_cli_runs(tmp_path, capsys):
    from repro_torch.launch.train import main

    rc = main(["--arch", ARCH, "--steps", "8", "--batch", "2", "--seq", "32",
               "--ckpt-dir", str(tmp_path), "--checkpoint-every", "0", "--log-every", "4",
               "--device", "cpu"])
    assert rc == 0
    out = capsys.readouterr().out
    assert f"arch={ARCH} reduced=True devices=1" in out and "done: loss" in out
