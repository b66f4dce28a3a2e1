"""The port's LM serving slice against the JAX package's, on the CPU in
fp32 at reduced configs: ``models.lm`` forward / loss / prefill /
decode_step for qwen2-0.5b (QKV bias, tied embeddings), qwen3-1.7b
(``qk_norm``), qwen3-8b (untied unembedding), internvl2-1b (frontend
prefix) and a ``first_k_dense`` prologue; the slice end to end (prefill
plus 4 greedy decode steps through both packages' step functions:
identical token ids, logits within tolerance); the configs field for field;
the full schemas' parameter counts, axes and cache trees for every ported
family; ``launch.serve.main`` on the CPU for every ported family; and the
error of the family still to port.

Parameters are made by the JAX package's ``init_params`` and carried across
with ``params_from_numpy``; tokens and frontend embeddings are drawn with
numpy from fixed seeds.  Tolerance ``atol=2e-4, rtol=1e-3`` (fp32, sums in
another order; the reference's own decode-vs-forward tolerance).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import LM_ARCH_IDS as JAX_LM_ARCH_IDS
from repro.configs import get_config as jax_get_config
from repro.distributed import steps as jsteps
from repro.layers.params import count_params as jax_count_params
from repro.layers.params import init_params as jax_init_params
from repro.models.registry import get_model as jax_get_model
from repro_torch.config import ModelConfig, TrainConfig
from repro_torch.configs import ARCH_IDS, LM_ARCH_IDS, get_config
from repro_torch.distributed import steps as tsteps
from repro_torch.layers.params import (ParamSpec, count_params, init_params, param_axes,
                                       params_from_numpy)
from repro_torch.models import lm
from repro_torch.models.registry import get_model

TOL = dict(atol=2e-4, rtol=1e-3)
B, S = 2, 24
PORTED = {"dense", "vlm", "moe", "ssm", "hybrid"}

# published sizes (billions) the full schemas must land near — the
# reference's ranges (tests/test_models_smoke.py)
EXPECTED_PARAMS_B = {
    "arctic-480b": (440, 500),
    "deepseek-v2-236b": (225, 245),
    "qwen3-14b": (13.5, 15.5),
    "qwen3-8b": (7.6, 8.6),
    "qwen2-0.5b": (0.4, 0.55),
    "qwen3-1.7b": (1.5, 2.0),
    "internvl2-1b": (0.4, 0.6),  # LM backbone only (stub ViT)
    "zamba2-2.7b": (2.1, 2.9),
    "mamba2-130m": (0.1, 0.16),
}
# (arch, overrides of reduced()): bias + tied, qk_norm + tied, untied, vlm
# prefix, a dense prologue layer
PARITY = {
    "qwen2-0.5b": ("qwen2-0.5b", {}),
    "qwen3-1.7b": ("qwen3-1.7b", {}),
    "qwen3-8b": ("qwen3-8b", {}),
    "internvl2-1b": ("internvl2-1b", {}),
    "qwen2-0.5b-prologue": ("qwen2-0.5b", {"first_k_dense": 1}),
}


def _np(t):
    return t.detach().cpu().float().numpy()


@functools.lru_cache(maxsize=None)
def _setup(name):
    """(jax cfg, port cfg, jax params, port params, numpy batch) for a
    PARITY entry; non-zero QKV biases check the bias path."""
    arch, overrides = PARITY[name]
    jcfg = jax_get_config(arch).reduced(**overrides)
    cfg = get_config(arch).reduced(**overrides)
    jp = jax_init_params(jax_get_model(jcfg).schema(jcfg), jax.random.PRNGKey(0))
    if jcfg.qkv_bias:
        rng = np.random.default_rng(1)
        blocks = dict(jp["blocks"])
        blocks["attn"] = {k: (jnp.asarray(0.1 * rng.standard_normal(v.shape).astype(np.float32))
                              if k in ("bq", "bk", "bv") else v)
                          for k, v in blocks["attn"].items()}
        jp = dict(jp, blocks=blocks)
    rng = np.random.default_rng(2)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, size=(B, S + 1)).astype(np.int32)}
    if cfg.family == "vlm":
        batch["frontend"] = rng.standard_normal(
            (B, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
    return jcfg, cfg, jp, params_from_numpy(jp), batch


def _extra(cfg):
    return cfg.frontend_tokens if cfg.family == "vlm" else 0


def _jax_cache(jcfg, max_len):
    return jax_init_params(jax_get_model(jcfg).cache_schema(jcfg, B, max_len),
                           jax.random.PRNGKey(0))


@pytest.mark.parametrize("name", list(PARITY))
def test_forward_and_loss_match_jax(name):
    jcfg, cfg, jp, p, batch = _setup(name)
    toks = batch["tokens"][:, :S]
    front = batch.get("frontend")
    logits, cache, _ = lm.forward(p, cfg, torch.from_numpy(toks),
                                  frontend=None if front is None else torch.from_numpy(front))
    jlogits, _, _ = jax_get_model(jcfg).forward(jp, jcfg, jnp.asarray(toks),
                                                frontend=None if front is None else
                                                jnp.asarray(front))
    assert cache is None
    assert logits.shape == (B, S + _extra(cfg), cfg.vocab_size)
    np.testing.assert_allclose(_np(logits), np.asarray(jlogits), **TOL)

    lb = {"tokens": toks, "targets": batch["tokens"][:, 1:],
          "mask": (np.arange(S)[None] % 5 != 0).astype(np.int32).repeat(B, 0)}
    if front is not None:
        lb["frontend"] = front
    loss, metrics = lm.loss(p, cfg, {k: torch.from_numpy(v) for k, v in lb.items()})
    jloss, jmetrics = jax_get_model(jcfg).loss(jp, jcfg, {k: jnp.asarray(v) for k, v in lb.items()})
    np.testing.assert_allclose(float(loss), float(jloss), **TOL)
    np.testing.assert_allclose(float(metrics["tokens"]), float(jmetrics["tokens"]))


@pytest.mark.parametrize("name", list(PARITY))
def test_prefill_and_decode_match_jax(name):
    jcfg, cfg, jp, p, batch = _setup(name)
    model, jmodel = get_model(cfg), jax_get_model(jcfg)
    max_len = S + _extra(cfg) + 4
    pf = {k: (v[:, :S] if k == "tokens" else v) for k, v in batch.items()}
    cache = tsteps.init_cache(cfg, B, max_len)
    logits, cache = model.prefill(p, cfg, {k: torch.from_numpy(v) for k, v in pf.items()}, cache)
    jlogits, jcache = jmodel.prefill(jp, jcfg, {k: jnp.asarray(v) for k, v in pf.items()},
                                     _jax_cache(jcfg, max_len))
    assert logits.shape == (B, cfg.vocab_size)
    np.testing.assert_allclose(_np(logits), np.asarray(jlogits), **TOL)
    flat = lambda c: {f"{k}/{kk}": vv for k, v in c.items() for kk, vv in v.items()}
    assert sorted(flat(cache)) == sorted(flat(jcache))
    for key, val in flat(jcache).items():
        np.testing.assert_allclose(_np(flat(cache)[key]), np.asarray(val), **TOL)

    pos = S + _extra(cfg)
    tok = batch["tokens"][:, S:S + 1]
    logits, cache = model.decode_step(p, cfg, torch.from_numpy(tok), cache, pos)
    jlogits, jcache = jmodel.decode_step(jp, jcfg, jnp.asarray(tok), jcache, jnp.int32(pos))
    np.testing.assert_allclose(_np(logits), np.asarray(jlogits), **TOL)
    for key, val in flat(jcache).items():
        np.testing.assert_allclose(_np(flat(cache)[key]), np.asarray(val), **TOL)


@pytest.mark.parametrize("name", ["qwen2-0.5b", "internvl2-1b"])
def test_decode_matches_prefill_logits_lm(name):
    """prefill over S tokens then decode token S == forward over S+1 (the
    twin of tests/test_models_smoke.py's; under vlm the frontend tokens
    come first, so decode runs at S + frontend_tokens)."""
    _, cfg, _, p, batch = _setup(name)
    toks = torch.from_numpy(batch["tokens"])
    front = batch.get("frontend")
    front = None if front is None else torch.from_numpy(front)
    logits_full, _, _ = lm.forward(p, cfg, toks, frontend=front, mode="train")
    pos = S + _extra(cfg)
    cache = tsteps.init_cache(cfg, B, pos + 4)
    pf = {"tokens": toks[:, :S]} if front is None else {"tokens": toks[:, :S], "frontend": front}
    _, cache = lm.prefill(p, cfg, pf, cache)
    logits_dec, _ = lm.decode_step(p, cfg, toks[:, S:S + 1], cache, pos)
    np.testing.assert_allclose(_np(logits_dec), _np(logits_full[:, pos]), **TOL)


@pytest.mark.parametrize("name", ["qwen2-0.5b", "qwen3-1.7b", "internvl2-1b"])
def test_serving_slice_matches_jax_end_to_end(name):
    """Prefill plus 4 greedy decode steps through the JAX package's step
    functions (``launch/serve``'s) and the port's: the same token ids at
    every step, logits within tolerance."""
    jcfg, cfg, jp, p, batch = _setup(name)
    gen = 5
    extra = _extra(cfg)
    max_len = S + extra + gen
    jprefill, jdecode = jsteps.make_prefill_step(jcfg), jsteps.make_decode_step(jcfg)
    prefill, decode = tsteps.make_prefill_step(cfg), tsteps.make_decode_step(cfg)
    pf = {k: (v[:, :S] if k == "tokens" else v) for k, v in batch.items()}

    jlogits, jcache = jprefill(jp, {k: jnp.asarray(v) for k, v in pf.items()},
                               _jax_cache(jcfg, max_len))
    logits, cache = prefill(p, {k: torch.from_numpy(v) for k, v in pf.items()},
                            tsteps.init_cache(cfg, B, max_len))
    jtok = jnp.argmax(jlogits, -1)[:, None].astype(jnp.int32)
    tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
    for i in range(gen):
        np.testing.assert_allclose(_np(logits), np.asarray(jlogits), **TOL)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
        if i == gen - 1:
            break
        jlogits, jcache = jdecode(jp, jtok, jcache, jnp.int32(S + extra + i))
        logits, cache = decode(p, tok, cache, S + extra + i)
        jtok = jnp.argmax(jlogits, -1)[:, None].astype(jnp.int32)
        tok = torch.argmax(logits, -1)[:, None].to(torch.int32)


def test_step_functions_record_no_autograd_graph():
    _, cfg, _, p, batch = _setup("qwen2-0.5b")
    p = {k: v for k, v in p.items()}
    p["final_norm"] = p["final_norm"].clone().requires_grad_()
    cache = tsteps.init_cache(cfg, B, S + 2)
    logits, _ = tsteps.make_prefill_step(cfg)(
        p, {"tokens": torch.from_numpy(batch["tokens"][:, :S])}, cache)
    assert not logits.requires_grad


@pytest.mark.parametrize("arch", list(EXPECTED_PARAMS_B))
def test_full_schema_param_count(arch):
    cfg = get_config(arch)
    n = count_params(get_model(cfg).schema(cfg))
    lo, hi = EXPECTED_PARAMS_B[arch]
    assert lo <= n / 1e9 <= hi, f"{arch}: {n / 1e9:.2f}B params out of [{lo}, {hi}]"
    jcfg = jax_get_config(arch)
    assert n == jax_count_params(jax_get_model(jcfg).schema(jcfg))


def _spec_leaves(schema, prefix=""):
    """{path: ParamSpec} of a schema (the port's or the JAX package's)."""
    out = {}
    for key in sorted(schema):
        if isinstance(schema[key], dict):
            out.update(_spec_leaves(schema[key], f"{prefix}{key}/"))
        else:
            out[prefix + key] = schema[key]
    return out


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "internvl2-1b", "arctic-480b",
                                  "deepseek-v2-236b", "mamba2-130m", "zamba2-2.7b"])
def test_schemas_and_axes_match_jax(arch):
    """Parameter and cache schemas, full and reduced: the same leaves with
    the same shapes, logical axes, initialisers and dtypes (the cache trees:
    ``k``/``v``, MLA's ``ckv``, Mamba's ``conv``/``ssm``, Zamba's
    ``shared_kv``)."""
    for reduced in (False, True):
        cfg = get_config(arch).reduced() if reduced else get_config(arch)
        jcfg = jax_get_config(arch).reduced() if reduced else jax_get_config(arch)
        model, jmodel = get_model(cfg), jax_get_model(jcfg)
        s, js = model.schema(cfg), jmodel.schema(jcfg)
        assert jax.tree_util.tree_leaves(param_axes(s), is_leaf=lambda x: isinstance(x, tuple)) \
            == jax.tree_util.tree_leaves(jax.tree_util.tree_map(
                lambda x: x.axes, js, is_leaf=lambda x: hasattr(x, "axes")),
                is_leaf=lambda x: isinstance(x, tuple))
        for schemas in ((s, js), (model.cache_schema(cfg, 3, 40),
                                  jmodel.cache_schema(jcfg, 3, 40))):
            mine, theirs = (_spec_leaves(t) for t in schemas)
            assert sorted(mine) == sorted(theirs)
            for key, spec in theirs.items():
                got = mine[key]
                assert (got.shape, got.axes, got.init, got.scale) == \
                    (spec.shape, spec.axes, spec.init, spec.scale), key
                assert got.dtype == (None if spec.dtype is None else str(spec.dtype)), key


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_configs_match_jax_field_for_field(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    if arch in LM_ARCH_IDS:
        assert dataclasses.asdict(cfg.reduced()) == dataclasses.asdict(jcfg.reduced())
        assert cfg.activation_dtype == getattr(torch, str(jcfg.activation_dtype))
        assert cfg.weight_dtype == getattr(torch, str(jcfg.weight_dtype))
    assert LM_ARCH_IDS == JAX_LM_ARCH_IDS


def test_train_config_matches_jax():
    from repro.config import TrainConfig as JaxTrainConfig

    assert dataclasses.asdict(TrainConfig()) == dataclasses.asdict(JaxTrainConfig())
    assert [f.name for f in dataclasses.fields(ModelConfig)] == [
        f.name for f in dataclasses.fields(type(jax_get_config("qwen2-0.5b")))]


@pytest.mark.parametrize("arch", [a for a in LM_ARCH_IDS if get_config(a).family not in PORTED])
def test_get_model_on_an_unported_family_names_its_roadmap_item(arch):
    with pytest.raises(NotImplementedError, match=r"ROADMAP queue 1, item 14f"):
        get_model(get_config(arch))


def test_get_model_unknown_family():
    with pytest.raises(ValueError, match="unknown family"):
        get_model(dataclasses.replace(get_config("qwen2-0.5b"), family="diffusion"))


def test_init_params_seeded_and_shaped():
    cfg = get_config("qwen3-1.7b").reduced()
    s = lm.schema(cfg)
    a = init_params(s, torch.Generator().manual_seed(3))
    b = init_params(s, torch.Generator().manual_seed(3))
    assert torch.equal(a["blocks"]["mlp"]["wi"], b["blocks"]["mlp"]["wi"])
    assert a["blocks"]["attn"]["q_norm"].eq(1).all()
    assert a["blocks"]["mlp"]["wi"].shape == (cfg.num_layers, cfg.d_model, cfg.d_ff)
    # fan-in scale over the contracting dims, the layer dim excluded
    std = float(a["blocks"]["attn"]["wo"].std())
    assert std == pytest.approx(1 / np.sqrt(cfg.num_heads * cfg.head_dim), rel=0.1)
    assert float(a["embed"].std()) == pytest.approx(0.02, rel=0.1)
    half = init_params(s, torch.Generator().manual_seed(3), dtype="bfloat16")
    assert half["embed"].dtype == torch.bfloat16
    cache = tsteps.init_cache(dataclasses.replace(cfg, dtype="bfloat16"), 2, 8)
    assert cache["layers"]["k"].dtype == torch.bfloat16 and not cache["layers"]["k"].any()


def test_params_from_numpy_keeps_or_casts_dtypes():
    tree = {"a": np.ones((2, 3), np.float32),
            "b": {"c": jnp.full((4,), 1.5, jnp.bfloat16), "d": np.arange(3, dtype=np.int32)}}
    out = params_from_numpy(tree)
    assert out["a"].dtype == torch.float32 and out["b"]["d"].dtype == torch.int32
    assert out["b"]["c"].dtype == torch.bfloat16 and out["b"]["c"].eq(1.5).all()
    cast = params_from_numpy(tree, dtype=torch.bfloat16)
    assert all(t.dtype == torch.bfloat16 for t in (cast["a"], cast["b"]["c"], cast["b"]["d"]))
    with pytest.raises(ValueError, match="rank mismatch"):
        ParamSpec((2, 3), ("embed",))


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "internvl2-1b", "arctic-480b", "deepseek-v2-236b",
                                  "mamba2-130m", "zamba2-2.7b"])
def test_lm_serve_cli_runs(arch, capsys):
    from repro_torch.launch.serve import main

    rc = main(["--arch", arch, "--batch", "2", "--prompt-len", "16", "--gen", "4",
               "--device", "cpu"])
    assert rc == 0
    out = capsys.readouterr().out
    assert f"arch={arch} batch=2 prompt=16 gen=4" in out
    assert "sample token ids:" in out


def test_lm_serve_cli_needs_a_card_for_cuda(monkeypatch):
    from repro_torch.launch.serve import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--arch", "qwen2-0.5b", "--gen", "2"])
