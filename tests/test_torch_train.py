"""The port's LM training slice against the JAX package's, on the CPU in
fp32 at reduced configs: ``optim.adamw`` (twins of ``tests/test_optim.py``
and port-vs-JAX updates over several steps, fp32 and bf16 moments, the
schedule at every step); ``distributed.steps.make_train_step`` (loss
gradients, then the state after two AdamW steps, port vs JAX for
qwen2-0.5b, qwen3-1.7b and internvl2-1b; microbatches 1 and 2; remat
none/full/dots giving the same gradients; the twin of
``test_train_step_decreases_loss``); ``runtime.checkpoint`` (twins of the
five checkpoint tests of ``tests/test_runtime.py``, and a checkpoint
written by the JAX package restored into the port's tree); and
``runtime.resilience.resilient_train_loop`` (the twin of
``test_resilient_loop_survives_injected_failures``, and a failure before
the first checkpoint restarting from the initial parameters).

Parameters are made by the JAX package's ``init_params`` and carried across
with ``params_from_numpy``; batches and gradients are drawn with numpy from
fixed seeds.  Tolerance ``atol=2e-4, rtol=1e-3`` (fp32, sums in another
order) unless a test states otherwise.  The JAX side is jitted.
"""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import TrainConfig as JaxTrainConfig
from repro.configs import get_config as jax_get_config
from repro.distributed import steps as jsteps
from repro.models.registry import get_model as jax_get_model
from repro.optim import adamw as jadamw
from repro.runtime import checkpoint as jck
from repro_torch.config import TrainConfig
from repro_torch.configs import get_config
from repro_torch.data.synthetic import lm_batch
from repro_torch.distributed.steps import compute_grads, init_train_state, make_train_step
from repro_torch.layers.params import params_from_numpy, tree_leaves, tree_leaves_with_path
from repro_torch.optim.adamw import adamw_update, global_norm, init_opt_state, lr_schedule
from repro_torch.runtime import checkpoint as ck
from repro_torch.runtime.resilience import FailureInjector, resilient_train_loop

TOL = dict(atol=2e-4, rtol=1e-3)
B, S = 2, 16
PARITY_ARCHS = ["qwen2-0.5b", "qwen3-1.7b", "internvl2-1b"]  # bias + tied, qk_norm, frontend


def _np(t):
    return t.detach().cpu().float().numpy()


def _get(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def _assert_trees_close(port_tree, jax_tree, **tol):
    leaves = tree_leaves_with_path(port_tree)
    assert len(leaves) == len(jax.tree_util.tree_leaves(jax_tree))
    for path, leaf in leaves:
        np.testing.assert_allclose(_np(leaf), np.asarray(_get(jax_tree, path), np.float32),
                                   err_msg="/".join(path), **tol)


# ----------------------------------------------------------------------
# AdamW: twins of tests/test_optim.py
# ----------------------------------------------------------------------
def test_adamw_converges_on_quadratic():
    tcfg = TrainConfig(learning_rate=0.05, warmup_steps=5, total_steps=200, weight_decay=0.0)
    target = torch.tensor([1.0, -2.0, 3.0])
    params = {"w": torch.zeros(3)}
    opt = init_opt_state(params)
    for _ in range(200):
        w = params["w"].detach().requires_grad_()
        (g,) = torch.autograd.grad(torch.sum((w - target) ** 2), (w,))
        params, opt, _ = adamw_update({"w": g}, opt, params, tcfg)
    np.testing.assert_allclose(_np(params["w"]), _np(target), atol=0.05)


def test_grad_clipping_caps_update():
    tcfg = TrainConfig(grad_clip=1.0, learning_rate=1.0, warmup_steps=0, total_steps=10,
                       weight_decay=0.0)
    params = {"w": torch.zeros(4)}
    opt = init_opt_state(params)
    _, _, metrics = adamw_update({"w": torch.full((4,), 1e6)}, opt, params, tcfg)
    assert float(metrics["grad_norm"]) == pytest.approx(2e6, rel=1e-3)


def test_schedule_warmup_and_decay():
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=10, total_steps=100)
    lrs = [float(lr_schedule(torch.tensor(s, dtype=torch.int32), tcfg)) for s in range(101)]
    assert lrs[0] == 0.0
    assert lrs[10] == pytest.approx(1e-3, rel=1e-6)
    assert lrs[100] == pytest.approx(1e-4, rel=0.01)  # decays to 10%
    assert all(b <= a * 1.2001 for a, b in zip(lrs[10:], lrs[11:]))


def test_bf16_moments_supported():
    tcfg = TrainConfig(optimizer_dtype="bfloat16", learning_rate=0.1,
                       warmup_steps=0)  # update must exceed bf16 ulp at 1.0
    params = {"w": torch.ones((8, 8), dtype=torch.bfloat16)}
    before = params["w"].clone()
    opt = init_opt_state(params, torch.bfloat16)
    g = {"w": torch.full((8, 8), 0.1, dtype=torch.bfloat16)}
    new_p, new_opt, _ = adamw_update(g, opt, params, tcfg)
    assert new_opt["m"]["w"].dtype == torch.bfloat16
    assert new_p["w"].dtype == torch.bfloat16
    assert float((new_p["w"].float() - before.float()).abs().max()) > 0


def test_global_norm():
    t = {"a": torch.tensor([3.0]), "b": torch.tensor([4.0])}
    assert float(global_norm(t)) == pytest.approx(5.0)


def test_adamw_state_lives_on_the_params_device_and_updates_in_place():
    params = {"w": torch.ones(3)}
    opt = init_opt_state(params)
    assert opt["step"].dtype == torch.int32 and opt["step"].shape == ()
    w, m = params["w"], opt["m"]["w"]
    new_p, new_opt, metrics = adamw_update({"w": torch.ones(3)}, opt, params,
                                           TrainConfig(warmup_steps=0))
    assert new_p["w"] is w and new_opt["m"]["w"] is m and int(new_opt["step"]) == 1
    assert isinstance(metrics["lr"], torch.Tensor) and metrics["lr"].shape == ()
    assert not bool((w == 1).all())


# ----------------------------------------------------------------------
# AdamW: port vs JAX
# ----------------------------------------------------------------------
def test_lr_schedule_equals_jax_at_every_step():
    """Equal to fp32 rounding: the two libraries' ``cos`` may differ in the
    last bit (3 of 110 steps here differ by one ulp), hence rtol 1e-6."""
    for tcfg in (TrainConfig(learning_rate=1e-3, warmup_steps=10, total_steps=100),
                 TrainConfig(learning_rate=3e-4, warmup_steps=0, total_steps=7)):
        jcfg = JaxTrainConfig(**dataclasses.asdict(tcfg))
        steps = np.arange(tcfg.total_steps + 10, dtype=np.int32)
        mine = np.array([float(lr_schedule(torch.tensor(s), tcfg)) for s in steps], np.float32)
        theirs = np.array([float(jadamw.lr_schedule(jnp.int32(s), jcfg)) for s in steps],
                          np.float32)
        np.testing.assert_allclose(mine, theirs, rtol=1e-6, atol=0)


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_adamw_matches_jax_over_steps(moments):
    """Five updates of one tree with fresh numpy gradients each step, clipping
    active on some.  Parameters fp32 at TOL; bf16 moments within one bf16
    ulp (rtol 2**-7): an fp32 moment one ulp apart in the two packages can
    round to neighbouring bf16 values."""
    rng = np.random.default_rng(0)
    tcfg = TrainConfig(learning_rate=1e-2, warmup_steps=2, total_steps=10, grad_clip=1.0,
                       optimizer_dtype=moments)
    jcfg = JaxTrainConfig(**dataclasses.asdict(tcfg))
    shapes = {"a": (4, 6), "b": {"c": (5,), "d": (2, 3, 4)}}
    jp = jax.tree_util.tree_map(lambda s: jnp.asarray(rng.standard_normal(s), jnp.float32),
                                shapes, is_leaf=lambda x: isinstance(x, tuple))
    p = params_from_numpy(jp)
    jopt = jadamw.init_opt_state(jp, jnp.dtype(moments))
    opt = init_opt_state(p, moments)
    jupd = jax.jit(functools.partial(jadamw.adamw_update, tcfg=jcfg))
    for step in range(5):
        scale = 0.05 if step % 2 else 3.0  # clipped on the even steps
        jg = jax.tree_util.tree_map(
            lambda x: jnp.asarray(scale * rng.standard_normal(x.shape), jnp.float32), jp)
        jp, jopt, jm = jupd(jg, jopt, jp)
        p, opt, m = adamw_update(params_from_numpy(jg), opt, p, tcfg)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]), rtol=1e-6)
    assert int(opt["step"]) == int(jopt["step"]) == 5
    _assert_trees_close(p, jp, **TOL)
    mom_tol = TOL if moments == "float32" else dict(atol=1e-6, rtol=2 ** -7)
    for key in ("m", "v"):
        assert tree_leaves(opt[key])[0].dtype == getattr(torch, moments)
        _assert_trees_close(opt[key], jopt[key], **mom_tol)


# ----------------------------------------------------------------------
# The train step: port vs JAX
# ----------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _setup(arch, remat="none"):
    """(jax cfg, port cfg, jax params, numpy batch) at a reduced config."""
    jcfg = jax_get_config(arch).reduced(remat=remat)
    cfg = get_config(arch).reduced(remat=remat)
    jp = jsteps.init_train_state(jcfg, JaxTrainConfig(), jax.random.PRNGKey(0))["params"]
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab_size, size=(B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:],
             "mask": (np.arange(S)[None] % 5 != 0).astype(np.int32).repeat(B, 0)}
    if cfg.family == "vlm":
        batch["frontend"] = rng.standard_normal((B, cfg.frontend_tokens, cfg.d_model)).astype(
            np.float32)
    return jcfg, cfg, jp, batch


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _port_grads(cfg, params, batch):
    """(loss, {path: gradient}) through ``steps.compute_grads``."""
    metrics, grads = compute_grads(cfg, params, _torch_batch(batch))
    return float(metrics["total_loss"]), dict(tree_leaves_with_path(grads))


@pytest.mark.parametrize("arch", PARITY_ARCHS)
def test_loss_gradients_match_jax(arch):
    jcfg, cfg, jp, batch = _setup(arch)
    jmodel = jax_get_model(jcfg)
    jloss, jgrads = jax.jit(jax.value_and_grad(lambda p: jmodel.loss(p, jcfg, {
        k: jnp.asarray(v) for k, v in batch.items()})[0]))(jp)
    loss, grads = _port_grads(cfg, params_from_numpy(jp), batch)
    np.testing.assert_allclose(loss, float(jloss), **TOL)
    assert len(grads) == len(jax.tree_util.tree_leaves(jgrads))
    for path, g in grads.items():
        np.testing.assert_allclose(_np(g), np.asarray(_get(jgrads, path)),
                                   err_msg="/".join(path), **TOL)


@pytest.mark.parametrize("mb", [1, 2])
@pytest.mark.parametrize("arch", PARITY_ARCHS)
def test_train_step_matches_jax_after_two_steps(arch, mb):
    """Two steps of ``make_train_step`` from the same state on the same
    batch: metrics after each step, then every parameter, moment and the
    step counter."""
    jcfg, cfg, jp, batch = _setup(arch)
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=10, microbatches=mb)
    jtcfg = JaxTrainConfig(**dataclasses.asdict(tcfg))
    jstate = {"params": jp, "opt": jadamw.init_opt_state(jp)}
    params = params_from_numpy(jp)
    state = {"params": params, "opt": init_opt_state(params)}
    jstep = jax.jit(jsteps.make_train_step(jcfg, jtcfg))
    step = make_train_step(cfg, tcfg)
    jb, tb = {k: jnp.asarray(v) for k, v in batch.items()}, _torch_batch(batch)
    for _ in range(2):
        jstate, jm = jstep(jstate, jb)
        state, m = step(state, tb)
        for key in ("total_loss", "grad_norm", "lr", "tokens"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]), err_msg=key, **TOL)
    assert int(state["opt"]["step"]) == 2
    _assert_trees_close(state["params"], jstate["params"], **TOL)
    _assert_trees_close(state["opt"]["m"], jstate["opt"]["m"], **TOL)
    _assert_trees_close(state["opt"]["v"], jstate["opt"]["v"], **TOL)


def test_microbatches_average_the_gradients():
    """``microbatches=2`` over a batch of 2 equals one step whose gradient is
    the mean of the two rows' gradients (the step's global norm shows it)."""
    _, cfg, jp, batch = _setup("qwen2-0.5b")
    rows = [{k: v[i:i + 1] for k, v in batch.items()} for i in range(B)]
    per_row = [_port_grads(cfg, params_from_numpy(jp), r)[1] for r in rows]
    mean = {k: (per_row[0][k] + per_row[1][k]) / 2 for k in per_row[0]}
    want = float(torch.sqrt(sum(torch.sum(g * g) for g in mean.values())))
    params = params_from_numpy(jp)
    tcfg = TrainConfig(microbatches=2, warmup_steps=1)
    _, m = make_train_step(cfg, tcfg)({"params": params, "opt": init_opt_state(params)},
                                      _torch_batch(batch))
    np.testing.assert_allclose(float(m["grad_norm"]), want, rtol=1e-5)
    # the metrics are the last microbatch's
    np.testing.assert_allclose(float(m["total_loss"]), _port_grads(cfg, params_from_numpy(jp),
                                                                    rows[1])[0], rtol=1e-6)


@pytest.mark.parametrize("remat", ["full", "dots"])
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "internvl2-1b"])
def test_remat_gives_the_same_gradients(arch, remat):
    """Recomputing a block in the backward repeats the forward's arithmetic,
    so the gradients equal those without remat."""
    _, cfg, jp, batch = _setup(arch)
    _, cfg_r, _, _ = _setup(arch, remat)
    loss, grads = _port_grads(cfg, params_from_numpy(jp), batch)
    loss_r, grads_r = _port_grads(cfg_r, params_from_numpy(jp), batch)
    assert loss == loss_r
    for path, g in grads.items():
        torch.testing.assert_close(grads_r[path], g, atol=1e-6, rtol=1e-5,
                                   msg=lambda m: f"{'/'.join(path)}: {m}")


def test_remat_applies_only_when_recording_a_graph(monkeypatch):
    """Serving and no-grad forwards never go through ``checkpoint``."""
    from repro_torch.models import lm

    calls = []
    real = lm.checkpoint
    monkeypatch.setattr(lm, "checkpoint", lambda *a, **k: calls.append(1) or real(*a, **k))
    _, cfg, jp, batch = _setup("qwen2-0.5b", "full")
    params = params_from_numpy(jp)
    with torch.no_grad():
        lm.loss(params, cfg, _torch_batch(batch))
    assert calls == []
    _port_grads(cfg, params, batch)
    assert len(calls) == cfg.num_layers


def test_train_step_decreases_loss():
    """Twin of tests/test_models_smoke.py::test_train_step_decreases_loss
    (qwen2-0.5b): 12 steps on one fixed batch."""
    cfg = get_config("qwen2-0.5b").reduced(remat="none")
    tcfg = TrainConfig(learning_rate=3e-3, warmup_steps=2, total_steps=30)
    state = init_train_state(cfg, tcfg, torch.Generator().manual_seed(0), "cpu")
    step = make_train_step(cfg, tcfg)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, size=(2, 33)).astype(np.int32)
    batch = _torch_batch({"tokens": toks[:, :-1], "targets": toks[:, 1:],
                          "mask": np.ones((2, 32), np.int32)})
    losses = []
    for _ in range(12):
        state, metrics = step(state, batch)
        losses.append(float(metrics["total_loss"]))
    assert losses[-1] < losses[0] * 0.9, losses


def test_init_train_state_needs_a_card_for_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("qwen2-0.5b").reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_train_state(cfg, TrainConfig())


# ----------------------------------------------------------------------
# Checkpoints: twins of tests/test_runtime.py, and a JAX-written one
# ----------------------------------------------------------------------
def tiny_state(seed=0):
    rng = np.random.default_rng(seed)
    return {"params": {"w": torch.from_numpy(rng.standard_normal((4, 4)).astype(np.float32)),
                       "b": torch.zeros(4)},
            "opt": {"step": torch.tensor(7, dtype=torch.int32)}}


def test_checkpoint_roundtrip(tmp_path):
    state = tiny_state()
    ck.save(str(tmp_path), 12, state, cfg="cfg-a")
    step, restored = ck.restore(str(tmp_path), state, cfg="cfg-a")
    assert step == 12
    for (pa, a), (pb, b) in zip(tree_leaves_with_path(state), tree_leaves_with_path(restored)):
        assert pa == pb and a.dtype == b.dtype
        assert torch.equal(a, b)


def test_checkpoint_fingerprint_mismatch(tmp_path):
    state = tiny_state()
    ck.save(str(tmp_path), 1, state, cfg="cfg-a")
    with pytest.raises(ValueError):
        ck.restore(str(tmp_path), state, cfg="cfg-b")


def test_checkpoint_retention_and_latest(tmp_path):
    state = tiny_state()
    for s in (1, 2, 3, 4, 5):
        ck.save(str(tmp_path), s, state, keep=2)
    assert sorted(os.listdir(tmp_path)) == ["step_000000004", "step_000000005"]
    assert ck.latest_step(str(tmp_path)) == 5


def test_checkpoint_async(tmp_path):
    state = tiny_state()
    ck.save(str(tmp_path), 9, state, blocking=False)
    state["params"]["w"].add_(1.0)  # an in-place step after save() returns
    ck.wait_pending()
    assert ck.latest_step(str(tmp_path)) == 9
    _, restored = ck.restore(str(tmp_path), state)
    assert torch.equal(restored["params"]["w"], tiny_state()["params"]["w"])


def test_incomplete_checkpoint_ignored(tmp_path):
    ck.save(str(tmp_path), 3, tiny_state())
    os.makedirs(tmp_path / ".tmp_4")  # a crash mid-write
    assert ck.latest_step(str(tmp_path)) == 3


def test_bf16_leaves_roundtrip_exactly(tmp_path):
    state = {"m": torch.randn(5, 3).to(torch.bfloat16), "x": torch.arange(4)}
    ck.save(str(tmp_path), 0, state)
    _, restored = ck.restore(str(tmp_path), state)
    assert restored["m"].dtype == torch.bfloat16 and torch.equal(restored["m"], state["m"])
    assert torch.equal(restored["x"], state["x"])


def test_jax_written_checkpoint_restores_into_the_port(tmp_path):
    """``repro.runtime.checkpoint.save`` of the JAX package's train state
    (reduced qwen2-0.5b, after one step so the moments are non-zero)
    restores into the port's state of the same config: same keys, equal
    arrays, the port's dtypes; and the config's fingerprint is the same in
    both packages."""
    jcfg, cfg, jp, batch = _setup("qwen2-0.5b")
    jtcfg = JaxTrainConfig(warmup_steps=1)
    jstate = {"params": jp, "opt": jadamw.init_opt_state(jp)}
    jstate, _ = jax.jit(jsteps.make_train_step(jcfg, jtcfg))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    jck.save(str(tmp_path), 4, jstate, cfg=jcfg)
    assert ck.fingerprint(cfg) == jck.fingerprint(jcfg)

    port_state = init_train_state(cfg, TrainConfig(), None, "cpu")
    step, restored = ck.restore(str(tmp_path), port_state, cfg=cfg)
    assert step == 4
    jflat = {"/".join(str(k) for k in path): leaf
             for path, leaf in jax.tree_util.tree_flatten_with_path(jstate)[0]}
    mine = {ck.leaf_key(path): leaf for path, leaf in tree_leaves_with_path(restored)}
    assert sorted(mine) == sorted(jflat)
    for key, leaf in mine.items():
        np.testing.assert_array_equal(leaf.numpy(), np.asarray(jflat[key]), err_msg=key)
    assert restored["opt"]["step"].dtype == torch.int32 and int(restored["opt"]["step"]) == 1


# ----------------------------------------------------------------------
# The resilient loop
# ----------------------------------------------------------------------
def _loop_setup():
    cfg = get_config("qwen2-0.5b").reduced(num_layers=2, d_model=32, d_ff=64, vocab_size=128,
                                            remat="none")
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=2, total_steps=30)
    state = init_train_state(cfg, tcfg, torch.Generator().manual_seed(0), "cpu")
    return cfg, tcfg, state, lambda s: lm_batch(cfg, s, 2, 16)


def test_resilient_loop_survives_injected_failures(tmp_path):
    cfg, tcfg, state, batch_fn = _loop_setup()
    injector = FailureInjector(fail_at_steps={7, 13})
    seen = []
    state, report = resilient_train_loop(
        init_state=state, train_step=make_train_step(cfg, tcfg), batch_fn=batch_fn,
        total_steps=20, ckpt_dir=str(tmp_path), cfg=cfg, checkpoint_every=5,
        injector=injector, on_metrics=lambda s, m: seen.append(s),
    )
    assert report["restarts"] == 2
    assert report["finished_step"] == 20
    assert int(state["opt"]["step"]) >= 18  # optimizer advanced past restarts
    assert seen == list(range(7)) + list(range(5, 13)) + list(range(10, 20))


def test_failure_before_the_first_checkpoint_restarts_from_the_initial_state(tmp_path):
    """The step updates the state in place, so by step 2 ``init_state``'s
    tensors hold step 1's parameters; the loop must restart from the
    parameters it was given, and so end exactly where an uninterrupted run
    ends."""
    cfg, tcfg, state, batch_fn = _loop_setup()
    _, _, clean, _ = _loop_setup()
    initial = [t.clone() for t in tree_leaves(state)]
    seen = []
    failed, report = resilient_train_loop(
        init_state=state, train_step=make_train_step(cfg, tcfg), batch_fn=batch_fn,
        total_steps=8, ckpt_dir=str(tmp_path / "a"), cfg=cfg, checkpoint_every=5,
        injector=FailureInjector(fail_at_steps={2}), on_metrics=lambda s, m: seen.append(s))
    assert report["restarts"] == 1 and seen[:4] == [0, 1, 0, 1]
    assert not torch.equal(tree_leaves(state)[0], initial[0])  # init_state was stepped on
    clean, _ = resilient_train_loop(
        init_state=clean, train_step=make_train_step(cfg, tcfg), batch_fn=batch_fn,
        total_steps=8, ckpt_dir=str(tmp_path / "b"), cfg=cfg, checkpoint_every=5)
    for (path, a), b in zip(tree_leaves_with_path(failed), tree_leaves(clean)):
        assert torch.equal(a, b), "/".join(path)
    assert int(failed["opt"]["step"]) == 8
