"""The port's partitioning layer against the JAX package's: twins of
``tests/test_distributed.py`` (its dry-run test belongs to the dry-run
slice).

* The rules: every spec the port resolves is held equal, entry by entry, to
  ``tuple(PartitionSpec)`` from the JAX package on the same ``FakeMesh``
  shapes; for every architecture, the train state's, the cache's and the
  batches' specs on the production meshes.
* The int8 error-feedback all-reduce: bit-exact against the JAX package's
  on the same per-replica gradients (run in a subprocess on 8 forced host
  devices: both packages round half to even and sum the int8 payload
  exactly); the quadratic of ``test_int8_ef_grad_sync_converges`` on an
  8-position ``cpu`` mesh; ``compression="none"`` against the gradient of
  the whole batch.
* ``elastic_remesh`` 8 -> 4, ``place``/``gather``, ``frame_spec``, and
  ``Prefetcher(place=)`` through ``make_lm_stream(batch_axes=)``.

Meshes are the port's one-process meshes of ``cpu`` positions.
"""

import jax
import numpy as np
import pytest
import torch

from repro.config import TrainConfig as JaxTrainConfig
from repro.configs import get_config as jax_get_config
from repro.distributed import partitioning as jpt
from repro.distributed import steps as jsteps
from repro.engine.sharding.shard_exec import frame_spec as jax_frame_spec
from repro_torch.config import TrainConfig
from repro_torch.configs import LM_ARCH_IDS, get_config
from repro_torch.data import synthetic as syn
from repro_torch.data.pipeline import Prefetcher, make_lm_stream
from repro_torch.distributed import partitioning as pt
from repro_torch.distributed import steps as tsteps
from repro_torch.distributed.grad_sync import (data_positions, init_ef_state, make_dp_grad_fn)
from repro_torch.engine.sharding import frame_spec
from repro_torch.launch.mesh import (MULTI_POD, SINGLE_POD, band_submesh, make_mesh,
                                     make_production_mesh, make_sr_mesh)
from repro_torch.layers.params import tree_leaves_with_path
from repro_torch.models import lm
from repro_torch.runtime.resilience import elastic_remesh


class FakeMesh:
    """A mesh shape both packages resolve rules against."""

    def __init__(self, shape, names):
        self.devices = np.empty(shape, dtype=object)
        self.shape = tuple(shape)
        self.axis_names = names


def _same(mine, jax_spec):
    """The port's spec equals the JAX package's PartitionSpec entry by entry."""
    assert isinstance(mine, tuple)
    assert mine == tuple(jax_spec), (mine, jax_spec)


# ----------------------------------------------------------------------
# Rule resolution
# ----------------------------------------------------------------------
def test_logical_to_spec_drops_missing_axes():
    mesh = FakeMesh((4, 2), ("data", "model"))
    spec = pt.logical_to_spec(("batch", None, "mlp"), mesh, pt.BASE_RULES)
    assert spec == ("data", None, "model")
    _same(spec, jpt.logical_to_spec(("batch", None, "mlp"), mesh, jpt.BASE_RULES))


def test_shape_aware_divisibility():
    mesh = FakeMesh((4, 2), ("data", "model"))
    for dim, want in ((6, ("model",)), (3, (None,))):
        spec = pt.shape_aware_spec(("mlp",), (dim,), mesh, pt.BASE_RULES)
        assert spec == want
        _same(spec, jpt.shape_aware_spec(("mlp",), (dim,), mesh, jpt.BASE_RULES))


def test_shape_aware_multi_axis_prefix():
    mesh = FakeMesh((2, 4, 2), ("pod", "data", "model"))
    for dim, want in ((2, ("pod",)), (16, (("pod", "data"),))):
        spec = pt.shape_aware_spec(("batch",), (dim,), mesh, pt.BASE_RULES)
        assert spec == want
        _same(spec, jpt.shape_aware_spec(("batch",), (dim,), mesh, jpt.BASE_RULES))


def test_mesh_axis_used_once():
    mesh = FakeMesh((4, 2), ("data", "model"))
    spec = pt.shape_aware_spec(("heads", "mlp"), (4, 4), mesh, pt.BASE_RULES)
    assert spec == ("model", None)  # both want 'model'; first wins
    _same(spec, jpt.shape_aware_spec(("heads", "mlp"), (4, 4), mesh, jpt.BASE_RULES))


def test_fsdp_rules_extend_embed():
    rules = pt.fsdp_rules()
    assert rules["embed"] == "data" and rules == jpt.fsdp_rules()
    assert pt.BASE_RULES["embed"] is None  # base untouched
    assert pt.BASE_RULES == jpt.BASE_RULES
    assert pt.serve_rules() == jpt.serve_rules()
    assert pt.long_context_rules() == jpt.long_context_rules()


def test_pshard_is_identity_off_mesh():
    x = torch.ones((4, 4))
    assert pt.pshard(x, "batch", "mlp") is x


def test_sr_rules_is_a_copy():
    rules = pt.sr_rules()
    rules["sr_rows"] = "mangled"
    assert pt.sr_rules()["sr_rows"] == "bands"
    assert pt.SR_RULES["sr_rows"] == "bands"
    assert pt.SR_RULES == jpt.SR_RULES


def test_sr_rules_resolve_on_full_serving_mesh():
    mesh = FakeMesh((2, 4), ("replica", "bands"))
    axes = ("sr_batch", "sr_rows", "sr_cols", "sr_chan")
    spec = pt.logical_to_spec(axes, mesh, pt.sr_rules())
    assert spec == ("replica", "bands", None, None)
    _same(spec, jpt.logical_to_spec(axes, mesh, jpt.sr_rules()))


def test_sr_rules_drop_replica_on_band_submesh():
    mesh = FakeMesh((4,), ("bands",))
    axes = ("sr_batch", "sr_rows", "sr_cols", "sr_chan")
    spec = pt.logical_to_spec(axes, mesh, pt.sr_rules())
    assert spec == (None, "bands", None, None)
    _same(spec, jpt.logical_to_spec(axes, mesh, jpt.sr_rules()))


def test_sr_rules_shape_aware_row_divisibility():
    mesh = FakeMesh((4,), ("bands",))
    for rows, want in ((48, ("bands",)), (42, (None,))):
        spec = pt.shape_aware_spec(("sr_rows",), (rows,), mesh, pt.sr_rules())
        assert spec == want
        _same(spec, jpt.shape_aware_spec(("sr_rows",), (rows,), mesh, jpt.sr_rules()))


def test_pshard_checks_the_rank_under_a_mesh():
    x = torch.ones((4, 6))
    with pt.axis_rules(make_mesh((2, 2), ("data", "model"), devices=["cpu"])):
        assert pt.current_mesh().shape == (2, 2)
        assert pt.pshard(x, "batch", "mlp") is x
        with pytest.raises(ValueError, match="2 logical axes"):
            pt.pshard(torch.ones((4, 6, 2)), "batch", "mlp")
    assert pt.current_mesh() is None


def test_frame_spec_matches_jax():
    for mesh, fake in ((make_sr_mesh(2, 4, device="cpu"), FakeMesh((2, 4), ("replica", "bands"))),
                       (band_submesh(make_sr_mesh(2, 4, device="cpu"), 1),
                        FakeMesh((4,), ("bands",)))):
        _same(frame_spec(mesh), jax_frame_spec(fake))
    assert frame_spec(band_submesh(make_sr_mesh(1, 2, device="cpu"), 0))[1] == "bands"


# ----------------------------------------------------------------------
# Every architecture's state, cache and batch shardings on the production
# meshes
# ----------------------------------------------------------------------
def _leaves(tree):
    return [leaf for _, leaf in tree_leaves_with_path(tree)]


@pytest.mark.parametrize("arch", LM_ARCH_IDS)
def test_trainstate_shardings_resolve_for_all_archs(arch):
    """Every arch's full train-state, cache and batch sharding trees build
    on the production meshes (``devices=["cpu"]``), every spec equal to
    the JAX package's on the same mesh shape."""
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    rules, jrules = (pt.fsdp_rules(), jpt.fsdp_rules()) if cfg.fsdp else (pt.BASE_RULES,
                                                                         jpt.BASE_RULES)
    for multi_pod in (False, True):
        mesh = make_production_mesh(multi_pod=multi_pod, devices=["cpu"])
        shape, names = MULTI_POD if multi_pod else SINGLE_POD
        assert mesh.shape == shape and mesh.axis_names == names and mesh.size == np.prod(shape)
        fake = FakeMesh(shape, names)
        with pt.axis_rules(mesh, rules):
            sds = tsteps.train_state_shapes(cfg, TrainConfig())
            axes = tsteps.train_state_axes(cfg)
            sh = pt.make_shardings(axes, sds)
            c_axes, c_sds = tsteps.cache_axes_and_shapes(cfg, 16, 1024)
            c_sh = pt.make_shardings(c_axes, c_sds)
        jsds = jsteps.train_state_shapes(jcfg, JaxTrainConfig())
        jc_axes, jc_sds = jsteps.cache_axes_and_shapes(jcfg, 16, 1024)
        for mine, theirs, j_axes, j_sds in ((sh, sds, jsteps.train_state_axes(jcfg), jsds),
                                            (c_sh, c_sds, jc_axes, jc_sds)):
            is_axes = lambda x: isinstance(x, tuple)  # noqa: E731
            flat_axes = jax.tree_util.tree_leaves(j_axes, is_leaf=is_axes)
            flat_sds = jax.tree_util.tree_leaves(j_sds)
            assert len(_leaves(mine)) == len(flat_sds) == len(flat_axes)
            for s, t, ax, want in zip(_leaves(mine), _leaves(theirs), flat_axes, flat_sds):
                assert s.mesh is mesh and t.device.type == "meta"
                assert (tuple(t.shape), str(t.dtype).removeprefix("torch.")) == \
                    (tuple(want.shape), str(want.dtype))
                _same(s.spec, jpt.shape_aware_spec(ax, want.shape, fake, jrules))
        for kind in ("train", "prefill", "decode"):
            b_axes = tsteps.batch_axes(cfg, kind)
            assert b_axes == jsteps.batch_axes(jcfg, kind)
            for key, ax in b_axes.items():
                dims = (256, 4096, cfg.d_model)[:len(ax)]
                _same(pt.shape_aware_spec(ax, dims, mesh, rules),
                      jpt.shape_aware_spec(ax, dims, fake, jrules))


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "internvl2-1b", "arctic-480b", "deepseek-v2-236b",
                                  "mamba2-130m", "zamba2-2.7b", "seamless-m4t-large-v2"])
def test_models_run_unchanged_under_an_active_mesh(arch):
    """Every ``pshard`` tag a model's loss passes resolves on the production
    mesh (the tags match their tensors' ranks), and the loss is the one
    computed off the mesh, to the bit (``pshard`` moves nothing)."""
    cfg = get_config(arch).reduced()
    params = tsteps.init_train_state(cfg, TrainConfig(), device="cpu")["params"]
    batch = syn.lm_batch(cfg, 0, 2, 16)
    if cfg.family == "vlm":
        batch["frontend"] = _normal(1, (2, cfg.frontend_tokens, cfg.d_model))
    if cfg.family == "encdec":
        batch["src"] = _normal(1, (2, 12, cfg.d_model))
    model = tsteps.get_model(cfg)
    with torch.no_grad():
        off, _ = model.loss(params, cfg, batch)
        with pt.axis_rules(make_production_mesh(devices=["cpu"]),
                           pt.fsdp_rules() if cfg.fsdp else None):
            on, _ = model.loss(params, cfg, batch)
    assert torch.equal(on, off)


def test_make_shardings_requires_a_mesh():
    with pytest.raises(ValueError, match="requires a mesh"):
        pt.make_shardings({"w": ("mlp",)}, {"w": torch.empty(4, device="meta")})
    with pytest.raises(ValueError, match="batch_axes"):
        tsteps.batch_axes(get_config("qwen2-0.5b"), "batch_axes")


# ----------------------------------------------------------------------
# place / gather, elastic re-mesh, the data pipeline
# ----------------------------------------------------------------------
def test_place_and_gather_round_trip_on_a_three_axis_mesh():
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), devices=["cpu"])
    t = torch.arange(8 * 6 * 4, dtype=torch.float32).reshape(8, 6, 4)
    placed = pt.place(t, pt.NamedSharding(mesh, (("pod", "data"), None, "model")))
    assert len(placed.shards) == 8 and placed.dtype == torch.float32
    for pos, shard in enumerate(placed.shards):
        c = mesh.coords(pos)
        rows = (2 * c["pod"] + c["data"]) * 2
        assert torch.equal(shard, t[rows:rows + 2, :, 2 * c["model"]:2 * c["model"] + 2])
        assert shard.untyped_storage().data_ptr() == t.untyped_storage().data_ptr()  # views
    assert torch.equal(pt.gather(placed), t)
    with pytest.raises(ValueError, match="does not split"):
        pt.place(torch.ones(3, 4), pt.NamedSharding(mesh, ("data", None)))


def test_elastic_remesh_8_to_4():
    mesh8 = make_mesh((4, 2), ("data", "model"), devices=["cpu"])
    mesh4 = make_mesh((2, 2), ("data", "model"), devices=["cpu"])
    state = {"w": torch.arange(32.0).reshape(8, 4), "b": torch.ones((4,))}
    axes = {"w": ("batch", "mlp"), "b": ("mlp",)}
    with pt.axis_rules(mesh8, pt.BASE_RULES):
        placed = elastic_remesh(state, axes, mesh8)
    assert placed["w"].sharding.spec == ("data", "model")
    moved = elastic_remesh(placed, axes, mesh4)
    assert moved["w"].sharding.mesh.size == 4 and moved["w"].sharding.mesh is mesh4
    for key in state:
        _same(moved[key].sharding.spec, jpt.shape_aware_spec(
            axes[key], tuple(state[key].shape), FakeMesh((2, 2), ("data", "model")),
            jpt.BASE_RULES))
        assert torch.equal(pt.gather(moved[key]), state[key])
    assert [tuple(s.shape) for s in moved["w"].shards] == [(4, 2)] * 4


def test_prefetcher_places_batches_through_make_lm_stream():
    cfg = get_config("qwen2-0.5b").reduced()
    mesh = make_mesh((2, 2), ("data", "model"), devices=["cpu"])
    seen = []
    pf = Prefetcher(lambda s: {"x": s}, place=lambda b: {"x": b["x"] * 10})
    for _ in range(3):
        seen.append(next(pf))
    pf.close()
    assert seen == [(0, {"x": 0}), (1, {"x": 10}), (2, {"x": 20})]

    with pt.axis_rules(mesh):
        pf = make_lm_stream(cfg, 4, 8, seed=3, start_step=2,
                            batch_axes=tsteps.batch_axes(cfg, "train"), device="cpu")
    try:
        step, batch = next(pf)
    finally:
        pf.close()
    want = syn.lm_batch(cfg, 2, 4, 8, 3)
    assert step == 2 and sorted(batch) == sorted(want)
    for key, val in batch.items():
        assert isinstance(val, pt.Sharded) and val.sharding.spec == ("data", None)
        assert [tuple(s.shape) for s in val.shards] == [(2, 8)] * 4
        assert torch.equal(pt.gather(val), want[key])


# ----------------------------------------------------------------------
# Data-parallel gradient synchronisation
# ----------------------------------------------------------------------
def test_data_positions_walk_the_data_axis():
    mesh = make_mesh((4, 2), ("data", "model"), devices=["cpu"])
    assert data_positions(mesh) == [0, 2, 4, 6]
    assert data_positions(mesh, "model") == [0, 1]
    with pytest.raises(ValueError, match="no 'pod' axis"):
        data_positions(mesh, "pod")


def _quadratic():
    target = torch.arange(16.0).reshape(4, 4)

    def loss_fn(params, batch):
        pred = batch["x"] @ params["w"]
        return torch.mean((pred - batch["x"] @ target) ** 2)

    return loss_fn


def _normal(seed, shape):
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed))


def test_int8_ef_grad_sync_converges():
    """The twin of tests/test_distributed.py's: 300 SGD steps on a quadratic
    over 8 data positions with int8+EF gradients bring the loss below 1e-3
    of its first value; far from the optimum the compressed gradient points
    where the raw one does (cosine > 0.99)."""
    mesh = make_mesh((8,), ("data",), devices=["cpu"])
    loss_fn = _quadratic()
    params = {"w": torch.zeros((4, 4))}
    ef = init_ef_state(params)
    fn = make_dp_grad_fn(loss_fn, mesh, compression="int8_ef")
    fn_raw = make_dp_grad_fn(loss_fn, mesh, compression="none")
    losses = []
    for step in range(300):
        loss, grads, ef = fn(params, {"x": _normal(step, (8, 4))}, ef)
        params = {"w": params["w"] - 0.1 * grads["w"]}
        losses.append(float(loss))
    assert len(ef) == 8
    assert losses[-1] < 1e-3 * losses[0], losses[::50]
    params = {"w": _normal(5, (4, 4))}
    batch = {"x": _normal(999, (8, 4))}
    _, gq, _ = fn(params, batch, init_ef_state(params))
    _, gr, _ = fn_raw(params, batch, init_ef_state(params))
    cos = float((gq["w"] * gr["w"]).sum() / (gq["w"].norm() * gr["w"].norm() + 1e-9))
    assert cos > 0.99, cos


def test_int8_ef_transmitted_means_telescope():
    """Error feedback's guarantee: over k steps on the same gradients (a
    reduced qwen2-0.5b, fixed parameters and batch, 4 data positions) the
    transmitted means plus the positions' mean residual add up to k times
    the raw mean, up to fp32 roundings."""
    cfg = get_config("qwen2-0.5b").reduced()
    params = tsteps.init_train_state(cfg, TrainConfig(), device="cpu")["params"]
    batch = syn.lm_batch(cfg, 0, 8, 16)
    loss_fn = lambda p, b: lm.loss(p, cfg, b)[0]  # noqa: E731
    mesh = make_mesh((4,), ("data",), devices=["cpu"])
    _, raw, _ = make_dp_grad_fn(loss_fn, mesh, compression="none")(params, batch, None)
    fn = make_dp_grad_fn(loss_fn, mesh)
    ef, total, k = init_ef_state(params), None, 5
    for _ in range(k):
        _, g, ef = fn(params, batch, ef)
        flat = [t.double() for _, t in tree_leaves_with_path(g)]
        total = flat if total is None else [a + b for a, b in zip(total, flat)]
    assert len(ef) == 4
    residual = [sum(t.double() for t in ts) / 4
                for ts in zip(*[[t for _, t in tree_leaves_with_path(e)] for e in ef])]
    for (path, r), t, e in zip(tree_leaves_with_path(raw), total, residual):
        want = k * r.double()
        assert float((t + e - want).norm()) <= 1e-6 * float(want.norm()), path


def test_dp_grad_fn_none_matches_the_whole_batch_gradient():
    """``compression="none"`` over 4 data positions (a (4, 2) mesh: the
    model axis replicates) == the gradient of the whole batch's loss (a
    reduced qwen2-0.5b, fp32, every position's tokens equally many)."""
    cfg = get_config("qwen2-0.5b").reduced()
    params = tsteps.init_train_state(cfg, TrainConfig(), device="cpu")["params"]
    batch = syn.lm_batch(cfg, 0, 8, 16)
    loss_fn = lambda p, b: lm.loss(p, cfg, b)[0]  # noqa: E731
    mesh = make_mesh((4, 2), ("data", "model"), devices=["cpu"])
    loss, grads, ef = make_dp_grad_fn(loss_fn, mesh, compression="none")(params, batch, None)
    assert ef is None
    metrics, whole = tsteps.compute_grads(cfg, params, batch)
    torch.testing.assert_close(loss, metrics["total_loss"], atol=1e-6, rtol=1e-6)
    for (path, got), (_, want) in zip(tree_leaves_with_path(grads), tree_leaves_with_path(whole)):
        err = float((got.double() - want.double()).norm())
        assert err <= 1e-5 * max(float(want.double().norm()), 1e-30), path
    with pytest.raises(ValueError, match="does not split"):
        make_dp_grad_fn(loss_fn, mesh, compression="none")(params, syn.lm_batch(cfg, 0, 6, 16),
                                                           None)
    with pytest.raises(ValueError, match="topk"):
        make_dp_grad_fn(loss_fn, mesh, compression="topk")


def test_int8_ef_allreduce_matches_jax(subproc):
    """The same per-replica gradients and residuals through the JAX
    package's ``int8_ef_allreduce`` (inside ``shard_map`` on 8 forced host
    devices) and the port's (an 8-position ``cpu`` mesh), two steps (the
    second from the JAX package's first residuals, given to both): every
    replica's mean equal to the bit.  One leaf is built so that
    ``x / scale`` lands on exact halves, where rounding half to even
    decides.  The residual ``gf - q * scale`` differs by the rounding of
    the product (within one ulp of ``q * scale`` plus one of the result):
    XLA's CPU backend contracts it into a fused multiply-add (one rounding:
    the JAX package's residual equals the fp64 evaluation rounded once),
    where the port rounds the product and the difference apart (its
    residual equals numpy's fp32 ``gf - q * scale`` to the bit)."""
    out = subproc("""
        import jax, jax.numpy as jnp, numpy as np, torch
        from jax.experimental.shard_map import shard_map
        from jax.sharding import PartitionSpec as P
        from repro.launch.mesh import make_mesh
        from repro.distributed.grad_sync import int8_ef_allreduce as jax_allreduce
        from repro_torch.distributed.grad_sync import int8_ef_allreduce

        n = 8
        rng = np.random.default_rng(0)
        halves = np.tile((np.arange(-254, 255, dtype=np.float32) / 16.0)[None], (n, 1))
        assert np.abs(halves).max() == 127 / 8.0  # scale 2^-3: x / scale = m / 2
        steps = [{"a": rng.standard_normal((n, 6, 5)).astype(np.float32),
                  "b": {"c": (rng.standard_normal((n, 7)) ** 3).astype(np.float32),
                        "h": halves}} for _ in range(2)]
        mesh = make_mesh((n,), ("data",))

        def local(g, e):
            g = jax.tree_util.tree_map(lambda x: x[0], g)
            e = jax.tree_util.tree_map(lambda x: x[0], e)
            out, new_e = jax_allreduce(g, e, "data")
            lift = lambda t: jax.tree_util.tree_map(lambda x: x[None], t)
            return lift(out), lift(new_e)

        spec = lambda t: jax.tree_util.tree_map(lambda _: P("data"), t)
        fn = jax.jit(shard_map(local, mesh=mesh, in_specs=(spec(steps[0]), spec(steps[0])),
                               out_specs=(spec(steps[0]), spec(steps[0])), check_rep=False))
        flat = lambda t: jax.tree_util.tree_leaves(t)
        per = lambda t, i: jax.tree_util.tree_map(lambda x: torch.from_numpy(np.array(x[i])), t)
        ef = jax.tree_util.tree_map(np.zeros_like, steps[0])
        for g in steps:
            jout, jef = fn(g, ef)
            tout, tef = int8_ef_allreduce([per(g, i) for i in range(n)],
                                          [per(ef, i) for i in range(n)])
            for want, got in zip(flat(jout), flat(tout)):
                for i in range(n):
                    assert np.array_equal(np.asarray(want)[i], got.numpy())
            for k, (gl, el, jl) in enumerate(zip(flat(g), flat(ef), flat(jef))):
                gf = (gl + el).astype(np.float32)
                scale = np.float32(max(np.abs(gf).max(), 1e-12)) / np.float32(127)
                q = np.clip(np.round(gf / scale), -127, 127).astype(np.float32)
                fused = gf.astype(np.float64) - q.astype(np.float64) * np.float64(scale)
                theirs = np.asarray(jl)
                assert np.array_equal(theirs, fused.astype(np.float32))  # one rounding
                two = gf - q * scale  # two roundings
                for i in range(n):
                    mine = flat(tef[i])[k].numpy()
                    assert np.array_equal(mine, two[i]), (k, i)
                    # the product's rounding, carried through the difference
                    assert np.all(np.abs(mine - theirs[i]) <= np.spacing(np.abs(q[i] * scale))
                                  + np.spacing(np.abs(theirs[i])))
            ef = jax.tree_util.tree_map(np.asarray, jef)
        assert (np.abs(halves[0] / 0.125 - np.round(halves[0] / 0.125)) == 0.5).sum() > 100
        print("OK")
    """)
    assert "OK" in out
