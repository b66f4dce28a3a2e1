"""The port's roofline layer against the JAX package's
(``repro.roofline``, ``repro.configs.shapes``, ``repro.launch.dryrun_lib``).

* Exact parity: ``active_params`` and ``model_flops`` for every
  architecture and kind; ``sharded_bytes`` and ``analytic_hbm_bytes`` for
  every architecture, shape and production mesh; ``pick_rules`` and
  ``shape_applicable``; ``input_specs``' shapes and dtypes against the
  reference's ``ShapeDtypeStruct``s.  All of it is integer arithmetic on
  the same schemas, so nothing is held to a tolerance.
* ``roofline_row`` under the reference's own peaks (read from
  ``repro.roofline.report`` here, never written into the port) gives the
  reference's numbers for the same counts.
* ``trace_cost``: exact FLOPs, live bytes and operator bytes of small
  known chains, the same on ``meta`` and on CPU tensors.
* ``analytic_collective_bytes`` by hand; the published H100 peaks.

The reference's HLO parser (``tests/test_roofline.py``) has no twin: the
port has no HLO.
"""

import math

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import shapes as jshapes
from repro.launch import dryrun_lib as jdryrun
from repro.roofline import analytic as janalytic
from repro.roofline import model_flops as jmodel_flops
from repro.roofline import report as jreport
from repro.models.registry import get_model as jax_get_model
from repro_torch.configs import LM_ARCH_IDS, get_config
from repro_torch.configs import shapes
from repro_torch.launch import dryrun_lib
from repro_torch.models.registry import get_model
from repro_torch.roofline import analytic, model_flops, report
from repro_torch.roofline.trace_cost import trace_cost

SHAPE_NAMES = list(shapes.SHAPES)
MESHES = ("single_pod", "multi_pod")


def _rules_equal(mine, ref):
    assert set(mine) == set(ref)
    for k in ref:
        want = ref[k]
        assert mine[k] == (tuple(want) if isinstance(want, list) else want), k


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", LM_ARCH_IDS)
def test_active_params_and_model_flops_equal_the_reference(arch, kind):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    assert model_flops.active_params(cfg) == jmodel_flops.active_params(jcfg)
    for name, spec in shapes.SHAPES.items():
        if spec.kind != kind:
            continue
        got = model_flops.model_flops(cfg, kind, spec.global_batch, spec.seq_len)
        want = jmodel_flops.model_flops(jcfg, kind, spec.global_batch, spec.seq_len)
        assert got == want, (name, got, want)
    assert model_flops.model_flops(cfg, kind, 3, 5) == jmodel_flops.model_flops(jcfg, kind, 3, 5)


@pytest.mark.parametrize("shape_name", SHAPE_NAMES)
@pytest.mark.parametrize("arch", LM_ARCH_IDS)
def test_pick_rules_and_shape_applicable_equal_the_reference(arch, shape_name):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    assert shapes.shape_applicable(cfg, shape_name) == jshapes.shape_applicable(jcfg, shape_name)
    _rules_equal(dryrun_lib.pick_rules(cfg, shape_name), jdryrun.pick_rules(jcfg, shape_name))


@pytest.mark.parametrize("shape_name", SHAPE_NAMES)
@pytest.mark.parametrize("arch", LM_ARCH_IDS)
def test_input_specs_match_the_reference(arch, shape_name):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for overrides in ({}, {"override_batch": 3, "override_seq": 300}):
        mine = shapes.input_specs(cfg, shape_name, **overrides)
        ref = jshapes.input_specs(jcfg, shape_name, **overrides)
        assert sorted(mine) == sorted(ref)
        for k, t in mine.items():
            assert t.device.type == "meta"
            assert tuple(t.shape) == tuple(ref[k].shape), k
            assert str(t.dtype).removeprefix("torch.") == str(ref[k].dtype), k


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("shape_name", SHAPE_NAMES)
@pytest.mark.parametrize("arch", LM_ARCH_IDS)
def test_sharded_and_analytic_hbm_bytes_equal_the_reference(arch, shape_name, mesh):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    spec = shapes.SHAPES[shape_name]
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh, "kind": spec.kind,
           "seq_len": spec.seq_len, "global_batch": spec.global_batch}
    rules = dryrun_lib.pick_rules(cfg, shape_name)
    jrules = jdryrun.pick_rules(jcfg, shape_name)
    sizes = analytic._mesh_sizes(mesh)
    assert sizes == janalytic._mesh_sizes(mesh)
    got = analytic.sharded_bytes(get_model(cfg).schema(cfg), rules, sizes, cfg.param_dtype)
    want = janalytic.sharded_bytes(jax_get_model(jcfg).schema(jcfg), jrules, sizes,
                                   jcfg.weight_dtype)
    assert got == want
    assert analytic.analytic_hbm_bytes(rec, cfg, rules) == janalytic.analytic_hbm_bytes(
        rec, jcfg, jrules)
    # the same mesh named by its sizes gives the same bytes
    assert analytic.analytic_hbm_bytes(rec, cfg, rules, mesh_sizes=sizes) == \
        analytic.analytic_hbm_bytes(rec, cfg, rules)


def test_qwen2_decode_32k_on_one_card_needs_its_cache_and_weights():
    """The (1, 1) mesh of phase 4j: qwen2-0.5b's bf16 KV cache at 128 x
    32,768 is 51.54 GB (24 layers x 2 KV heads x 64 x K and V x 2 B x
    4,194,304 tokens), and its fp32 weights 1.98 GB more."""
    cfg = get_config("qwen2-0.5b")
    rec = {"arch": cfg.name, "shape": "decode_32k", "mesh": "data=1,model=1", "kind": "decode",
           "seq_len": 32_768, "global_batch": 128}
    rules = dryrun_lib.pick_rules(cfg, "decode_32k")
    sizes = {"data": 1, "model": 1}
    cache = 24 * 2 * 64 * 2 * 2 * 128 * 32_768
    params = analytic.sharded_bytes(get_model(cfg).schema(cfg), rules, sizes, cfg.param_dtype)
    assert cache == 51_539_607_552 and params == 4 * 494_032_768
    assert analytic.analytic_hbm_bytes(rec, cfg, rules, mesh_sizes=sizes) == cache + params
    assert analytic.analytic_collective_bytes(rec, cfg, rules, mesh_sizes=sizes) == {}


def test_analytic_collective_bytes_by_hand():
    cfg = get_config("qwen2-0.5b")
    rec = {"arch": cfg.name, "shape": "train_4k", "mesh": "single_pod", "kind": "train",
           "seq_len": 4096, "global_batch": 256, "microbatches": 1}
    rules = dryrun_lib.pick_rules(cfg, "train_4k")
    p = analytic.sharded_bytes(get_model(cfg).schema(cfg), rules, {"data": 16, "model": 16},
                               cfg.param_dtype)
    stream = 16 * 4096 * 896 * 2  # one device's (B / dp, S, d) bf16 residual stream
    want_ar = 2 * 15 / 16 * p + 2 * 2 * 24 * 2 * 15 / 16 * stream
    got = analytic.analytic_collective_bytes(rec, cfg, rules)
    assert got == {"all-reduce": want_ar}

    big = get_config("arctic-480b")  # FSDP: 'embed' shards over 'data' in training
    rules = dryrun_lib.pick_rules(big, "train_4k")
    assert rules["embed"] == "data"
    p = analytic.sharded_bytes(get_model(big).schema(big), rules, {"data": 16, "model": 16},
                               big.param_dtype)
    got = analytic.analytic_collective_bytes(dict(rec, arch=big.name), big, rules)
    assert got["all-gather"] == 2 * 15 * p  # forward and backward, one microbatch
    got = analytic.analytic_collective_bytes(dict(rec, arch=big.name, microbatches=4), big, rules)
    assert got["all-gather"] == 4 * 2 * 15 * p

    rec = dict(rec, shape="decode_32k", kind="decode", seq_len=32_768, global_batch=128)
    rules = dryrun_lib.pick_rules(cfg, "decode_32k")
    got = analytic.analytic_collective_bytes(rec, cfg, rules)
    assert got == {"all-reduce": 2 * 24 * 2 * 15 / 16 * (8 * 1 * 896 * 2)}


def _counts(seed):
    rng = np.random.default_rng(seed)
    return (float(rng.integers(1, 10**15)), float(rng.integers(1, 10**12)),
            float(rng.integers(0, 10**11)))


@pytest.mark.parametrize("shape_name", SHAPE_NAMES)
@pytest.mark.parametrize("arch", LM_ARCH_IDS)
def test_roofline_row_under_the_reference_peaks_equals_the_reference(arch, shape_name):
    peaks = {"bf16": jreport.PEAK_FLOPS, "fp32": jreport.PEAK_FLOPS,
             "bytes": jreport.HBM_BW, "link_bytes": jreport.ICI_BW}
    spec = shapes.SHAPES[shape_name]
    for i, mesh in enumerate(MESHES):
        flops, hbm, coll = _counts(LM_ARCH_IDS.index(arch) * 8 + SHAPE_NAMES.index(shape_name)
                                   + i)
        base = {"arch": arch, "shape": shape_name, "mesh": mesh, "kind": spec.kind,
                "seq_len": spec.seq_len, "global_batch": spec.global_batch, "status": "ok",
                "devices": 512 if mesh == "multi_pod" else 256}
        want = jreport.roofline_row(dict(base, parsed={
            "flops": flops, "hbm_bytes": hbm, "collective_bytes": coll}))
        got = report.roofline_row(dict(base, counted={
            "flops": flops, "hbm_bytes": hbm, "collective_bytes": coll}), peaks=peaks)
        for k in ("t_compute_s", "t_memory_s", "t_memory_upper_s", "t_collective_s",
                  "model_flops_per_dev", "useful_ratio", "roofline_fraction", "dominant",
                  "arch", "shape", "mesh", "kind"):
            assert got[k] == want[k], k
        assert got["counted_flops_per_dev"] == want["hlo_flops_per_dev"]
        assert got["fits"] is None  # the reference's peaks name no memory size
    assert report.roofline_row({"status": "skipped"}) is None


def test_published_peaks_of_the_h100():
    key, peaks = report.peaks_for("NVIDIA H100 80GB HBM3")
    assert key == report.DEFAULT_CARD == "H100 80GB HBM3"
    assert peaks == dict(fp32=67e12, tf32=495e12, bf16=989e12, bytes=3.35e12,
                         memory=80e9, link_bytes=450e9)
    with pytest.raises(RuntimeError, match="no published peaks"):
        report.peaks_for("NVIDIA A100-SXM4-40GB")


def test_roofline_row_uses_the_step_dtypes_peak():
    cfg = get_config("qwen2-0.5b")
    assert cfg.dtype == "bfloat16"
    rec = {"arch": cfg.name, "shape": "decode_32k", "mesh": "data=1,model=1", "kind": "decode",
           "seq_len": 32_768, "global_batch": 128, "status": "ok", "devices": 1,
           "mesh_sizes": {"data": 1, "model": 1},
           "memory": {"peak_estimate_bytes": 81e9},
           "counted": {"flops": 989e9, "hbm_bytes": 1.0, "collective_bytes": 0.0}}
    row = report.roofline_row(rec)
    assert row["t_compute_s"] == 989e9 / 989e12
    assert row["t_memory_s"] == (51_539_607_552 + 4 * 494_032_768) / 3.35e12
    assert row["dominant"] == "memory" and row["fits"] is False
    assert "TPU" not in row["note"] and "MXU" not in row["note"]


def _chain(a, b):
    c = a @ b
    d = torch.relu(c)
    del c
    return d.sum()


@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_trace_cost_counts_a_known_chain_exactly(device):
    a = torch.ones(64, 128, device=device)
    b = torch.ones(128, 256, device=device)
    r = trace_cost(_chain, a, b)
    assert r.flops == 2 * 64 * 128 * 256
    assert r.flops_by_op == {"aten.mm": 2 * 64 * 128 * 256}
    assert r.op_count == 3
    c = 64 * 256 * 4
    assert r.peak_live_bytes == 2 * c  # c and relu(c) alive together; a and b are arguments
    assert r.bytes_accessed == (4 * 64 * 128 + 4 * 128 * 256 + c) + 2 * c + (c + 4)
    assert r.result.shape == ()


def _grad_chain(x, w):
    w = w.detach().requires_grad_()
    y = torch.tanh(x @ w)
    (g,) = torch.autograd.grad(y.sum(), w)
    return g


@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_trace_cost_counts_the_backward_and_repeats(device):
    """A product's forward and both halves of its backward (only the
    weight's gradient is asked for: one product), and a loop whose repeated
    calls the meta trace answers from its memo: the same counts on both
    devices."""
    x = torch.ones(32, 48, device=device)
    w = torch.ones(48, 16, device=device)
    r = trace_cost(_grad_chain, x, w)
    assert r.flops == 2 * (2 * 32 * 48 * 16)

    def loop(x, w):
        for _ in range(5):
            x = torch.relu(x @ w) * 0.5
        return x

    sq = torch.ones(24, 24, device=device)
    r = trace_cost(loop, sq, sq)
    assert r.flops == 5 * 2 * 24 ** 3
    assert r.op_count == 15
    # on meta the first pass runs its 3 operators, the 4 after it come from the memo
    assert r.memo_hits == (12 if device == "meta" else 0)
    # the previous x, the product and its relu, before the scale's output replaces them
    assert r.peak_live_bytes == 3 * 24 * 24 * 4


def test_trace_cost_is_the_same_on_meta_and_cpu_for_a_reduced_prefill():
    cfg = get_config("qwen2-0.5b").reduced()
    meta_step, meta_args, _ = dryrun_lib.step_call(cfg, "prefill_32k", 2, 96)
    gen = torch.Generator().manual_seed(0)
    from repro_torch.distributed.steps import init_cache
    from repro_torch.layers.params import init_params

    params = init_params(get_model(cfg).schema(cfg), gen, cfg.weight_dtype, "cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 96), generator=gen, dtype=torch.int32)
    cpu = trace_cost(meta_step, params, {"tokens": tokens}, init_cache(cfg, 2, 96, device="cpu"))
    meta = trace_cost(meta_step, *meta_args)
    for k in ("flops", "flops_by_op", "peak_live_bytes", "bytes_accessed", "op_count"):
        assert getattr(meta, k) == getattr(cpu, k), k
    assert math.isfinite(float(cpu.result[0].abs().max()))
