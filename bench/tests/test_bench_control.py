"""The correctness check can fail: on the CPU, at a size a test run holds.

* The control — the reference computed in the nearest precision below the
  configuration's (TF32 for fp32, float8 e4m3 for bf16), put in the
  program's place — reads above each configuration's limit, where the port
  reads below it.
* A run of each cell, with the harness's look for a card skipped and the
  timed path broken underneath, comes out not correct: a served frame
  altered where it is produced; the back half of each dispatch's batch left
  out; the frames of a dispatch handed to the wrong requests.
"""

import time

import pytest
import torch

from harness import cell, check, clients, inputs, registry

BENCH = registry.BENCH
SEEDS = (2 ** 31 + 1, 7, 1234)


CELLS = {"x3_fp32_vod": ("abpn_x3", "vod"), "x4_bf16_vod": ("abpn_x4", "vod")}


def small(workload: str):
    bench = registry.load_benchmark()
    config, mix = CELLS[workload]
    wl = {"name": workload, "config": config, "traffic": mix, "chips": 1}
    cfg = registry.config(bench, config)
    cfg.update(lr_height=60, lr_width=40)
    # requests longer than the largest dispatch, as on the card: each spans
    # a full bucket and a carry
    cfg["serving"].update(band_rows=30, max_bucket=4)
    tr = registry.traffic(mix)
    tr.update(pool_frames=24, warm_seconds=0.2, warm_max_bucket=4, sample_requests=64,
              sample_frames=4, clients=2, frames_per_request=6)
    return wl, cfg, tr


def serve(workload: str, seed: int, seconds: float = 0.6):
    wl, cfg, tr = small(workload)
    _, checks, _ = cell.run(wl, cfg, tr, seed, seconds, False, "cpu", time.time(),
                            backend="tilted")
    return checks


@pytest.mark.parametrize("config", ["abpn_x3", "abpn_x4"])
def test_control_reads_above_the_limit(config):
    bench = registry.load_benchmark()
    cfg = registry.config(bench, config)
    cfg.update(lr_height=60, lr_width=40)
    cfg["serving"]["band_rows"] = 30
    control = check.CONTROL[cfg["serving"]["precision"]]
    limit = float(cfg["limits"]["max_abs_err"])
    family = registry.family(cfg)
    for seed in SEEDS:
        sample = [(clients.Request(rid=0, n=2, start=0), [0, 1], None)]
        got = check.compare(sample, cfg, family, 2, seed, "cpu", precision=control)
        assert got["frames"] == 2
        assert got["max_abs_err"] > limit, (seed, got, limit)


@pytest.mark.parametrize("workload", sorted(CELLS))
def test_a_sound_run_is_correct(workload):
    checks = serve(workload, SEEDS[0])
    assert check.correct(checks), checks
    assert checks["frames_compared"]["value"] >= 2


def _altered(orig):
    def epilogue(plan, x, feats, in_dtype):
        hr = orig(plan, x, feats, in_dtype).clone()
        hr[:, 5, 7, 1] = torch.remainder(hr[:, 5, 7, 1] + 0.5, 1.0)
        return hr
    return epilogue


def _half_left_out(orig):
    def features(plan, layers, frames, packed=None):
        feats = orig(plan, layers, frames, packed)
        n = frames.shape[0]
        return torch.cat([feats[:n - n // 2], torch.zeros_like(feats[n - n // 2:])])
    return features


def _mixed_up(orig):
    def execute(plan, stack, frames):
        return torch.roll(orig(plan, stack, frames), 1, dims=0)
    return execute


FAULTS = {
    "frame_altered": ("sr_epilogue", _altered),
    "half_batch_left_out": ("sr_features", _half_left_out),
    "frames_to_wrong_requests": ("_execute_stack", _mixed_up),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload", sorted(CELLS))
def test_a_broken_timed_path_is_not_correct(workload, fault, monkeypatch):
    from repro_torch.engine import executor

    name, make = FAULTS[fault]
    monkeypatch.setattr(executor, name, make(getattr(executor, name)))
    checks = serve(workload, SEEDS[1])
    assert not check.correct(checks), checks


def test_weights_and_frames_are_made_again_alike():
    """The check makes the reference's weights and frames again from the
    seed: the same numbers the program was handed."""
    _, cfg, tr = small("x4_bf16_vod")
    family = registry.family(cfg)
    a = family.make_weights(cfg, 99, "cpu")
    b = family.make_weights(cfg, 99, "cpu")
    assert all(torch.equal(x[0], y[0]) and torch.equal(x[1], y[1]) for x, y in zip(a, b))
    assert (inputs.make_pool(cfg, 4, 99) == inputs.make_pool(cfg, 4, 99)).all()
    assert all(bool((x[1] != 0).any()) for x in a)  # the bias path is checked
