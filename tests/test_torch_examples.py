"""The port's training entry point and example twins on the CPU:
``repro_torch.launch.train.main`` (the twin of ``test_lm_train_cli_runs``,
and the reduced vlm config), the twin of ``test_train_abpn_improves_psnr``
through ``examples/torch_train_abpn.py``'s own step, each example twin
(``examples/torch_{quickstart,serve_sr,train_abpn,serve_lm}.py``) run with
``--device cpu`` at a tiny size, and every new entry point refusing
``--device cuda`` where there is no card.

The ABPN recipe starts from the JAX package's ``init_abpn`` weights, carried
across with ``layers_from_numpy``; its batches come from the port's
``data.synthetic``.
"""

import importlib.util
import os

import jax
import numpy as np
import pytest
import torch

from repro.models.abpn import ABPNConfig as JaxABPNConfig
from repro.models.abpn import init_abpn as jax_init_abpn
from repro_torch.data.synthetic import sr_pair_batch
from repro_torch.launch import train as ttrain
from repro_torch.models.abpn import ABPNConfig, layers_from_numpy

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples")


def _example(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(EXAMPLES, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def _port_tuning_db(tmp_path, monkeypatch):
    """Sessions default to ``autotune="cached"``: the port's tuning DB goes
    to this test's ``tmp_path``."""
    monkeypatch.setenv("REPRO_SR_TORCH_TUNING_DB", str(tmp_path / "tuning.json"))


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "internvl2-1b"])
def test_lm_train_cli_runs(arch, tmp_path, capsys):
    rc = ttrain.main(["--arch", arch, "--steps", "8", "--batch", "2", "--seq", "32",
                      "--ckpt-dir", str(tmp_path), "--checkpoint-every", "0",
                      "--log-every", "4", "--device", "cpu"])
    assert rc == 0
    out = capsys.readouterr().out
    assert f"arch={arch} reduced=True devices=1" in out
    assert "step     4 loss" in out and "done: loss" in out and "restarts=0" in out


def test_lm_train_cli_checkpoints_and_resumes(tmp_path, capsys):
    """Checkpoints every 3 steps; a second run on the same directory resumes
    after the newest one and trains only the remaining steps."""
    argv = ["--steps", "6", "--batch", "2", "--seq", "16", "--ckpt-dir", str(tmp_path),
            "--checkpoint-every", "3", "--log-every", "1", "--device", "cpu"]
    assert ttrain.main(argv) == 0
    assert sorted(os.listdir(tmp_path)) == ["step_000000002", "step_000000005"]
    capsys.readouterr()
    ttrain.main(argv[:1] + ["8"] + argv[2:])
    out = capsys.readouterr().out
    assert "step     6 loss" in out and "step     5 loss" not in out


def test_train_abpn_improves_psnr():
    """Twin of tests/test_system.py::test_train_abpn_improves_psnr: 60 SGD
    steps at lr 0.02 (12 channels, 4 layers, 24x24) through the example's
    own step beat the starting PSNR by more than 0.5 dB."""
    ex = _example("torch_train_abpn")
    jcfg = JaxABPNConfig(feature_channels=12, num_layers=4)
    cfg = ABPNConfig(feature_channels=12, num_layers=4)
    layers = ex.trainable(layers_from_numpy(jax_init_abpn(jax.random.PRNGKey(0), jcfg)))
    lr_img, hr_img = sr_pair_batch(0, 4, lr_shape=(24, 24), scale=3)
    with torch.no_grad():
        before = ex.psnr(ex.upscale(layers, lr_img, cfg), hr_img)
    losses = []
    for i in range(60):
        lr_b, hr_b = sr_pair_batch(i, 4, lr_shape=(24, 24), scale=3)
        losses.append(float(ex.sgd_step(layers, lr_b, hr_b, cfg, 0.02)))
    with torch.no_grad():
        after = ex.psnr(ex.upscale(layers, lr_img, cfg), hr_img)
    assert after > before + 0.5, (before, after)
    assert losses[-1] < losses[0]


def test_abpn_reference_path_keeps_the_graph():
    """Weight preparation, ``sr_epilogue`` and the clip on the port's
    ``reference`` path pass gradients to every weight and bias."""
    ex = _example("torch_train_abpn")
    cfg = ABPNConfig(feature_channels=8, num_layers=3)
    rng = np.random.default_rng(0)
    layers = ex.trainable(layers_from_numpy([
        ((rng.normal(size=(3, 3, ci, co)) * 0.1).astype(np.float32),
         np.full((co,), 0.3, np.float32), i < 2)
        for i, (ci, co) in enumerate(zip(cfg.channels[:-1], cfg.channels[1:]))]))
    lr_b, _ = sr_pair_batch(1, 2, lr_shape=(6, 8), scale=3)
    out = ex.upscale(layers, lr_b, cfg)
    grads = torch.autograd.grad(out.sum(), [t for l in layers for t in (l.w, l.b)])
    assert all(bool((g != 0).any()) for g in grads)


def test_quickstart_twin_runs(capsys):
    assert _example("torch_quickstart").main(["--height", "60", "--width", "32",
                                               "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "reference vs tilted(halo): max|d| = 0.00e+00" in out
    assert "SRSession: 2 compiles, 0 hits for [(60, 32), (30, 32)]" in out
    assert "on-chip buffers: 102.86 KB" in out and "DRAM bandwidth reduction: 91.8%" in out


@pytest.mark.parametrize("extra", [[], ["--delta", "--backend", "tilted", "--precision", "fp32"]],
                         ids=["burst", "delta"])
def test_serve_sr_twin_runs(extra, capsys):
    argv = ["--frames", "4", "--batch", "2", "--height", "60", "--width", "32",
            "--device", "cpu"] + extra
    assert _example("torch_serve_sr").main(argv) == 0
    out = capsys.readouterr().out
    assert "falling back to single-device serving" in out
    if extra:
        assert "splice bit-exact vs full: True" in out
    else:
        assert "served 8 frames" in out and "plan cache: 2 compiles" in out


def test_serve_sr_twin_picks_the_largest_shardable_mesh():
    pick = _example("torch_serve_sr").pick_mesh
    assert pick((60, 30), 1) is None
    assert pick((120, 60), 4) is not None and pick((120, 60), 4)[0] * pick((120, 60), 4)[1] <= 4


def test_train_abpn_twin_runs(capsys):
    argv = ["--steps", "2", "--batch", "2", "--size", "12", "--device", "cpu"]
    assert _example("torch_train_abpn").main(argv) == 0
    out = capsys.readouterr().out
    assert "anchor (nearest-neighbour) baseline PSNR" in out and "step    1  loss" in out


def test_serve_lm_twin_runs(capsys):
    ex = _example("torch_serve_lm")
    assert ex.main(["--arch", "qwen2-0.5b", "--batch", "2", "--prompt-len", "8", "--gen", "4",
                    "--device", "cpu"]) == 0
    assert "arch=qwen2-0.5b batch=2 prompt=8 gen=4" in capsys.readouterr().out
    assert "--device" not in ex.DEFAULTS  # the default serves on the card


@pytest.mark.parametrize("entry", ["launch.train", "torch_quickstart", "torch_serve_sr",
                                   "torch_train_abpn", "torch_serve_lm"])
def test_entry_points_refuse_cuda_without_a_card(entry, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    main = ttrain.main if entry == "launch.train" else _example(entry).main
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--device", "cuda"])


def test_lm_train_cli_names_the_roadmap_item_of_an_unported_family(tmp_path, capsys):
    """The encoder-decoder family, the last one ported, trains through the
    CLI (this test held its "item 14f" error until then)."""
    rc = ttrain.main(["--arch", "seamless-m4t-large-v2", "--steps", "8", "--batch", "2",
                      "--seq", "32", "--ckpt-dir", str(tmp_path), "--checkpoint-every", "0",
                      "--log-every", "4", "--device", "cpu"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "arch=seamless-m4t-large-v2 reduced=True devices=1" in out
    assert "step     4 loss" in out and "done: loss" in out
