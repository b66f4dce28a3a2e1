"""The port's data slice (``repro_torch.data``) against the JAX package's, on
the CPU: twins of ``tests/test_runtime.py``'s data tests (LM batches
deterministic and learnable, SR pairs consistent, the prefetcher's order
and close), the entry helpers' default device, ``downsample`` bit-identical to the JAX package's, and the
bilinear resize of the SR textures against ``jax.image.resize`` on the same
coarse arrays.

The port draws its numbers from ``torch.Generator``s, not ``jax.random``, so
the port-vs-JAX checks hand both packages the same numpy arrays.  The
resize tolerance is ``atol=1e-6`` on values in [0, 1]: each output is a
weighted sum of up to four inputs whose weights the two libraries compute
in fp32 in another order (a few ulps at 1.0, 1.2e-7 measured).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import synthetic as jsyn
from repro_torch.configs import get_config
from repro_torch.data import synthetic as syn
from repro_torch.data.pipeline import Prefetcher, make_lm_stream


def test_lm_batches_deterministic_and_learnable():
    cfg = get_config("qwen2-0.5b").reduced()
    a = syn.lm_batch(cfg, 5, 4, 32)
    b = syn.lm_batch(cfg, 5, 4, 32)
    assert torch.equal(a["tokens"], b["tokens"])
    c = syn.lm_batch(cfg, 6, 4, 32)
    assert not torch.equal(a["tokens"], c["tokens"])
    assert not torch.equal(a["tokens"], syn.lm_batch(cfg, 5, 4, 32, seed=1)["tokens"])
    # next-token structure: targets are the shifted stream
    assert torch.equal(a["tokens"][:, 1:], a["targets"][:, :-1])
    for key in ("tokens", "targets", "mask"):
        assert a[key].dtype == torch.int32 and a[key].shape == (4, 32)
    assert int(a["tokens"].max()) < cfg.vocab_size and bool((a["mask"] == 1).all())


def test_lm_batch_follows_the_reference_recipe():
    """Each row is the reference's progression ``(start + stride * pos) %
    vocab`` with a stride in [1, 7)."""
    cfg = get_config("qwen2-0.5b").reduced()
    b = syn.lm_batch(cfg, 3, 8, 20)
    stream = torch.cat([b["tokens"], b["targets"][:, -1:]], dim=1).long()
    stride = (stream[:, 1] - stream[:, 0]) % cfg.vocab_size
    assert bool(((stride >= 1) & (stride < 7)).all())
    pos = torch.arange(21)
    assert torch.equal(stream, (stream[:, :1] + stride[:, None] * pos) % cfg.vocab_size)


def test_sr_pairs_consistent():
    lr, hr = syn.sr_pair_batch(3, 2, lr_shape=(12, 16), scale=3)
    assert lr.shape == (2, 12, 16, 3) and hr.shape == (2, 36, 48, 3)
    assert lr.dtype == hr.dtype == torch.float32
    torch.testing.assert_close(syn.downsample(hr[0], 3), lr[0], atol=1e-6, rtol=0)
    assert float(hr.min()) >= 0.0 and float(hr.max()) <= 1.0
    again, _ = syn.sr_pair_batch(3, 2, lr_shape=(12, 16), scale=3)
    assert torch.equal(again, lr)
    other, _ = syn.sr_pair_batch(4, 2, lr_shape=(12, 16), scale=3)
    assert not torch.equal(other, lr)


def test_prefetcher_orders_and_closes():
    seen = []
    pf = Prefetcher(lambda s: {"x": s}, depth=2)
    for _ in range(5):
        step, batch = next(pf)
        seen.append((step, batch["x"]))
    pf.close()
    assert seen == [(i, i) for i in range(5)]
    assert not pf._thread.is_alive()


def test_make_lm_stream_yields_lm_batches_from_its_start_step():
    cfg = get_config("qwen2-0.5b").reduced()
    pf = make_lm_stream(cfg, 2, 8, seed=3, start_step=4, device="cpu")
    try:
        for want_step in (4, 5, 6):
            step, batch = next(pf)
            assert step == want_step
            assert torch.equal(batch["tokens"], syn.lm_batch(cfg, step, 2, 8, 3)["tokens"])
    finally:
        pf.close()


@pytest.mark.parametrize("entry", ["init_cache", "make_lm_stream"])
def test_entry_helpers_default_to_the_card(entry, monkeypatch):
    """``steps.init_cache`` and ``make_lm_stream`` run on the card unless the
    caller asks for the CPU: without one they raise, they never carry on
    on the CPU."""
    from repro_torch.distributed.steps import init_cache

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("qwen2-0.5b").reduced()
    make = {"init_cache": lambda **kw: init_cache(cfg, 2, 8, **kw),
            "make_lm_stream": lambda **kw: make_lm_stream(cfg, 2, 8, **kw)}[entry]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make()
    made = make(device="cpu")
    if entry == "make_lm_stream":
        assert next(made)[1]["tokens"].device.type == "cpu"
        made.close()
    else:
        assert made["layers"]["k"].device.type == "cpu"


@pytest.mark.parametrize("scale", [2, 3, 4])
def test_downsample_bit_identical_to_jax(scale):
    rng = np.random.default_rng(scale)
    hr = rng.uniform(size=(2, 12 * scale, 10 * scale, 3)).astype(np.float32)
    want = np.stack([np.asarray(jsyn.downsample(jnp.asarray(im), scale)) for im in hr])
    np.testing.assert_array_equal(syn.downsample(torch.from_numpy(hr), scale).numpy(), want)


@pytest.mark.parametrize("h,w,f", [(36, 48, 4), (36, 48, 8), (36, 48, 16), (12, 16, 16),
                                   (180, 192, 4), (72, 72, 8)])
def test_bilinear_resize_matches_jax_image_resize(h, w, f):
    """The textures' upsampling, on the coarse shapes ``_smooth_noise`` draws
    (a 1-pixel coarse grid included)."""
    rng = np.random.default_rng(h * w + f)
    coarse = rng.uniform(size=(max(h // f, 1), max(w // f, 1), 3)).astype(np.float32)
    got = syn.bilinear_resize(torch.from_numpy(coarse), h, w).numpy()
    want = np.asarray(jax.image.resize(jnp.asarray(coarse), (h, w, 3), "bilinear"))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_batches_for_a_card_are_copied_from_pinned_memory(monkeypatch):
    """``to_device`` pins before a non-blocking copy (a pageable copy would
    synchronize the stream); on the CPU it returns the tensor itself."""
    t = torch.arange(6)
    assert syn.to_device(t, "cpu") is t
    calls = []

    class Pinned:
        def to(self, device, non_blocking=False):
            calls.append((str(device), non_blocking))
            return "on-device"

    monkeypatch.setattr(torch.Tensor, "pin_memory", lambda self: Pinned())
    assert syn.to_device(t, "cuda") == "on-device"
    assert calls == [("cuda", True)]
