"""ABPN's epilogue (``kernels.epilogue``) on the CPU: the plain version
against a per-pixel loop of the index convention the card's kernel follows,
the wrapper's routing and checks, and the session's count of frames whose
epilogue ran through the kernel (none here).  The kernel itself is held to
the plain version in ``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from repro_torch import engine
from repro_torch.engine import executor, spans
from repro_torch.engine.server import SRServer
from repro_torch.kernels import epilogue
from repro_torch.models.abpn import init_abpn

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _port_tuning_db(tmp_path, monkeypatch):
    """Sessions default to ``autotune="cached"``: keep any tuning DB this
    file's sessions touch inside ``tmp_path``."""
    monkeypatch.setenv("REPRO_SR_TORCH_TUNING_DB", str(tmp_path / "tuning.json"))


def _inputs(seed, n, h, w, c, s, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    feats = torch.from_numpy(rng.normal(0.0, 0.4, (n, h, w, c * s * s)).astype(np.float32))
    x = torch.from_numpy(rng.uniform(0.0, 1.0, (n, h, w, c)).astype(np.float32))
    return feats.to(dtype), x.to(dtype)


def _loop(feats, x, s, clip):
    """``out[y*s+dy, x*s+dx, c] = f[y, x, c*s*s + dy*s + dx] + x[y, x, c]``,
    a pixel at a time in fp32 numpy, then the clip."""
    f, lr = feats.numpy(), x.numpy()
    n, h, w, c = lr.shape
    out = np.zeros((n, h * s, w * s, c), np.float32)
    for b in range(n):
        for y in range(h):
            for px in range(w):
                for cc in range(c):
                    for dy in range(s):
                        for dx in range(s):
                            v = f[b, y, px, cc * s * s + dy * s + dx] + lr[b, y, px, cc]
                            out[b, y * s + dy, px * s + dx, cc] = v
    return np.clip(out, 0.0, 1.0) if clip else out


@pytest.mark.parametrize("clip", [True, False], ids=["clip", "noclip"])
@pytest.mark.parametrize("scale", [2, 3, 4])
def test_plain_matches_the_index_convention(scale, clip):
    feats, x = _inputs(scale, 2, 3, 5, 3, scale)
    got = epilogue.sr_epilogue_plain(feats, x, scale=scale, clip=clip, out_dtype=torch.float32)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 3 * scale, 5 * scale, 3)
    np.testing.assert_array_equal(got.numpy(), _loop(feats, x, scale, clip))


def test_plain_reads_a_strided_view_as_its_copy():
    """K1's output reaches the epilogue as a view (Chp channels a pixel, a
    cropped column range): the result is that of its contiguous copy."""
    rng = np.random.default_rng(5)
    full = torch.from_numpy(rng.normal(size=(2, 4, 9, 32)).astype(np.float32))
    view = full[:, :, 1:8, :27]
    _, x = _inputs(6, 2, 4, 7, 3, 3)
    got = epilogue.sr_epilogue_call(view, x, scale=3, clip=True, out_dtype=torch.float32)
    want = epilogue.sr_epilogue_plain(view.contiguous(), x, scale=3, clip=True,
                                      out_dtype=torch.float32)
    assert torch.equal(got, want)


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_executor_epilogue_takes_the_plain_version_on_the_cpu(precision):
    plan = engine.make_plan(init_abpn(torch.Generator().manual_seed(0)), (6, 8, 3),
                            backend="tilted", band_rows=6, precision=precision, scale=3)
    dt = executor.compute_dtype_for(precision)
    feats, x = _inputs(7, 2, 6, 8, 3, 3, dt)
    launches = epilogue.sr_epilogue_call.launches
    clock = spans.StageClock(torch.device("cpu"))
    with clock.active():
        got = executor.sr_epilogue(plan, x, feats, torch.float32)
    want = epilogue.sr_epilogue_plain(feats, x, scale=3, clip=plan.clip, out_dtype=torch.float32)
    assert torch.equal(got, want) and got.dtype == torch.float32
    assert epilogue.sr_epilogue_call.launches == launches
    assert clock.kernels == set()  # no kernel noted on the dispatch's clock


def test_meta_tensors_run_the_plain_version():
    """``plan_cost`` traces the executor on ``meta`` tensors: the epilogue
    gives the HR shape and dtype there and launches nothing."""
    feats = torch.empty((2, 6, 8, 27), device="meta")
    x = torch.empty((2, 6, 8, 3), device="meta")
    launches = epilogue.sr_epilogue_call.launches
    out = epilogue.sr_epilogue_call(feats, x, scale=3, clip=True, out_dtype=torch.bfloat16)
    assert out.device.type == "meta" and tuple(out.shape) == (2, 18, 24, 3)
    assert out.dtype == torch.bfloat16 and epilogue.sr_epilogue_call.launches == launches


@pytest.mark.parametrize("case", ["channels", "frames", "rank", "scale"])
def test_wrapper_refuses_shapes_that_do_not_fit(case):
    feats, x = _inputs(8, 2, 3, 4, 3, 3)
    bad = {
        "channels": (feats[..., :26], x, 3),  # 26 != 3 * 9
        "frames": (feats, x[:1], 3),
        "rank": (feats[0], x[0], 3),
        "scale": (feats, x, 0),
    }[case]
    with pytest.raises(ValueError):
        epilogue.sr_epilogue_call(bad[0], bad[1], scale=bad[2], clip=True,
                                  out_dtype=torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("clip", [True, False], ids=["clip", "noclip"])
@pytest.mark.parametrize("scale", [2, 3, 4])
def test_kernel_backward_is_the_plain_chains_gradient(scale, clip, dtype):
    """On the card autograd records the kernel with ``_chain_grads`` as its
    backward: the features' gradient is the plain chain's bit for bit (a
    NaN and values either side of the clip included), the LR input's its
    sum over each channel's anchored copies."""
    feats, x = _inputs(20 + scale, 2, 3, 5, 3, scale, dtype)
    feats[0, 1, 2, 0] = float("nan")
    f, lr = feats.clone().requires_grad_(), x.clone().requires_grad_()
    hr = epilogue.sr_epilogue_plain(f, lr, scale=scale, clip=clip, out_dtype=torch.float32)
    grad = torch.from_numpy(np.random.default_rng(scale).normal(size=hr.shape).astype(np.float32))
    want_f, want_x = torch.autograd.grad(hr, (f, lr), grad)
    got_f, got_x = epilogue._chain_grads(feats, x, grad, scale, clip)
    assert got_f.dtype == want_f.dtype == dtype and torch.equal(got_f, want_f)
    torch.testing.assert_close(got_x, want_x)


def test_epilogue_kernel_frames_is_counted_and_reset():
    session = engine.SRSession(init_abpn(torch.Generator().manual_seed(3)), backend="tilted",
                               device="cpu", autotune="off", max_bucket=4)
    server = SRServer({"abpn": session})
    clip = np.random.default_rng(9).random((6, 12, 16, 3), dtype=np.float32)
    server.submit(clip).result()
    st = session.stats()
    assert st["epilogue_frames"] == 6 and st["epilogue_kernel_frames"] == 0
    # a dispatch whose epilogue went through the kernel, as the card's do
    clock = spans.StageClock(torch.device("cpu"))
    with clock.active():
        spans.mark("epilogue")
        clock.kernels.add("epilogue")  # as the kernel's wrapper notes a launch
        spans.mark(None)
    session._note_stages(clock, 4)
    st = session.stats()
    assert st["epilogue_frames"] == 10 and st["epilogue_kernel_frames"] == 4
    session.reset_stats()
    assert session.stats()["epilogue_kernel_frames"] == 0


def test_plain_version_carries_gradients():
    """Training runs through the executor's epilogue (``engine.run``): the
    plain chain is differentiable, the clip passing gradient only inside
    [0, 1]."""
    feats, x = _inputs(10, 1, 2, 3, 3, 2)
    feats.requires_grad_()
    hr = epilogue.sr_epilogue_call(feats, x, scale=2, clip=True, out_dtype=torch.float32)
    (g,) = torch.autograd.grad(hr.sum(), feats)
    v = feats.detach() + torch.repeat_interleave(x, 4, dim=-1)
    assert torch.equal(g, ((v >= 0) & (v <= 1)).float())

