"""Model families, on the CPU: the harness finds a configuration's weights,
server, plain reference and work count through the configuration's
``family`` key, in ``bench/families/<family>.py``.

ABPN's readings are pinned to what the harness read before its code moved
into ``families/abpn.py``: the same seed gives the same weights, frames,
reference output and FLOPs.  A second family, written into a copy of
``bench/`` with weights of another structure, runs a whole cell with no
file of the harness edited.
"""

import hashlib
import json
import shutil
import time
from pathlib import Path

import pytest
import torch

from harness import cell, check, inputs, registry

BENCH = registry.BENCH
REPO = BENCH.parent
SEED = 99

FLOPS = {"abpn_x3": 19_740_672_000, "abpn_x4": 22_179_225_600}

# each layer's weight and bias for seed 99 on the CPU: the first 16 hex
# digits of the sha256 of their bytes, and the layer's ReLU flag
LAYERS = {
    "abpn_x3": [
        ("6a03a968ceccdd5f", "2a87f6b80c947d7b", True),
        ("aae15365b21f8515", "f4d95cf197c7e18a", True),
        ("0ea4cdab8de8db4b", "7f336ea1a1c5d539", True),
        ("f928aeb12ba75b12", "d2614d9d9f14c31a", True),
        ("8638ffc4573a2bae", "a9aecf4d36cf9378", True),
        ("6e19e035f446cc6b", "f4b9e9e48997ad81", True),
        ("6b4d74eb5a11941c", "56889f81ea15f9d2", False),
    ],
    "abpn_x4": [
        ("6a03a968ceccdd5f", "20b12ca0dfa6e82f", True),
        ("aae15365b21f8515", "5266533aca01125d", True),
        ("0ea4cdab8de8db4b", "1d5d1b49980ad4bf", True),
        ("f928aeb12ba75b12", "4ee00615ee824af7", True),
        ("8638ffc4573a2bae", "b023c5ae34a6f08d", True),
        ("6e19e035f446cc6b", "1148d8e77e7f9fbb", True),
        ("b5fe8e67bdd92725", "44f51de8eb938254", False),
    ],
}
POOL = "7e09c5390fbe0c0c"  # two 60x64 LR frames of seed 99
# the reference's HR frame of the pool's first frame in 30-row bands, in
# float64: its sum, its sum of squares and its sum weighted by a ramp over
# the flat index.  Held to 1e-6 of each, not bit for bit: another CPU may
# sum a convolution in another order.
REFERENCE = {
    ("abpn_x3", "fp32"): (53281.10078122676, 36217.09900237026, 26578.662477281392),
    ("abpn_x3", "tf32"): (53280.48619140498, 36216.46232465076, 26578.351072884197),
    ("abpn_x3", "fp8"): (53114.00722022192, 36052.696336132256, 26501.912344587447),
    ("abpn_x4", "fp32"): (90749.80640942801, 60331.59055523563, 45263.09291407956),
    ("abpn_x4", "tf32"): (90748.66391718481, 60330.39539253805, 45262.504402750725),
    ("abpn_x4", "fp8"): (90669.28967626259, 60319.88559271118, 45230.046235743604),
}


def _sha(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()[:16]


def _config(name: str) -> dict:
    return registry.config(registry.load_benchmark(), name)


def _small(cfg: dict) -> dict:
    cfg = dict(cfg, lr_height=60, lr_width=64)
    cfg["serving"] = dict(cfg["serving"], band_rows=30)
    return cfg


@pytest.mark.parametrize("config", sorted(FLOPS))
def test_abpn_flops_per_frame_is_pinned(config):
    cfg = _config(config)
    assert registry.family(cfg).flops_per_frame(cfg) == FLOPS[config]


@pytest.mark.parametrize("config", sorted(FLOPS))
def test_abpn_weights_and_frames_are_pinned(config):
    cfg = _config(config)
    layers = registry.family(cfg).make_weights(cfg, SEED, "cpu")
    got = [(_sha(w.numpy().tobytes()), _sha(b.numpy().tobytes()), r) for w, b, r in layers]
    assert got == LAYERS[config]
    assert _sha(inputs.make_pool(_small(cfg), 2, SEED).tobytes()) == POOL


@pytest.mark.parametrize("config,precision", sorted(REFERENCE))
def test_abpn_reference_is_pinned(config, precision):
    cfg = _small(_config(config))
    family = registry.family(cfg)
    lr = torch.from_numpy(inputs.make_pool(cfg, 2, SEED)[:1])
    with family.exact():
        hr = family.reference(lr, family.make_weights(cfg, SEED, "cpu"), cfg, precision)
    s = int(cfg["scale"])
    assert hr.shape == (1, 60 * s, 64 * s, 3)
    hr = hr.to(torch.float64)
    ramp = torch.linspace(0, 1, hr.numel(), dtype=torch.float64).reshape(hr.shape)
    got = (hr.sum().item(), (hr * hr).sum().item(), (hr * ramp).sum().item())
    assert got == pytest.approx(REFERENCE[config, precision], rel=1e-6)


def test_an_unknown_family_names_the_missing_file(tmp_path):
    with pytest.raises(KeyError, match="families/nonesuch.py"):
        registry.family({"family": "nonesuch"})
    with pytest.raises(KeyError, match=str(tmp_path / "families" / "abpn.py")):
        registry.family({"family": "abpn"}, tmp_path)


# a family whose weights are a dict of named convolutions: it flattens them
# into the port's stack to serve, and into ABPN's reference to check
DICT_FAMILY = '''"""ABPN's stack with its weights in a dict of named convolutions."""

from pathlib import Path

from harness import registry
from reference import abpn as ref

_abpn = registry.family({"family": "abpn"}, Path(__file__).resolve().parents[1])
exact = ref.exact


def make_weights(cfg, seed, device):
    return {f"conv{i}": {"w": w, "b": b, "relu": r}
            for i, (w, b, r) in enumerate(_abpn.make_weights(cfg, seed, device))}


def _stack(weights):
    order = sorted(weights, key=lambda name: int(name[len("conv"):]))
    return [(weights[k]["w"], weights[k]["b"], weights[k]["relu"]) for k in order]


def open_server(cfg, weights, device, backend=None):
    from repro_torch.core.fusion import ConvLayer
    from repro_torch.engine import SRServer

    serving = dict(cfg["serving"], **({"backend": backend} if backend else {}))
    stack = [ConvLayer(w=w, b=b, relu=r) for w, b, r in _stack(weights)]
    return SRServer.open(cfg["model"], layers=stack, scale=int(cfg["scale"]),
                         device=str(device), **serving)


def reference(lr, weights, cfg, precision="fp32"):
    return ref.abpn(lr, _stack(weights), int(cfg["scale"]), int(cfg["serving"]["band_rows"]),
                    precision)


def flops_per_frame(cfg):
    return _abpn.flops_per_frame(cfg)
'''


def _digests(root: Path, parts) -> dict:
    out = {}
    for part in parts:
        files = [root / part] if (root / part).is_file() else sorted((root / part).rglob("*"))
        out.update({p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
                    for p in files if p.is_file() and "__pycache__" not in p.parts})
    return out


def test_a_second_family_runs_a_cell_without_an_edit_to_the_harness(tmp_path):
    harness_files = ("harness", "run.py", "tools")
    real = _digests(BENCH, harness_files)
    new = tmp_path / "bench"
    shutil.copytree(BENCH, new, ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    (new / "families" / "dictnet.py").write_text(DICT_FAMILY)
    cfg = json.loads((new / "configs" / "abpn_x3.json").read_text())
    cfg.update(name="dictnet_x3", family="dictnet")
    (new / "configs" / "dictnet_x3.json").write_text(json.dumps(cfg))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(bench["configs"][0], name="dictnet_x3",
                                 file="bench/configs/dictnet_x3.json"))
    bench["workloads"].append(dict(name="x3_dictnet_vod", config="dictnet_x3", traffic="vod",
                                   chips=1, why="a test cell"))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    b = registry.load_benchmark(tmp_path)
    wl = registry.workload(b, "x3_dictnet_vod")
    cfg = registry.config(b, wl["config"], tmp_path)
    cfg.update(lr_height=60, lr_width=40)
    cfg["serving"].update(band_rows=30, max_bucket=4)
    tr = registry.traffic(wl["traffic"], new)
    tr.update(pool_frames=24, warm_seconds=0.2, warm_max_bucket=4, sample_requests=64,
              sample_frames=4, clients=2, frames_per_request=6)
    record, checks, _ = cell.run(wl, cfg, tr, 2 ** 31 + 5, 0.6, True, "cpu", time.time(),
                                 backend="tilted", bench_dir=new)

    assert check.correct(checks), checks
    assert checks["frames_compared"]["value"] >= 2
    assert Path(record.family.__file__) == new / "families" / "dictnet.py"
    assert isinstance(record.family.make_weights(cfg, 1, "cpu"), dict)
    assert record.flops_per_frame == 2 * 60 * 40 * 9 * (3 * 28 + 28 * 28 * 5 + 28 * 27)
    # the family counts no executed FLOPs: the traced run asks for none,
    # and the reader of that ratio finds nothing, where mfu finds its number
    assert record.trace is not None and record.k1_executed_flops is None
    assert registry.reader("k1_work_ratio.vod")(record) is None
    assert registry.reader("mfu.vod")(record) > 0
    # adding the family wrote nothing of the harness
    assert _digests(new, harness_files) == real == _digests(BENCH, harness_files)
