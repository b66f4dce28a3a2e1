"""The port's dry-run (``launch.dryrun_lib``, ``launch.dryrun``,
``roofline.report``, ``roofline.experiments_md``) — twins of
``tests/test_distributed.py::test_dryrun_reduced_cell`` and of the
reference's HLO FLOP count, plus the port's own depth extrapolation.

* A reduced cell on the production mesh of CPU positions is ``ok`` with
  FLOPs and a peak; a full-attention ``long_500k`` cell is ``skipped``.
* The FLOPs the port counts for one reduced cell of each kind (train,
  prefill, decode) on a ``(1, 1)`` mesh are within 5 % of the JAX
  package's HLO count (``parsed["flops"]``, run in a subprocess on one
  forced host device): 5 % is the bound the reference's own
  ``test_parser_vs_cost_analysis_unrolled`` holds its parser to.
* A stack traced at one and two units of depth and extrapolated gives what
  a trace of the whole stack gives, for every family and kind.
* ``run_all`` caches and reuses its records; the CLI and the markdown
  writer run.
"""

import json
import os
import subprocess
import sys

import jax
import pytest

from repro_torch.configs import get_config
from repro_torch.launch import dryrun_lib
from repro_torch.launch.dryrun_lib import run_all, run_cell
from repro_torch.launch.mesh import make_mesh
from repro_torch.roofline import experiments_md, report

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")


def test_dryrun_reduced_cell():
    """End-to-end dry-run machinery on the real production mesh shape."""
    rec = run_cell("qwen2-0.5b", "train_4k", multi_pod=False, reduced=True)
    assert rec["status"] == "ok", rec.get("error")
    assert rec["devices"] == 256 and rec["mesh_sizes"] == {"data": 16, "model": 16}
    assert rec["counted"]["flops"] > 0
    assert rec["memory"]["peak_estimate_bytes"] > 0
    assert rec["memory"]["peak_estimate_bytes"] == (rec["memory"]["argument_bytes"]
                                                    + rec["memory"]["temp_bytes"])
    assert rec["microbatches"] == 1
    assert "fits" not in rec  # roofline_row decides it, under the peaks it is given
    assert report.roofline_row(rec)["fits"] in (True, False)
    roomless = dict(report.PEAKS[report.DEFAULT_CARD], memory=0)
    assert "| ok | " in report.dryrun_table([rec]) and " | no | " in report.dryrun_table(
        [rec], roomless)
    json.dumps(rec)
    rec2 = run_cell("qwen3-14b", "long_500k", multi_pod=False, reduced=True)
    assert rec2["status"] == "skipped"  # full-attention skip policy


def test_dryrun_resolves_without_tracing_and_records_errors(monkeypatch):
    rec = run_cell("mamba2-130m", "long_500k", multi_pod=True, reduced=True,
                   compile_cell=False)
    assert rec["status"] == "resolved" and rec["devices"] == 512
    assert "counted" not in rec
    # 3 microbatches do not split the reduced batch of 8: an error record
    monkeypatch.setenv("REPRO_MICROBATCHES", "3")
    rec = run_cell("qwen2-0.5b", "train_4k", reduced=True,
                   mesh=make_mesh((1, 1), ("data", "model"), devices=["cpu"]))
    assert rec["status"] == "error" and rec["traceback"]
    assert rec["mesh"] == "data=1,model=1"


@pytest.mark.parametrize("microbatches", [1, 4])
def test_fsdp_gathers_follow_the_traced_microbatches(monkeypatch, microbatches):
    """An FSDP train cell gathers its weights twice a microbatch, and the
    microbatch count is the one the step was traced with
    (``REPRO_MICROBATCHES``, default 1): 4 microbatches gather 4x as much."""
    from repro_torch.models.registry import get_model
    from repro_torch.roofline import analytic

    monkeypatch.setenv("REPRO_MICROBATCHES", str(microbatches))
    rec = run_cell("arctic-480b", "train_4k", reduced=True)
    assert rec["status"] == "ok", rec.get("error")
    assert rec["microbatches"] == microbatches
    cfg = get_config("arctic-480b").reduced()
    rules = dryrun_lib.pick_rules(cfg, "train_4k")
    assert rules["embed"] == "data"
    p = analytic.sharded_bytes(get_model(cfg).schema(cfg), rules, rec["mesh_sizes"],
                               cfg.param_dtype)
    assert rec["counted"]["collective_by_type"]["all-gather"] == microbatches * 2 * 15 * p


def test_argument_bytes_follow_the_shardings():
    """On the production mesh a decode cell's per-device argument bytes are
    the parameters', the cache's and the tokens' bytes, each over its shard
    count (what ``roofline.analytic`` computes for the first two)."""
    from repro_torch.roofline import analytic
    from repro_torch.models.registry import get_model

    cfg = get_config("qwen3-8b")
    rec = run_cell(cfg.name, "decode_32k", compile_cell=False)
    mesh = make_mesh((16, 16), ("data", "model"), devices=["cpu"])
    rules = dryrun_lib.pick_rules(cfg, "decode_32k")
    _, args, axes = dryrun_lib.step_call(cfg, "decode_32k", 128, 32_768)
    got = dryrun_lib.argument_bytes(args, axes, mesh, rules)
    sizes = {"data": 16, "model": 16}
    want = (analytic.sharded_bytes(get_model(cfg).schema(cfg), rules, sizes, cfg.param_dtype)
            + analytic._cache_bytes(cfg, rec, sizes) + 128 * 4 // 16)
    assert got == want


def _families():
    """One config per family, each deeper than the two depths it is traced at."""
    return {
        "dense": get_config("qwen2-0.5b").reduced(num_layers=5),
        "vlm": get_config("internvl2-1b").reduced(num_layers=4),
        "moe": get_config("arctic-480b").reduced(num_layers=3),
        "mla": get_config("deepseek-v2-236b").reduced(num_layers=4),
        "ssm": get_config("mamba2-130m").reduced(num_layers=5),
        "hybrid": get_config("zamba2-2.7b").reduced(num_layers=9, shared_attn_period=2),
        "encdec": get_config("seamless-m4t-large-v2").reduced(num_layers=3, encoder_layers=3),
    }


# where the shallowest trace's live-bytes peak falls in another phase than
# the deeper stacks' (dryrun_lib's docstring): the extrapolated peak is an
# estimate there, and every other count is still exact
_PEAK_ESTIMATED = {("moe", "train_4k"), ("mla", "train_4k"), ("encdec", "prefill_32k"),
                   ("encdec", "decode_32k")}


@pytest.mark.parametrize("shape_name", ["train_4k", "prefill_32k", "decode_32k"])
@pytest.mark.parametrize("family", list(_families()))
def test_depth_extrapolation_equals_the_whole_stack(family, shape_name):
    cfg = _families()[family]
    got, depths = dryrun_lib.traced_cost(cfg, shape_name, 2, 64)
    want, whole = dryrun_lib.traced_cost(cfg, shape_name, 2, 64, full_depth=True)
    k = 2 if family == "hybrid" else 1
    assert depths == [k, k + 1] and whole == [dryrun_lib.depth_units(cfg)]
    assert dryrun_lib.depth_units(cfg) > k + 1
    for key in ("flops", "flops_by_op", "op_count", "bytes_accessed"):
        assert got[key] == want[key], key
    if (family, shape_name) in _PEAK_ESTIMATED:
        assert got["peak_live_bytes"] != want["peak_live_bytes"]
    else:
        assert got["peak_live_bytes"] == want["peak_live_bytes"]


def test_at_depth_keeps_the_stack_structure():
    z = get_config("zamba2-2.7b")
    assert dryrun_lib.depth_units(z) == 9
    assert dryrun_lib.at_depth(z, 2).num_layers == 12
    s = get_config("seamless-m4t-large-v2")
    assert dryrun_lib.depth_units(s) == 24
    two = dryrun_lib.at_depth(s, 2)
    assert (two.encoder_layers, two.num_layers) == (2, 2)
    d = get_config("deepseek-v2-236b")
    assert dryrun_lib.depth_units(d) == 59 and dryrun_lib.at_depth(d, 1).num_layers == 2


_JAX_FLOPS = """
    from repro.launch.dryrun_lib import run_cell
    from repro.launch.mesh import make_mesh
    mesh = make_mesh((1, 1), ("data", "model"))
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        rec = run_cell("qwen2-0.5b", shape, reduced=True, mesh=mesh)
        assert rec["status"] == "ok", rec.get("error")
        print(shape, rec["parsed"]["flops"])
"""


def test_counted_flops_within_5_percent_of_the_reference_hlo(subproc):
    out = subproc(_JAX_FLOPS, devices=1)
    ref = {line.split()[0]: float(line.split()[1]) for line in out.splitlines()
           if line.split() and line.split()[0].endswith(("_4k", "_32k"))}
    assert sorted(ref) == ["decode_32k", "prefill_32k", "train_4k"]
    mesh = make_mesh((1, 1), ("data", "model"), devices=["cpu"])
    for shape, want in ref.items():
        rec = run_cell("qwen2-0.5b", shape, reduced=True, mesh=mesh)
        got = rec["counted"]["flops"]
        assert abs(got - want) / want < 0.05, (shape, got, want)


def test_run_all_caches_and_reuses_its_records(tmp_path, capsys):
    kw = dict(archs=["qwen2-0.5b", "mamba2-130m"], shapes=["decode_32k", "long_500k"],
              meshes=("single_pod",), out_dir=str(tmp_path), reduced=True)
    first = run_all(**kw)
    assert [(r["arch"], r["shape"], r["status"]) for r in first] == [
        ("qwen2-0.5b", "decode_32k", "ok"), ("qwen2-0.5b", "long_500k", "skipped"),
        ("mamba2-130m", "decode_32k", "ok"), ("mamba2-130m", "long_500k", "ok")]
    assert len(os.listdir(tmp_path)) == 4
    capsys.readouterr()
    again = run_all(**kw)
    assert again == first
    assert capsys.readouterr().out.count("[cached]") == 4
    fresh = run_all(**kw, skip_existing=False)
    assert [r["status"] for r in fresh] == [r["status"] for r in first]
    assert report.load_records(str(tmp_path)) == sorted(
        fresh, key=lambda r: f"{r['mesh']}__{r['arch']}__{r['shape']}")


def test_run_all_in_worker_processes(tmp_path):
    recs = run_all(archs=["qwen2-0.5b"], shapes=["prefill_32k", "decode_32k"],
                   meshes=("multi_pod",), out_dir=str(tmp_path), reduced=True)
    assert [(r["shape"], r["status"], r["devices"]) for r in recs] == [
        ("prefill_32k", "ok", 512), ("decode_32k", "ok", 512)]


def test_the_cli_and_the_markdown_writer(tmp_path):
    env = dict(os.environ, PYTHONPATH=SRC)
    out = tmp_path / "records"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--reduced", "--arch", "qwen2-0.5b",
         "--shape", "train_4k", "--mesh", "single_pod", "--out", str(out)],
        capture_output=True, text=True, timeout=300, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert "dry-run: 1 ok, 0 skipped, 0 errors / 1 cells" in proc.stdout
    md = tmp_path / "EXPERIMENTS_torch.md"
    assert experiments_md.main(["--out", str(md), "--records", str(out)]) == 0
    text = md.read_text()
    assert "## §Dry-run" in text and "## §Roofline" in text
    assert "| single_pod | qwen2-0.5b | train_4k | ok |" in text
    for tpu in ("TPU", "197 TFLOP", "819 GB", "ICI", "16 GB"):
        assert tpu not in text
    assert report.main(["--records", str(out)]) == 0
    help_text = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--help"],
        capture_output=True, text=True, timeout=300, env=env, cwd=REPO).stdout
    assert "never touches a card" in " ".join(help_text.split())
