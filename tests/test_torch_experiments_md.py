"""The port's baseline-versus-optimized roofline table
(``roofline.experiments_md.compare_table``) against the JAX package's
``_compare_table``, and the ``--opt-records`` section of the markdown
writer.

The same records go through both functions.  Each record carries its
counts twice, under the reference's key (``parsed``) and the port's
(``counted``), and the port runs at the reference's own peaks (read from
``repro.roofline.report`` here, never written into the port), so the
tables must be equal line for line.
"""

import json

import numpy as np
import pytest

from repro.roofline import experiments_md as jexperiments_md
from repro.roofline import report as jreport
from repro_torch.configs import LM_ARCH_IDS
from repro_torch.configs import shapes
from repro_torch.roofline import experiments_md

REF_PEAKS = {"bf16": jreport.PEAK_FLOPS, "fp32": jreport.PEAK_FLOPS,
             "bytes": jreport.HBM_BW, "link_bytes": jreport.ICI_BW}


def _records(seed, archs=LM_ARCH_IDS):
    """An ok record per (arch, shape) of the single-pod mesh with seeded
    counts, plus what the table must leave out: a multi-pod record and a
    skipped one."""
    rng = np.random.default_rng(seed)
    recs = []
    for arch in archs:
        for name, spec in shapes.SHAPES.items():
            counts = {"flops": float(rng.integers(1, 10**15)),
                      "hbm_bytes": float(rng.integers(1, 10**12)),
                      "collective_bytes": float(rng.integers(0, 10**11))}
            recs.append({"arch": arch, "shape": name, "mesh": "single_pod", "kind": spec.kind,
                         "seq_len": spec.seq_len, "global_batch": spec.global_batch,
                         "status": "ok", "devices": 256, "trace_seconds": 1.5,
                         "memory": {"peak_estimate_bytes": float(rng.integers(1, 10**11))},
                         "parsed": counts, "counted": counts})
    recs.append(dict(recs[0], mesh="multi_pod", devices=512))
    recs.append({"arch": archs[-1], "shape": "long_500k", "mesh": "single_pod",
                 "status": "skipped"})
    return recs


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compare_table_equals_the_reference(seed):
    base, opt = _records(2 * seed), _records(2 * seed + 1)
    opt = opt[:20] + opt[-2:]  # a cell only one sweep has is left out
    want = jexperiments_md._compare_table(base, opt)
    got = experiments_md.compare_table(base, opt, peaks=REF_PEAKS)
    assert got.splitlines() == want.splitlines()
    assert len(got.splitlines()) == 2 + 20  # the header, then a row a cell both have


def test_render_appends_the_comparison_with_opt_records():
    recs = _records(3, archs=["qwen2-0.5b"])
    assert "Optimized vs baseline" not in experiments_md.render(recs)
    assert experiments_md.render(recs) == experiments_md.render(recs, [])
    text = experiments_md.render(recs, recs)
    assert "### Optimized vs baseline — single pod" in text
    assert experiments_md.compare_table(recs, recs) in text
    assert "×1.00 faster" in text
    assert "Optimized cells: 5 ok, 1 skips, 0 errors out of 6." in text


def test_the_cli_takes_opt_records(tmp_path):
    for name, recs in (("base", _records(4, archs=["qwen2-0.5b"])),
                       ("opt", _records(5, archs=["qwen2-0.5b"]))):
        (tmp_path / name).mkdir()
        for i, rec in enumerate(recs):
            (tmp_path / name / f"{i:02d}.json").write_text(json.dumps(rec))
    md = tmp_path / "out.md"
    assert experiments_md.main(["--out", str(md), "--records", str(tmp_path / "base"),
                                "--opt-records", str(tmp_path / "opt")]) == 0
    text = md.read_text()
    assert "### Optimized vs baseline — single pod" in text
    assert "| qwen2-0.5b | train_4k |" in text.split("Optimized vs baseline")[1]
    assert experiments_md.main(["--out", str(md), "--records", str(tmp_path / "base")]) == 0
    assert "Optimized vs baseline" not in md.read_text()
