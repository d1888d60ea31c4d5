"""The port's METEOR jar-vs-lite harness (``tools/meteor_jar_diff.py``):
blocked (exit 2, a ``blocked`` reason) without a jar; against a mock
``java`` that speaks the meteor-1.5 ``-stdio`` protocol, exit 0 and a
JSON line equal key by key, floats exactly, to the JAX package's tool's
on the same mock and battery (both score through the same lite scorer
and the same mock)."""

import json
import os
import stat

import pytest

from cst_captioning_torch.tools import meteor_jar_diff as tool
from cst_captioning_tpu.tools import meteor_jar_diff as ref_tool

# The mock of tests/test_metrics.py::TestMeteorJavaProtocol.
FAKE_JAVA = r"""#!/usr/bin/env python3
import sys
args = sys.argv
assert "-stdio" in args and "-jar" in args, args
for line in sys.stdin:
    line = line.rstrip("\n")
    if line.startswith("SCORE"):
        parts = line.split(" ||| ")
        refs, hyp = parts[1:-1], parts[-1]
        h = set(hyp.split())
        best = max(
            len(h & set(r.split())) / max(len(set(r.split())), 1)
            for r in refs
        )
        print(f"stat {best}")
        sys.stdout.flush()
    elif line.startswith("EVAL"):
        parts = line.split(" ||| ")[1:]
        segs = [float(p.split()[1]) for p in parts]
        for s in segs:
            print(s)
        print(sum(segs) / len(segs))
        sys.stdout.flush()
"""


@pytest.fixture
def mock_jar(tmp_path, monkeypatch):
    fake = tmp_path / "java"
    fake.write_text(FAKE_JAVA)
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    jar = tmp_path / "meteor-1.5.jar"
    jar.write_bytes(b"")
    monkeypatch.setenv("PATH", f"{tmp_path}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setenv("METEOR_JAR", str(jar))
    return tmp_path


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_blocked_without_jar(monkeypatch, capsys):
    monkeypatch.delenv("METEOR_JAR", raising=False)
    assert tool.main([]) == 2
    out = _last_json(capsys)
    assert set(out) == {"blocked"} and out["blocked"]


def test_battery_equals_the_reference(mock_jar, capsys):
    assert tool.main([]) == 0
    got = _last_json(capsys)
    for key in ("corpus_java", "corpus_lite", "corpus_abs_delta",
                "seg_abs_delta_max", "worst_segments"):
        assert key in got
    assert got["segments"] == len(tool.BATTERY) > 5
    assert ref_tool.main([]) == 0
    want = _last_json(capsys)
    assert got == want


def test_prediction_files_equal_the_reference(mock_jar, capsys):
    preds = {"v0": "a man plays a guitar", "v1": "a dog runs",
             "v2": "people are dancing"}
    refs = {"v0": ["a man is playing a guitar", "someone plays guitar"],
            "v1": ["a dog is running in a field"],
            "v2": ["a group of people dance", "people dance together"]}
    p, r = mock_jar / "preds.json", mock_jar / "refs.json"
    p.write_text(json.dumps(preds))
    r.write_text(json.dumps(refs))
    assert tool.main([str(p), str(r)]) == 0
    got = _last_json(capsys)
    assert got["segments"] == 3
    assert ref_tool.main([str(p), str(r)]) == 0
    assert got == _last_json(capsys)
