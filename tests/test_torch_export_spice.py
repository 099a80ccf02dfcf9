"""`tools/torch_export_spice.py` (the PyTorch port's SPICE deck export)
against the reference's `tools/export_spice.py`.

Both export into a temporary directory: the same 36 decks, line for line,
numeric tokens equal within their printed 6 significant digits (the
expected values come from each package's own solvers); the port's decks
lint with 0 failures (`tools/run_spice.py --lint-only`); without `--out`
the port's tool exits non-zero and writes nothing.
"""

import os
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOL = os.path.join(REPO, "tools", "torch_export_spice.py")
# a number that is not part of a name (R1, Q4, v(emit2a))
NUM = re.compile(r"(?<![A-Za-z_\d.])[-+]?(?:\d+\.?\d*|\.\d+)"
                 r"(?:[eE][-+]?\d+)?")


def _tokens_match(a, b):
    """Equal lines, or lines equal but for numbers that differ only in
    their last printed digit."""
    if a == b:
        return True
    if NUM.sub("#", a) != NUM.sub("#", b):
        return False
    for x, y in zip(NUM.findall(a), NUM.findall(b)):
        if x == y:
            continue
        fx, fy = float(x), float(y)
        digits = x.lower().split("e")[0].lstrip("-+")
        frac = digits.split(".")[1] if "." in digits else ""
        exp = int(x.lower().split("e")[1]) if "e" in x.lower() else 0
        last = 10.0 ** (exp - len(frac))
        if abs(fx - fy) > 1.01 * last:
            return False
    return True


@pytest.fixture(scope="module")
def exports(tmp_path_factory):
    out = tmp_path_factory.mktemp("spice")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    ref = subprocess.Popen(
        [sys.executable, os.path.join(REPO, "tools", "export_spice.py"),
         "--out", str(out / "ref")], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    port = subprocess.run([sys.executable, TOOL, "--out", str(out / "port")],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=600)
    ref_out, _ = ref.communicate(timeout=600)
    assert ref.returncode == 0, ref_out
    assert port.returncode == 0, port.stdout + port.stderr
    return out / "port", out / "ref", port.stdout


def test_export_matches_reference(exports):
    port, ref, stdout = exports
    names = sorted(os.listdir(ref))
    assert len(names) == 36
    assert sorted(os.listdir(port)) == names
    assert stdout.count("wrote ") == 36
    for name in names:
        a = (port / name).read_text().splitlines()
        b = (ref / name).read_text().splitlines()
        assert len(a) == len(b), name
        bad = [(x, y) for x, y in zip(a, b) if not _tokens_match(x, y)]
        assert not bad, (name, bad[:3])


def test_export_lints(exports):
    port, _, _ = exports
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "run_spice.py"),
         "--lint-only", "--dir", str(port)],
        capture_output=True, text=True, cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "0 failures" in proc.stdout, proc.stdout


def test_export_needs_out(tmp_path):
    proc = subprocess.run([sys.executable, TOOL], cwd=tmp_path,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "--out" in proc.stderr
    assert os.listdir(tmp_path) == []


def test_token_match_rule():
    assert _tokens_match("* x=1.2345", "* x=1.2346")
    assert not _tokens_match("* x=1.2345", "* x=1.2347")
    assert _tokens_match("R1 a b 4.7e+03", "R1 a b 4.8e+03")
    assert not _tokens_match("R1 a b 4.7e+03", "R2 a b 4.7e+03")
    assert not _tokens_match("* emit2=1.5", "* emit3=1.5")
