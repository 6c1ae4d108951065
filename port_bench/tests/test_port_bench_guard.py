"""The module guard compares whole top-level names, and the reference
imports nothing of the program nor JAX."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from port_bench import common

BENCH = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("name", ["jax", "jax.numpy", "jaxlib",
                                  "jaxlib.xla_client", "flax",
                                  "audio_to_sheet_music_tpu",
                                  "audio_to_sheet_music_tpu.models.atht"])
def test_guard_rejects(name):
    assert common.forbidden_modules([name, "numpy"]) == [name]


@pytest.mark.parametrize("name", ["audio_to_sheet_music_tpu_torch",
                                  "audio_to_sheet_music_tpu_torch.models.atht",
                                  "jaxtyping", "flax_like", "torch"])
def test_guard_accepts(name):
    assert common.forbidden_modules([name]) == []


def test_check_no_jax_exits_when_found(monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", sys.modules["math"])
    with pytest.raises(SystemExit) as e:
        common.check_no_jax("test")
    assert e.value.code != 0


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_neither_program_nor_jax(path):
    tops = {m.split(".", 1)[0] for m in _imports(path)}
    assert not tops & {"jax", "jaxlib", "flax", "audio_to_sheet_music_tpu",
                       "audio_to_sheet_music_tpu_torch", "port_bench"}


def test_reference_loads_alone():
    code = ("import sys; import port_bench.reference.protocols; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'audio_to_sheet_music_tpu', "
            "'audio_to_sheet_music_tpu_torch')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=BENCH.parent,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
