"""The port stands alone, and its full-width modules take the JAX names.

- No module of ``audio_to_sheet_music_tpu_torch`` imports ``jax`` or the JAX
  package (an AST scan; the package's own name shares the JAX package's
  prefix and must pass), and importing it leaves ``jax`` out of
  ``sys.modules``.
- The full-width port model's ``state_dict`` names and shapes are exactly
  those of the full-width JAX ``atht.init`` tree, and a state dict built
  from those names loads with ``strict=True``.  Shapes only: the trees are
  traced with ``jax.eval_shape`` and the modules built on the meta device.
"""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import jax
import pytest
import torch

from audio_to_sheet_music_tpu.convert.torch_import import _translate, _tree_paths
from audio_to_sheet_music_tpu.models import atht as JA
from audio_to_sheet_music_tpu_torch.convert import jax_params
from audio_to_sheet_music_tpu_torch.models import atht as TA

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "audio_to_sheet_music_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "audio_to_sheet_music_tpu")


def _imported(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


@pytest.mark.parametrize("path", sorted(p.relative_to(ROOT).as_posix()
                                        for p in PORT.rglob("*.py")))
def test_module_imports_no_jax(path):
    tree = ast.parse((ROOT / path).read_text(), filename=path)
    bad = [n for n in _imported(tree) if _forbidden(n)]
    assert not bad, f"{path} imports {bad}"


def test_prefix_rule():
    assert _forbidden("audio_to_sheet_music_tpu.models")
    assert _forbidden("jax.numpy")
    assert not _forbidden("audio_to_sheet_music_tpu_torch.models")
    assert not _forbidden("jaxtyping_like")


def test_chip_smoke_imports_no_jax():
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    assert not [n for n in _imported(tree) if _forbidden(n)]


def test_import_leaves_jax_unloaded():
    code = ("import sys, audio_to_sheet_music_tpu_torch as p\n"
            "from audio_to_sheet_music_tpu_torch.infer import session\n"
            "from audio_to_sheet_music_tpu_torch.apps import separate\n"
            "from audio_to_sheet_music_tpu_torch.train import trainer\n"
            "from audio_to_sheet_music_tpu_torch import cli, config, eval\n"
            "from audio_to_sheet_music_tpu_torch.eval import harness, models\n"
            "from audio_to_sheet_music_tpu_torch.ops import (fused_dconv, "
            "fused_stft, select)\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
            "('jax.', 'audio_to_sheet_music_tpu.'))"
            " or m == 'audio_to_sheet_music_tpu']\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr


def test_full_width_names_load_strictly():
    shapes = jax.eval_shape(JA.init, jax.random.PRNGKey(0))
    want = {_translate(p): tuple(leaf.shape) for p, leaf in _tree_paths(shapes)}
    # the port's own copy of the path translation gives the same names
    assert {jax_params.translate(p) for p, _ in _tree_paths(shapes)} == set(want)
    with torch.device("meta"):
        model = TA.init(materialize=False)
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert got == want
    state = {k: torch.empty(s, device="meta") for k, s in want.items()}
    result = model.load_state_dict(state, strict=True)
    assert not result.missing_keys and not result.unexpected_keys


def test_the_port_never_calls_library_attention():
    """Attention in the port is plain matmul and softmax, as in the JAX
    package; ``scaled_dot_product_attention`` is only a yardstick in
    ``chip_smoke.py``."""
    hits = [p.relative_to(ROOT).as_posix() for p in PORT.rglob("*.py")
            if "scaled_dot_product_attention" in p.read_text()]
    assert not hits, hits
