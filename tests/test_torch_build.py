"""The port's kernel build helper, without a CUDA toolkit.

``ops/build.py`` compiles each ``csrc/<name>.cu`` with its own ``nvcc``
process into a library named by a hash of the source and flags.  Here a
stand-in compiler script takes nvcc's place, so the command line, the
parallel build, the cache by content and the error path run on the CPU.
"""

from __future__ import annotations

import stat

import pytest
import torch

from audio_to_sheet_music_tpu_torch.ops import build

FAKE_NVCC = """#!/bin/sh
# stand-in compiler: copy the last argument (the source) to the -o path
out=""; src=""
while [ $# -gt 0 ]; do
  case "$1" in -o) out="$2"; shift 2;; *) src="$1"; shift;; esac
done
grep -q BROKEN "$src" && { echo "error: broken source"; exit 2; }
echo "ptxas info    : Used 1 registers"
cp "$src" "$out"
"""


@pytest.fixture
def sandbox(tmp_path, monkeypatch):
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    monkeypatch.setattr(build, "nvcc_path", lambda: str(nvcc))
    return csrc


def test_command_targets_hopper(sandbox, tmp_path):
    cmd = build._command("layer_tail", tmp_path / "x.so")
    assert "arch=compute_90a,code=sm_90a" in cmd and "-shared" in cmd
    assert cmd[-1].endswith("layer_tail.cu")


def test_builds_in_parallel_and_caches_by_content(sandbox):
    (sandbox / "a.cu").write_text("// a\n")
    (sandbox / "b.cu").write_text("// b\n")
    build.build_all(["a", "b"])
    first = build._target("a")
    assert first.exists() and build._target("b").exists()
    assert "registers" in build.build_log("a")
    mtime = first.stat().st_mtime_ns
    build.build_all(["a"])                       # unchanged: not rebuilt
    assert first.stat().st_mtime_ns == mtime
    (sandbox / "a.cu").write_text("// a, edited\n")
    assert build._target("a") != first           # edited: a new library


def test_a_failed_build_raises_with_the_compiler_output(sandbox):
    (sandbox / "bad.cu").write_text("BROKEN\n")
    with pytest.raises(RuntimeError, match="broken source"):
        build.build_all(["bad"])
    assert not build._target("bad").exists()


def test_no_toolkit_is_an_error(monkeypatch, tmp_path):
    import torch.utils.cpp_extension as ext

    monkeypatch.setattr(ext, "CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc_path()


def test_launch_errors_raise():
    build.check(0, "ok")
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        build.check(700, "layer_tail")


class _FakeDevice:
    """``torch.cuda.device`` without a card: sets and restores a recorded
    current device."""

    current = 0

    def __init__(self, device):
        self.index = torch.device(device).index

    def __enter__(self):
        self.prev, _FakeDevice.current = _FakeDevice.current, self.index

    def __exit__(self, *exc):
        _FakeDevice.current = self.prev


@pytest.fixture
def fake_cuda(monkeypatch):
    monkeypatch.setattr(_FakeDevice, "current", 0)
    monkeypatch.setattr(torch.cuda, "device", _FakeDevice)
    monkeypatch.setattr(torch.cuda, "current_device",
                        lambda: _FakeDevice.current)


def test_launch_makes_the_input_card_current(fake_cuda):
    """The launcher runs with the input's card current, and the caller's
    current card comes back after it, also when the launch fails."""
    seen = []

    def stub_launch(*args):
        seen.append((torch.cuda.current_device(), args))
        return 0

    build.launch("k", torch.device("cuda", 3), stub_launch, 7, 8)
    assert seen == [(3, (7, 8))] and torch.cuda.current_device() == 0
    with pytest.raises(RuntimeError, match="k: CUDA error 9"):
        build.launch("k", torch.device("cuda", 1), lambda: 9)
    assert torch.cuda.current_device() == 0


def test_every_kernel_launch_goes_through_the_guard():
    """The five ctypes launch sites (``layer_tail``, ``attn_block``,
    ``henc_freq_fused``, ``dconv_rows``, ``stft``) hand their launcher to
    ``build.launch`` and call none directly: their CUDA branch needs CUDA
    tensors, so this reads the source."""
    import re
    from pathlib import Path

    ops = Path(build.__file__).parent
    guarded, direct = {}, []
    for name in ("fused_attn", "fused_dconv", "fused_enc", "fused_stft"):
        src = (ops / f"{name}.py").read_text()
        guarded[name] = len(re.findall(r"build\.launch\(", src))
        direct += re.findall(r"\w+_launch\(", src)
    assert guarded == {"fused_attn": 2, "fused_dconv": 1, "fused_enc": 1,
                       "fused_stft": 1}
    assert direct == []
