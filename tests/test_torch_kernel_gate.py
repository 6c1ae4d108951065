"""The port's kernel parity gate (``ops/kernel_gate.py``) on the CPU.

Every case of ``tests/test_kernel_gate.py`` with the veto replaced by the
port's rule, raise: divergence raises ``KernelParityError`` naming the rms
and the threshold, agreement passes, the gate runs once per (selection,
device, model class), and it skips on the CPU, at the ``none`` selection, at widths no
kernel takes (read on a card from the launch counters around the kernel
pass) and under ``ATSM_SKIP_PARITY_GATE=1``; ``Separator``
construction calls it on each distinct device.  Injected pairs give the JAX
``verify_layer_parity``'s ``rms`` / ``ref_rms`` (1e-6 relative), and the
model's own pair (``gate_pair``: a seeded 6 s chunk through
``forward_with_text_emb``) gives
the JAX default pair's stem at the same tiny weights (``ref_rms`` to 1e-4
relative; on the CPU both kernel passes take the plain versions).
"""

from __future__ import annotations

import contextlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_to_sheet_music_tpu.models import atht as JA
from audio_to_sheet_music_tpu.ops import kernel_gate as JG
from audio_to_sheet_music_tpu_torch.convert import jax_params
from audio_to_sheet_music_tpu_torch.infer.session import Separator
from audio_to_sheet_music_tpu_torch.models import atht as TA
from audio_to_sheet_music_tpu_torch.ops import fused_attn, fused_norm, kernel_gate
from audio_to_sheet_music_tpu_torch.ops.select import DEFAULT, NONE, OPT_IN
from audio_to_sheet_music_tpu_torch.parallel import make_mesh


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads while this file runs: the suite runs several
    workers on the host's cores, and each taking all of them slows every
    worker several times over."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _fresh_gate(monkeypatch):
    """Each test starts with no gate result and no opt-out."""
    monkeypatch.setattr(kernel_gate, "_RESULTS", {})
    monkeypatch.setattr(kernel_gate, "_LAST", None)
    monkeypatch.delenv("ATSM_SKIP_PARITY_GATE", raising=False)


def _diverging(sel, x):
    """The kernel pass is the per-op pass + 1e-2 (the JAX test's pair)."""
    return x + 1e-2 if sel != NONE else x


def _agreeing(sel, x):
    return x * 2.0


ARGS = (torch.ones((4, 128)),)


def test_divergence_raises_naming_rms_and_threshold():
    with pytest.raises(kernel_gate.KernelParityError) as err:
        kernel_gate.ensure_layer_parity(None, forward=_diverging, args=ARGS)
    msg = str(err.value)
    assert "rms 1.000e-02" in msg and "threshold 1e-03" in msg
    assert "ref_rms 1.000e+00" in msg and "'default'" in msg
    assert "cpu" in msg
    res = kernel_gate.last_result()
    assert not res["ok"] and res["rms"] == pytest.approx(1e-2, rel=1e-5)
    # no veto, no fallback: the cached failure raises again, unrun
    with pytest.raises(kernel_gate.KernelParityError):
        kernel_gate.ensure_layer_parity(None, forward=_agreeing, args=ARGS)


def test_agreement_passes():
    res = kernel_gate.ensure_layer_parity(None, forward=_agreeing, args=ARGS)
    assert res is not None and res["ok"] and res["rms"] == 0.0
    assert res["selection"] == "default" and res["device"] == "cpu"
    assert res["card"] == "cpu" and res["seconds"] >= 0.0
    assert kernel_gate.last_result() is res


def test_kernel_pass_takes_the_whole_selection():
    """The kernel pass runs the selection it is given, all its kernels at
    once (the JAX gate toggles its two flags together)."""
    seen = []

    def fwd(sel, x):
        seen.append(sel)
        return x

    kernel_gate.verify_layer_parity(None, kernels="opt_in", forward=fwd,
                                    args=ARGS)
    assert seen == [NONE, OPT_IN]


def test_gate_runs_once_per_selection_and_device():
    first = kernel_gate.ensure_layer_parity(None, forward=_agreeing,
                                            args=ARGS)
    # the same (selection, device): the cached result, the pair unrun (a
    # divergent pair would raise if it ran)
    assert kernel_gate.ensure_layer_parity(
        None, forward=_diverging, args=ARGS) is first
    # another selection runs
    with pytest.raises(kernel_gate.KernelParityError):
        kernel_gate.ensure_layer_parity(None, kernels="opt_in",
                                        forward=_diverging, args=ARGS)
    assert set(kernel_gate._RESULTS) == {(DEFAULT, "cpu", "NoneType"),
                                         (OPT_IN, "cpu", "NoneType")}


def test_gate_runs_again_for_another_model_class():
    """ATHT and BS-RoFormer launch different kernels: a gate passed on one
    does not stand for the other on the same selection and device."""
    kernel_gate.ensure_layer_parity(None, forward=_agreeing, args=ARGS)
    with pytest.raises(kernel_gate.KernelParityError):
        kernel_gate.ensure_layer_parity(torch.nn.Linear(1, 1),
                                        forward=_diverging, args=ARGS)


def test_skip_env_disables_gate(monkeypatch):
    monkeypatch.setenv("ATSM_SKIP_PARITY_GATE", "1")
    assert kernel_gate.ensure_layer_parity(
        None, forward=_diverging, args=ARGS) is None
    assert kernel_gate.last_result() is None


def test_none_selection_skips():
    assert kernel_gate.ensure_layer_parity(
        None, kernels="none", forward=_diverging, args=ARGS) is None


def test_verify_reads_and_writes_no_environment(monkeypatch):
    monkeypatch.setenv("ATSM_PALLAS_LAYER", "1")
    before = dict(os.environ)
    kernel_gate.verify_layer_parity(None, forward=_agreeing, args=ARGS)
    assert dict(os.environ) == before


@pytest.fixture(scope="module")
def tiny():
    params = jax.tree.map(np.asarray, JA.init_tiny(jax.random.PRNGKey(0)))
    model = TA.init_tiny(materialize=False)
    model.load_state_dict(jax_params.state_dict_from_params(params),
                          strict=True)
    return params, model


def _no_verify(*a, **k):
    raise AssertionError("the gate ran where it should skip")


def test_cpu_default_pair_skips(tiny, monkeypatch):
    """On the CPU the wrappers take their plain versions: nothing to
    gate, and no two forwards paid."""
    monkeypatch.setattr(kernel_gate, "verify_layer_parity", _no_verify)
    assert kernel_gate.ensure_layer_parity(tiny[1]) is None


@pytest.fixture
def as_if_on_a_card(monkeypatch):
    """The gate sees ``cuda:0`` while the pair runs on the host."""
    monkeypatch.setattr(kernel_gate, "_device_of",
                        lambda model, args: torch.device("cuda", 0))
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d: "card")
    monkeypatch.setattr(fused_attn.layer_tail, "launches", 0)


def test_widths_no_kernel_takes_skip(as_if_on_a_card):
    """On a card, a kernel pass that launched no kernel (the model's
    routing took no kernel at its widths) is kept as skipped: no raise,
    even for a pair that diverges, and None."""
    assert kernel_gate.ensure_layer_parity(
        None, forward=_diverging, args=ARGS) is None
    res = kernel_gate.last_result()
    assert res["launches"] == {} and "skipped" in res
    assert kernel_gate.ensure_layer_parity(
        None, forward=_diverging, args=ARGS) is None


def test_kernels_of_the_per_op_pass_do_not_count(as_if_on_a_card,
                                                 monkeypatch):
    """Kernels that both passes launch (GroupNorm's and the decoder join,
    which follow the device under every selection) are no kernels of the
    selection: a pass that launched only them is kept as skipped."""
    monkeypatch.setattr(fused_norm.group_norm, "launches", 0)
    monkeypatch.setattr(fused_norm.decoder_join, "launches", 0)

    def norms(sel, x):
        fused_norm.group_norm.launches += 2
        fused_norm.decoder_join.launches += 8
        return _diverging(sel, x)

    assert kernel_gate.ensure_layer_parity(
        None, forward=norms, args=ARGS) is None
    res = kernel_gate.last_result()
    assert res["launches"] == {} and "skipped" in res


def test_gate_runs_where_a_kernel_launched(as_if_on_a_card):
    """The launch counters read around the kernel pass decide: one launch
    of ``layer_tail`` there, and the divergence raises."""
    def launching(sel, x):
        if sel != NONE:
            fused_attn.layer_tail.launches += 1
        return _diverging(sel, x)

    with pytest.raises(kernel_gate.KernelParityError, match="on card"):
        kernel_gate.ensure_layer_parity(None, forward=launching, args=ARGS)
    res = kernel_gate.last_result()
    assert res["launches"] == {"layer_tail": 1} and "skipped" not in res


def test_separator_construction_calls_the_gate(tiny, monkeypatch):
    calls = []
    monkeypatch.setattr(kernel_gate, "ensure_layer_parity",
                        lambda m, dt, **kw: calls.append((m, dt, kw)))
    model = tiny[1]
    Separator(model, device="cpu", kernels="opt_in", segment_seconds=0.25,
              overlap_seconds=0.05)
    assert calls == [(model, torch.float32, {"kernels": OPT_IN})]
    calls.clear()
    Separator(model, mesh=make_mesh(["cpu"] * 4), segment_seconds=0.25,
              overlap_seconds=0.05)
    assert calls == [(model, torch.float32, {"kernels": DEFAULT})]


@contextlib.contextmanager
def _env(**kv):
    saved = {k: os.environ.get(k) for k in kv}
    os.environ.update(kv)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@pytest.mark.parametrize("scale", [1.0, 0.1])
def test_injected_pairs_match_jax(scale):
    x = (scale * np.random.default_rng(3).standard_normal((4, 128))
         ).astype(np.float32)

    def jax_fwd(a):
        return a + 1e-2 if os.environ.get("ATSM_PALLAS_LAYER") == "1" else a

    with _env(ATSM_PALLAS_LAYER="1", ATSM_PALLAS_ENC="1"):
        want = JG.verify_layer_parity(None, forward=jax_fwd,
                                      args=(jnp.asarray(x),))
    got = kernel_gate.verify_layer_parity(None, forward=_diverging,
                                          args=(torch.from_numpy(x),))
    assert got["ok"] == want["ok"] is False
    assert got["rms"] == pytest.approx(want["rms"], rel=1e-6)
    assert got["ref_rms"] == pytest.approx(want["ref_rms"], rel=1e-6)


def test_default_pair_matches_jax(tiny):
    """ATHT's own pair (``AudioTextHTDemucs.gate_pair``, the one the gate
    takes without an injected pair) is the JAX gate's ``_default_pair``:
    the same seeded chunk and embedding; on the CPU both passes are
    plain."""
    params, model = tiny
    _, args = model.gate_pair(torch.float32)
    _, (_, wav, emb) = JG._default_pair(params, jnp.float32)
    assert args[0] is model
    np.testing.assert_array_equal(args[1].numpy(), np.asarray(wav))
    np.testing.assert_array_equal(args[2].numpy(), np.asarray(emb))
    got = kernel_gate.verify_layer_parity(model, torch.float32)
    want = np.asarray(jax.jit(lambda p, w, e: JA.forward_with_text_emb(
        p, w, e, jnp.float32))(params, wav, emb))
    assert got["ok"] and got["rms"] < 1e-6
    assert got["ref_rms"] == pytest.approx(
        float(np.sqrt(np.mean(want ** 2))), rel=1e-4)
