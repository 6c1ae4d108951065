"""The port's stdlib HTTP server, live, and against the JAX package's.

``TestHttpServer``, ``TestCodecs`` and ``TestStreamBlockAuto`` mirror every
test of ``tests/test_serve_http.py`` against the port's server: an
ephemeral port on 127.0.0.1, the server on a thread, the whole request
cycle over TCP.  ``TestParityWithJax`` holds the port's
``SeparationService`` to the JAX one in process on the same WAV bytes
(the same tiny weights in both, f32): ``separate`` in int16 mode,
``separate_all_zip`` and ``separate_stream`` within one int16 step, the
``pick_stream_block`` policy on a hypothesis grid, and the Prometheus text.
The parity song is white noise at 0.3 rms (``test_torch_session.py`` says
why not quieter).
"""

from __future__ import annotations

import base64
import io
import json
import threading
import urllib.error
import urllib.parse
import urllib.request
import zipfile

import jax
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from scipy.io import wavfile

from audio_to_sheet_music_tpu.apps import serve_http as jax_serve_http
from audio_to_sheet_music_tpu.infer import Separator as JaxSeparator
from audio_to_sheet_music_tpu.models import atht as JA
from audio_to_sheet_music_tpu_torch.apps import serve_http
from audio_to_sheet_music_tpu_torch.convert import jax_params
from audio_to_sheet_music_tpu_torch.infer import streaming as streaming_mod
from audio_to_sheet_music_tpu_torch.infer.session import Separator
from audio_to_sheet_music_tpu_torch.models import atht as TA

SR = 44100
KW = dict(segment_seconds=0.25, overlap_seconds=0.05)


def _make_wav_bytes(t: int = SR, channels: int = 2, sr: int = SR,
                    dtype=np.float32) -> bytes:
    rng = np.random.default_rng(0)
    wav = (0.1 * rng.standard_normal((channels, t))).astype(np.float32)
    if dtype == np.int16:
        wav = (wav * 32767).astype(np.int16)
    return serve_http.encode_wav_bytes(wav, sr) if dtype == np.float32 else (
        _pcm_wav_bytes(wav, sr))


def _pcm_wav_bytes(pcm: np.ndarray, sr: int) -> bytes:
    buf = io.BytesIO()
    wavfile.write(buf, sr, pcm.T)
    return buf.getvalue()


@pytest.fixture(scope="module")
def params():
    return jax.tree.map(np.asarray, JA.init_tiny(jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def port_separator(params):
    model = TA.init_tiny(materialize=False)
    model.load_state_dict(jax_params.state_dict_from_params(params),
                          strict=True)
    return Separator(model, device="cpu", **KW)


@pytest.fixture(scope="module")
def server(port_separator):
    service = serve_http.SeparationService(port_separator, pretrained=False)
    httpd = serve_http.make_server(service, "127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}", service
    httpd.shutdown()
    httpd.server_close()
    thread.join(timeout=5)


class TestHttpServer:
    def test_health(self, server):
        url, service = server
        with urllib.request.urlopen(f"{url}/api/health", timeout=30) as r:
            body = json.loads(r.read())
        assert body["status"] == "ok"
        assert body["pretrained"] is False
        assert body["segment_seconds"] == pytest.approx(0.25)

    def test_index_page(self, server):
        url, _ = server
        with urllib.request.urlopen(f"{url}/", timeout=30) as r:
            page = r.read().decode()
        assert "Separate" in page and "/api/separate" in page

    def test_separate_wav_roundtrip(self, server):
        url, service = server
        before = service.requests_served
        wav_bytes = _make_wav_bytes(t=SR // 2)
        req = urllib.request.Request(
            f"{url}/api/separate?prompt=vocals", data=wav_bytes,
            headers={"Content-Type": "audio/wav"})
        with urllib.request.urlopen(req, timeout=120) as r:
            assert r.headers["Content-Type"] == "audio/wav"
            out = r.read()
        sr, stem = wavfile.read(io.BytesIO(out))
        assert sr == SR
        assert stem.dtype == np.int16
        assert stem.shape == (SR // 2, 2)
        assert service.requests_served == before + 1

    def test_separate_json_mode_carries_spectrograms(self, server):
        url, _ = server
        wav_bytes = _make_wav_bytes(t=SR // 4)
        req = urllib.request.Request(
            f"{url}/api/separate?prompt=drums&format=json", data=wav_bytes,
            headers={"Content-Type": "audio/wav"})
        with urllib.request.urlopen(req, timeout=120) as r:
            assert r.headers["Content-Type"] == "application/json"
            out = json.loads(r.read())
        assert "drums" in out["status"]
        stem = base64.b64decode(out["stem_wav_b64"])
        assert stem[:4] == b"RIFF"
        for key in ("spec_in_png_b64", "spec_out_png_b64"):
            png = base64.b64decode(out[key])
            assert png[:8] == b"\x89PNG\r\n\x1a\n"

    def test_mono_low_rate_upload_is_normalised(self, server):
        url, _ = server
        rng = np.random.default_rng(1)
        pcm = (3000 * rng.standard_normal((1, 11025))).astype(np.int16)
        req = urllib.request.Request(
            f"{url}/api/separate", data=_pcm_wav_bytes(pcm, SR // 2),
            headers={"Content-Type": "audio/wav"})
        with urllib.request.urlopen(req, timeout=120) as r:
            out = r.read()
        sr, stem = wavfile.read(io.BytesIO(out))
        assert sr == SR and stem.shape == (22050, 2)

    def test_streaming_endpoint_matches_offline(self, server):
        url, _ = server
        wav_bytes = _make_wav_bytes(t=SR // 2)
        off_req = urllib.request.Request(
            f"{url}/api/separate?prompt=vocals", data=wav_bytes,
            headers={"Content-Type": "audio/wav"})
        with urllib.request.urlopen(off_req, timeout=120) as r:
            offline = r.read()
        st_req = urllib.request.Request(
            f"{url}/api/separate/stream?prompt=vocals", data=wav_bytes,
            headers={"Content-Type": "audio/wav"})
        with urllib.request.urlopen(st_req, timeout=120) as r:
            assert r.headers["Content-Type"] == "audio/wav"
            promised = int(r.headers["Content-Length"])
            first = r.read(4096)
            rest = r.read()
        streamed = first + rest
        assert len(streamed) == promised == 44 + 4 * (SR // 2)
        sr_o, stem_o = wavfile.read(io.BytesIO(offline))
        sr_s, stem_s = wavfile.read(io.BytesIO(streamed))
        assert sr_s == sr_o and stem_s.shape == stem_o.shape
        np.testing.assert_allclose(stem_s.astype(np.int32),
                                   stem_o.astype(np.int32), atol=1)

    def test_streaming_block_param(self, server):
        url, _ = server
        wav_bytes = _make_wav_bytes(t=SR // 2)
        outs = []
        for block in ("1", "3", "not-a-number"):   # bad value -> default
            req = urllib.request.Request(
                f"{url}/api/separate/stream?prompt=vocals&block={block}",
                data=wav_bytes, headers={"Content-Type": "audio/wav"})
            with urllib.request.urlopen(req, timeout=120) as r:
                body = r.read()
            assert len(body) == 44 + 4 * (SR // 2)
            outs.append(np.frombuffer(body[44:], np.int16))
        np.testing.assert_allclose(outs[0].astype(np.int32),
                                   outs[1].astype(np.int32), atol=1)
        np.testing.assert_allclose(outs[0].astype(np.int32),
                                   outs[2].astype(np.int32), atol=1)

    def test_metrics_endpoint(self, server):
        url, service = server
        wav_bytes = _make_wav_bytes(t=SR // 4)
        req = urllib.request.Request(
            f"{url}/api/separate?prompt=vocals", data=wav_bytes,
            headers={"Content-Type": "audio/wav"})
        with urllib.request.urlopen(req, timeout=120) as r:
            n_bytes = len(r.read())

        with urllib.request.urlopen(f"{url}/api/metrics", timeout=30) as r:
            assert r.headers["Content-Type"].startswith("text/plain")
            text = r.read().decode()
        assert "# TYPE atsm_requests_total counter" in text
        assert 'atsm_requests_total{endpoint="separate"}' in text
        assert "atsm_device_busy_seconds_total" in text

        with urllib.request.urlopen(f"{url}/api/metrics?format=json",
                                    timeout=30) as r:
            snap = json.loads(r.read())
        ep = snap["endpoints"]["separate"]
        assert ep["requests"] >= 1
        assert ep["audio_seconds"] >= 0.25 - 1e-6
        assert ep["bytes"] >= n_bytes
        assert ep["seconds"] > 0
        assert snap["device_busy_seconds"] > 0
        assert snap["uptime_seconds"] > 0
        line = next(ln for ln in text.splitlines()
                    if ln.startswith('atsm_requests_total{endpoint="separate"}'))
        assert int(line.rsplit(" ", 1)[1]) <= ep["requests"]

    def test_metrics_carry_the_program_counters(self, server):
        """``/api/metrics`` exports ``utils.profiling.counts`` in both forms:
        an 8,000-sample song needs one chunk of the 2-chunk grid, run as one
        group of 2 whose second chunk starts past the end."""
        url, _ = server

        def counters():
            with urllib.request.urlopen(f"{url}/api/metrics?format=json",
                                        timeout=30) as r:
                return json.loads(r.read())["counters"]

        before = counters()
        req = urllib.request.Request(
            f"{url}/api/separate_all?stems=vocals,drums",
            data=_make_wav_bytes(t=8000),
            headers={"Content-Type": "audio/wav"})
        with urllib.request.urlopen(req, timeout=180) as r:
            r.read()
        after = counters()
        delta = {k: v - before.get(k, 0) for k, v in after.items()}
        assert delta["chunks.computed"] == 2 and delta["chunks.padded"] == 1
        assert delta["pcm.pieces"] == 1 and delta["pcm.pieces_early"] == 0
        assert delta["program.replays"] == 1
        assert after["program.captures"] >= 1
        assert after["text.tower_runs"] >= 1

        with urllib.request.urlopen(f"{url}/api/metrics", timeout=30) as r:
            text = r.read().decode()
        for name in ("program_captures", "program_replays", "text_tower_runs",
                     "chunks_computed", "chunks_padded", "pcm_pieces",
                     "pcm_pieces_early",
                     "launches_layer_tail", "launches_group_norm",
                     "launches_dec_join"):
            assert f"# TYPE atsm_{name}_total counter" in text
        line = next(ln for ln in text.splitlines()
                    if ln.startswith("atsm_chunks_computed_total "))
        assert int(line.split(" ")[1]) >= after["chunks.computed"]

    def test_separate_all_zip(self, server):
        url, _ = server
        wav_bytes = _make_wav_bytes(t=SR // 4)
        req = urllib.request.Request(
            f"{url}/api/separate_all?stems=vocals,drums", data=wav_bytes,
            headers={"Content-Type": "audio/wav"})
        with urllib.request.urlopen(req, timeout=180) as r:
            assert r.headers["Content-Type"] == "application/zip"
            payload = r.read()
        with zipfile.ZipFile(io.BytesIO(payload)) as zf:
            assert sorted(zf.namelist()) == ["extracted_drums.wav",
                                             "extracted_vocals.wav",
                                             "scales.json"]
            for name in zf.namelist():
                if name == "scales.json":
                    scales = json.loads(zf.read(name))
                    assert set(scales) == {"extracted_drums.wav",
                                           "extracted_vocals.wav"}
                    assert all(s > 0 for s in scales.values())
                    continue
                sr, stem = wavfile.read(io.BytesIO(zf.read(name)))
                assert sr == SR and stem.dtype == np.int16
                assert stem.shape == (SR // 4, 2)

    def test_separate_all_zip_sanitises_entry_names(self, server):
        url, _ = server
        req = urllib.request.Request(
            f"{url}/api/separate_all?stems=" +
            urllib.parse.quote("../../evil,a/b\\c"),
            data=_make_wav_bytes(t=SR // 4))
        with urllib.request.urlopen(req, timeout=180) as r:
            payload = r.read()
        with zipfile.ZipFile(io.BytesIO(payload)) as zf:
            for name in zf.namelist():
                assert ".." not in name and "/" not in name and "\\" not in name

    def test_oversize_upload_is_413(self, server, monkeypatch):
        url, _ = server
        monkeypatch.setenv("ATSM_MAX_UPLOAD_MB", "1")
        body = b"\x00" * (2 * 1024 * 1024)
        req = urllib.request.Request(f"{url}/api/separate", data=body)
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(req, timeout=30)
        assert exc.value.code == 413

    def test_separate_all_no_stems_is_400(self, server):
        url, _ = server
        req = urllib.request.Request(
            f"{url}/api/separate_all?stems=%20", data=_make_wav_bytes(t=SR // 4))
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(req, timeout=30)
        assert exc.value.code == 400

    def test_streaming_endpoint_bad_wav_is_400(self, server):
        url, _ = server
        req = urllib.request.Request(f"{url}/api/separate/stream",
                                     data=b"definitely not wav")
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(req, timeout=30)
        assert exc.value.code == 400

    def test_empty_body_is_400(self, server):
        url, _ = server
        req = urllib.request.Request(f"{url}/api/separate", data=b"")
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(req, timeout=30)
        assert exc.value.code == 400

    def test_garbage_body_is_400(self, server):
        url, _ = server
        req = urllib.request.Request(f"{url}/api/separate",
                                     data=b"not a wav file at all")
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(req, timeout=30)
        assert exc.value.code == 400

    def test_concurrent_requests_serialise_cleanly(self, server):
        import concurrent.futures as cf

        url, service = server
        before = service.requests_served
        wav_bytes = _make_wav_bytes(t=SR // 4)

        def plain():
            req = urllib.request.Request(f"{url}/api/separate?prompt=bass",
                                         data=wav_bytes)
            with urllib.request.urlopen(req, timeout=180) as r:
                return len(r.read())

        def jsonmode():
            req = urllib.request.Request(
                f"{url}/api/separate?prompt=drums&format=json",
                data=wav_bytes)
            with urllib.request.urlopen(req, timeout=180) as r:
                return len(json.loads(r.read())["stem_wav_b64"])

        def stream():
            req = urllib.request.Request(
                f"{url}/api/separate/stream?prompt=vocals", data=wav_bytes)
            with urllib.request.urlopen(req, timeout=180) as r:
                return len(r.read())

        with cf.ThreadPoolExecutor(max_workers=4) as ex:
            futs = [ex.submit(f) for f in (plain, plain, jsonmode, stream)]
            sizes = [f.result() for f in futs]
        assert all(s > 0 for s in sizes)
        assert service.requests_served == before + 4

    def test_unknown_path_is_404(self, server):
        url, _ = server
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(f"{url}/api/nope", timeout=30)
        assert exc.value.code == 404


class TestCodecs:
    def test_decode_wav_bytes_int16_and_float(self):
        rng = np.random.default_rng(2)
        wav = (0.25 * rng.standard_normal((2, 4410))).astype(np.float32)
        out_f = serve_http.decode_wav_bytes(serve_http.encode_wav_bytes(wav))
        np.testing.assert_allclose(out_f, wav, atol=2.0 / 32767)

    def test_decode_resamples_and_stereoises(self):
        rng = np.random.default_rng(3)
        mono = (1000 * rng.standard_normal((1, 11025))).astype(np.int16)
        out = serve_http.decode_wav_bytes(_pcm_wav_bytes(mono, 22050))
        assert out.shape == (2, 22050)
        np.testing.assert_allclose(out[0], out[1])


class TestStreamBlockAuto:
    def test_policy_latency_budget_picks_largest_under_budget(self):
        assert serve_http.pick_stream_block(0.065, 0.15, 4.5) == 9

    def test_policy_compute_bound_stays_small(self):
        assert serve_http.pick_stream_block(0.0, 2.0, 4.5) == 1

    def test_policy_throughput_floor_escalates_past_budget(self):
        b = serve_http.pick_stream_block(1.4, 0.01, 0.1)
        assert b > 10
        assert b <= 64

    def test_policy_respects_max_block(self):
        assert serve_http.pick_stream_block(0.0, 1e-6, 4.5,
                                            max_block=16) == 16

    def test_static_default_without_autotune(self, server):
        _, service = server
        svc = serve_http.SeparationService(service.separator,
                                           pretrained=False)
        assert svc.stream_block_default() == svc.STATIC_STREAM_BLOCK == 8

    def test_autotune_measures_and_fixes_default(self, server):
        _, service = server
        tune = service.autotune_stream_block(candidates=(1, 2))
        assert set(tune) >= {"block", "floor_s", "per_chunk_s",
                             "first_audio_s", "measured_s"}
        assert tune["block"] >= 1 and tune["per_chunk_s"] > 0
        assert len(tune["measured_s"]) == 2
        assert service.stream_block_default() == tune["block"]
        assert service.health()["stream_block"] == tune["block"]
        service._stream_auto = None

    def test_autotune_warms_the_chosen_block(self, server, monkeypatch):
        _, service = server
        built = []
        orig_cls = streaming_mod.StreamingSeparator

        class Spy(orig_cls):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                built.append(self.block_chunks)

        monkeypatch.setattr(streaming_mod, "StreamingSeparator", Spy)
        monkeypatch.setattr(serve_http, "pick_stream_block",
                            lambda *a, **kw: 5)
        try:
            tune = service.autotune_stream_block(candidates=(1, 2))
            assert tune["block"] == 5
            assert 5 in built, "chosen block was not run in the warm-up"
        finally:
            service._stream_auto = None

    def test_block_auto_resolves_via_service_default(self, server):
        url, service = server
        calls = []
        orig = service.stream_block_default

        def spy():
            calls.append(1)
            return orig()

        service.stream_block_default = spy
        try:
            wav_bytes = _make_wav_bytes(t=SR // 4)
            req = urllib.request.Request(
                f"{url}/api/separate/stream?prompt=vocals",
                data=wav_bytes, headers={"Content-Type": "audio/wav"})
            with urllib.request.urlopen(req, timeout=120) as r:
                assert len(r.read()) == 44 + 4 * (SR // 4)
            assert calls, "auto default was not consulted"
            calls.clear()
            req = urllib.request.Request(
                f"{url}/api/separate/stream?prompt=vocals&block=2",
                data=wav_bytes, headers={"Content-Type": "audio/wav"})
            with urllib.request.urlopen(req, timeout=120) as r:
                assert len(r.read()) == 44 + 4 * (SR // 4)
            assert not calls
        finally:
            service.stream_block_default = orig


# ---------------------------------------------------------------------------
# The port's service against the JAX service, in process
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def services(params, port_separator):
    jsep = JaxSeparator(params, **KW)
    return (serve_http.SeparationService(port_separator),
            jax_serve_http.SeparationService(jsep))


@pytest.fixture(scope="module")
def loud_wav():
    song = 0.3 * np.random.default_rng(0).standard_normal((2, 50000))
    return _pcm_wav_bytes((np.clip(song, -1, 1) * 32767).astype(np.int16), SR)


def _pcm(wav_bytes: bytes) -> np.ndarray:
    return wavfile.read(io.BytesIO(wav_bytes))[1].astype(np.int32)


class TestParityWithJax:
    def test_separate_int16_mode(self, services, loud_wav):
        port, jax_svc = services
        got, ctype = port.separate(loud_wav, "vocals", want_json=False)
        want, jtype = jax_svc.separate(loud_wav, "vocals", want_json=False)
        assert ctype == jtype == "audio/wav"
        assert len(got) == len(want) and got[:44] == want[:44]
        assert np.abs(_pcm(got) - _pcm(want)).max() <= 1

    def test_separate_all_zip(self, services, loud_wav):
        port, jax_svc = services
        stems = ("drums", "bass", "other", "vocals")
        got = zipfile.ZipFile(io.BytesIO(port.separate_all_zip(loud_wav,
                                                               stems)))
        want = zipfile.ZipFile(io.BytesIO(jax_svc.separate_all_zip(loud_wav,
                                                                   stems)))
        assert got.namelist() == want.namelist()
        for name in got.namelist():
            if name == "scales.json":
                g, w = (json.loads(z.read(name)) for z in (got, want))
                assert g.keys() == w.keys()
                for k in g:
                    assert g[k] == pytest.approx(w[k], rel=1e-6)
                continue
            assert np.abs(_pcm(got.read(name))
                          - _pcm(want.read(name))).max() <= 1

    @pytest.mark.parametrize("block", [2, 8])
    def test_separate_stream(self, services, loud_wav, block):
        port, jax_svc = services

        def run(svc):
            out, total = [], []
            svc.separate_stream(loud_wav, "drums", total.append, out.append,
                                block_chunks=block)
            body = b"".join(out)
            assert total == [len(body)]
            return body

        got, want = run(port), run(jax_svc)
        assert len(got) == len(want) == 44 + 4 * 50000
        assert got[:44] == want[:44]
        diff = np.abs(np.frombuffer(got[44:], "<i2").astype(np.int32)
                      - np.frombuffer(want[44:], "<i2").astype(np.int32))
        assert diff.max() <= 1

    @settings(max_examples=200, deadline=None)
    @given(floor=st.floats(0.0, 3.0), per_chunk=st.floats(1e-6, 3.0),
           hop=st.floats(0.01, 10.0), budget=st.floats(0.05, 5.0),
           rate=st.floats(0.5, 50.0), max_block=st.integers(1, 64))
    def test_pick_stream_block_equals_jax(self, floor, per_chunk, hop,
                                          budget, rate, max_block):
        assert serve_http.pick_stream_block(
            floor, per_chunk, hop, budget, rate, max_block) == \
            jax_serve_http.pick_stream_block(
                floor, per_chunk, hop, budget, rate, max_block)

    def test_prometheus_text_format(self):
        port, ref = serve_http.ServiceMetrics(), jax_serve_http.ServiceMetrics()
        for m in (port, ref):
            m.observe("separate", 1.25, 60.0, 10_584_044)
            m.observe("separate_stream", 0.5, 30.0, 5_292_044)
            m.observe("separate", 0.75, 2.5, 441_044)
            m.add_device(busy=1.5, wait=0.25)
            m.started = 1000.0

        # the port adds its program counters (utils.profiling.counts) after
        # the JAX service's lines; the rest is the same text
        snap, jsnap = port.snapshot(), ref.snapshot()
        counters = {"atsm_" + k.replace(".", "_") + "_total"
                    for k in snap.pop("counters")}

        def fixed(text: str) -> str:
            return "\n".join(
                ln for ln in text.splitlines()
                if not ln.startswith("atsm_uptime_seconds ")
                and ln.removeprefix("# HELP ").removeprefix("# TYPE ")
                .split(" ")[0] not in counters)

        assert fixed(port.prometheus()) == fixed(ref.prometheus())
        assert port.prometheus().endswith("\n")
        snap.pop("uptime_seconds"), jsnap.pop("uptime_seconds")
        assert snap == jsnap
