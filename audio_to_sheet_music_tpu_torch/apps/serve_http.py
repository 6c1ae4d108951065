"""The stdlib HTTP server: the counterpart of
``audio_to_sheet_music_tpu/apps/serve_http.py``.

Upload audio, type a free-text prompt, get the separated stem and the input
and output spectrograms, on the standard library's ``http.server`` (no
Gradio needed):

    python -m audio_to_sheet_music_tpu_torch.apps.serve --ui http [--port 7860]

Surface:
  ``GET  /``              single-page UI (no external assets)
  ``GET  /api/health``    ``{"status": "ok", "pretrained": ..., ...}``
  ``GET  /api/metrics``   Prometheus text exposition (or ``?format=json``):
                          per-endpoint request counts, wall seconds, audio
                          seconds and response bytes, and the device lock's
                          busy and wait seconds (busy / uptime is the card's
                          occupancy a deployment scales on), and the
                          program's own counters (``utils.profiling.counts``;
                          see ``ServiceMetrics``).
  ``POST /api/separate``  body = WAV bytes, query ``?prompt=...``; returns
                          ``audio/wav`` (``Separator.separate_pcm``: int16
                          in, int16 out, no float pass on the host) or, with
                          ``&format=json``, a JSON object carrying the stem
                          WAV and both spectrogram PNGs in base64 (what the
                          page uses).
  ``POST /api/separate/stream``  same request; the response WAV streams: the
                          separated samples are written as soon as their
                          overlap-add weights are final
                          (``infer.StreamingSeparator``, O(block) memory),
                          so playback can start before the song is done.
                          ``?block=N`` sets the chunks a device step takes
                          (clamped to [1, 64]); ``auto`` (the default) takes
                          the warm-up's measured choice
                          (``SeparationService.autotune_stream_block``).
  ``POST /api/separate_all``  body = WAV bytes, query ``?stems=a,b,...``
                          (default the four); returns a zip of
                          ``extracted_<stem>.wav`` files and ``scales.json``
                          from the group-pipelined int16 path
                          (``Separator.separate_all_pcm``).

Device work is serialised by one lock (one sweep at a time); WAV decode and
encode use ``utils.audio_io`` (scipy, no ffmpeg).
"""

from __future__ import annotations

import base64
import io
import json
import os
import threading
import time
from contextlib import contextmanager
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

SAMPLE_RATE = 44100

_PAGE = """<!DOCTYPE html>
<html lang="en"><head><meta charset="utf-8">
<title>Audio-Text Stem Separation</title>
<style>
  body { font-family: system-ui, sans-serif; max-width: 760px;
         margin: 2rem auto; padding: 0 1rem; color: #1a1a1a; }
  h1 { font-size: 1.4rem; }
  fieldset { border: 1px solid #ccc; border-radius: 8px; margin: 1rem 0; }
  label { display: block; margin: .5rem 0 .2rem; font-weight: 600; }
  input[type=text] { width: 100%; padding: .4rem; box-sizing: border-box; }
  button { padding: .5rem 1.2rem; font-size: 1rem; cursor: pointer; }
  .preset { margin: 0 .2rem .2rem 0; padding: .2rem .6rem; font-size: .85rem; }
  img { max-width: 100%; border: 1px solid #ddd; border-radius: 4px; }
  #status { margin: .8rem 0; font-style: italic; }
  .row { display: flex; gap: 1rem; flex-wrap: wrap; }
  .row > div { flex: 1 1 320px; }
</style></head><body>
<h1>Text-conditioned stem separation</h1>
<p>Upload audio and describe the sound to extract.</p>
<fieldset><legend>Input</legend>
  <label for="file">audio file (.wav)</label>
  <input type="file" id="file" accept=".wav,audio/wav">
  <label for="prompt">prompt</label>
  <input type="text" id="prompt" value="vocals">
  <div style="margin-top:.4rem">
    <button class="preset" onclick="setPrompt('vocals')">vocals</button>
    <button class="preset" onclick="setPrompt('drums')">drums</button>
    <button class="preset" onclick="setPrompt('bass')">bass</button>
    <button class="preset" onclick="setPrompt('other')">other</button>
  </div>
  <p><button id="go" onclick="separate()">Separate</button>
     <button id="goall" onclick="separateAll()">All stems (zip)</button></p>
</fieldset>
<div id="status">idle</div>
<div class="row">
  <div><label>mixture</label><audio id="mix" controls></audio></div>
  <div><label>separated stem</label><audio id="stem" controls></audio></div>
</div>
<div class="row">
  <div><label>input spectrogram</label><img id="spec_in" alt=""></div>
  <div><label>output spectrogram</label><img id="spec_out" alt=""></div>
</div>
<script>
function setPrompt(p) { document.getElementById('prompt').value = p; }
async function separateAll() {
  const f = document.getElementById('file').files[0];
  const status = document.getElementById('status');
  if (!f) { status.textContent = 'choose a .wav file first'; return; }
  status.textContent = 'separating all stems…';
  document.getElementById('goall').disabled = true;
  try {
    const r = await fetch('/api/separate_all',
                          { method: 'POST', body: await f.arrayBuffer(),
                            headers: { 'Content-Type': 'audio/wav' } });
    if (!r.ok) { throw new Error(await r.text()); }
    const a = document.createElement('a');
    a.href = URL.createObjectURL(await r.blob());
    a.download = 'stems.zip';
    a.click();
    status.textContent = 'all stems separated — zip downloaded';
  } catch (e) { status.textContent = 'error: ' + e.message; }
  document.getElementById('goall').disabled = false;
}
async function separate() {
  const f = document.getElementById('file').files[0];
  const status = document.getElementById('status');
  if (!f) { status.textContent = 'choose a .wav file first'; return; }
  const prompt = document.getElementById('prompt').value || 'vocals';
  status.textContent = 'separating "' + prompt + '"…';
  document.getElementById('go').disabled = true;
  try {
    document.getElementById('mix').src = URL.createObjectURL(f);
    const body = await f.arrayBuffer();
    const r = await fetch('/api/separate?format=json&prompt=' +
                          encodeURIComponent(prompt),
                          { method: 'POST', body: body,
                            headers: { 'Content-Type': 'audio/wav' } });
    if (!r.ok) { throw new Error(await r.text()); }
    const out = await r.json();
    document.getElementById('stem').src = 'data:audio/wav;base64,' + out.stem_wav_b64;
    document.getElementById('spec_in').src = 'data:image/png;base64,' + out.spec_in_png_b64;
    document.getElementById('spec_out').src = 'data:image/png;base64,' + out.spec_out_png_b64;
    status.textContent = out.status;
  } catch (e) { status.textContent = 'error: ' + e.message; }
  document.getElementById('go').disabled = false;
}
</script></body></html>
"""


def decode_wav_bytes(data: bytes, prefer_pcm: bool = False) -> np.ndarray:
    """WAV bytes -> (2, T) at 44.1 kHz (no ffmpeg formats).

    With ``prefer_pcm`` the common case, 16-bit stereo at 44.1 kHz, comes
    back as int16 untouched (``Separator`` converts it on the device);
    everything else is normalised to float32."""
    from scipy.io import wavfile

    from ..utils import audio_io

    if prefer_pcm:
        sr, raw = wavfile.read(io.BytesIO(data))
        if (raw.dtype == np.int16 and raw.ndim == 2 and raw.shape[1] == 2
                and int(sr) == SAMPLE_RATE):
            return np.ascontiguousarray(raw.T)
        wav = audio_io.payload_to_float(raw)
        wav = wav.T if wav.ndim == 2 else wav[None, :]
        return audio_io.to_stereo(audio_io.resample(
            np.ascontiguousarray(wav), int(sr), SAMPLE_RATE))
    sr, wav = audio_io.read_wav(io.BytesIO(data))
    return audio_io.to_stereo(audio_io.resample(wav, sr, SAMPLE_RATE))


def encode_wav_bytes(wav: np.ndarray, sr: int = SAMPLE_RATE) -> bytes:
    """float32 (C, T) -> 16-bit PCM WAV bytes."""
    wav = np.asarray(wav, np.float32)
    return wav_header(wav.shape[-1], wav.shape[0], sr) + pcm16_bytes(wav)


def wav_header(n_samples: int, channels: int = 2,
               sr: int = SAMPLE_RATE) -> bytes:
    """RIFF/WAVE header for a 16-bit PCM payload of known length —
    written first so the rest of the file can stream behind it."""
    import struct

    data_bytes = n_samples * channels * 2
    return (b"RIFF" + struct.pack("<I", 36 + data_bytes) + b"WAVE"
            + b"fmt " + struct.pack("<IHHIIHH", 16, 1, channels, sr,
                                    sr * channels * 2, channels * 2, 16)
            + b"data" + struct.pack("<I", data_bytes))


def pcm16_bytes(piece: np.ndarray) -> bytes:
    """float32 (2, n) -> interleaved little-endian int16 frames (rounded,
    matching the device quantisers — truncation would bias toward zero)."""
    data = np.clip(np.asarray(piece, np.float32), -1.0, 1.0)
    return np.round(data.T * 32767.0).astype("<i2").tobytes()


def _spectrogram_png(wav: np.ndarray, title: str, device="cuda") -> bytes:
    """The PNG of ``wav``'s spectrogram; its dB image is computed on
    ``device``."""
    from ..utils import plotting

    fig = plotting.plot_spectrogram(wav, title, device=device)
    buf = io.BytesIO()
    fig.savefig(buf, format="png", dpi=80, bbox_inches="tight")
    import matplotlib.pyplot as plt

    plt.close(fig)
    return buf.getvalue()


class ServiceMetrics:
    """Per-endpoint serving counters plus device-lock occupancy.

    Everything is a monotonic counter (Prometheus convention: rates and
    averages are derived by the scraper), guarded by one mutex so the
    handler threads of ``ThreadingHTTPServer`` can record concurrently.
    ``device_busy_seconds`` integrates the time the device lock was held
    (on a one-card server busy / uptime is the occupancy a deployment
    scales on); ``device_wait_seconds`` integrates the time requests queued
    for it (the saturation signal).

    The program's counters (``utils.profiling.counts``, process-wide) come
    with them, as ``atsm_<name with _ for .>_total`` and under ``counters``
    in the JSON form; what an operator reads in them:

    - ``program_captures``: chunk programs built (on a card, captured as a
      CUDA graph).  It grows with each new chunk geometry and whole-song
      length bucket; growth under steady traffic means programs are being
      evicted and built again.  ``program_replays``: program calls.
    - ``text_tower_runs`` / ``text_cache_hits``: prompts embedded by the
      text tower against prompts served from the cache.
    - ``chunks_computed`` / ``chunks_padded``: chunks ``/api/separate_all``
      ran, and those of them past the song's end (bucket padding: work
      that returns nothing).
    - ``pcm_pieces`` / ``pcm_pieces_early``: the int16 pieces
      ``/api/separate_all`` filled, and those filled while the card still
      ran the song's later groups.
    - ``stream_blocks``: blocks the stream endpoint ran.
    - ``launches_<kernel>``: each hand-written kernel's launches, replays
      included (``ops.select.launch_counts``)."""

    def __init__(self):
        self._mu = threading.Lock()
        self.started = time.time()
        self.endpoints: dict = {}
        self.device_busy_seconds = 0.0
        self.device_wait_seconds = 0.0

    def observe(self, endpoint: str, seconds: float,
                audio_seconds: float, bytes_out: int) -> None:
        with self._mu:
            e = self.endpoints.setdefault(endpoint, {
                "requests": 0, "seconds": 0.0,
                "audio_seconds": 0.0, "bytes": 0})
            e["requests"] += 1
            e["seconds"] += seconds
            e["audio_seconds"] += audio_seconds
            e["bytes"] += bytes_out

    def add_device(self, busy: float, wait: float) -> None:
        with self._mu:
            self.device_busy_seconds += busy
            self.device_wait_seconds += wait

    def snapshot(self) -> dict:
        from ..utils import profiling

        with self._mu:
            return {
                "uptime_seconds": time.time() - self.started,
                "device_busy_seconds": self.device_busy_seconds,
                "device_wait_seconds": self.device_wait_seconds,
                "endpoints": {k: dict(v) for k, v in self.endpoints.items()},
                "counters": profiling.counts(),
            }

    def prometheus(self) -> str:
        """Text exposition format 0.0.4 (what Prometheus/Grafana scrape)."""
        s = self.snapshot()
        lines = [
            "# HELP atsm_uptime_seconds Seconds since server start.",
            "# TYPE atsm_uptime_seconds gauge",
            f"atsm_uptime_seconds {s['uptime_seconds']:.3f}",
            "# HELP atsm_device_busy_seconds_total Time the device lock "
            "was held (single-chip utilisation = busy/uptime).",
            "# TYPE atsm_device_busy_seconds_total counter",
            f"atsm_device_busy_seconds_total {s['device_busy_seconds']:.3f}",
            "# HELP atsm_device_wait_seconds_total Time requests queued "
            "for the device lock (saturation).",
            "# TYPE atsm_device_wait_seconds_total counter",
            f"atsm_device_wait_seconds_total {s['device_wait_seconds']:.3f}",
        ]
        per = [
            ("atsm_requests_total", "requests", "counter",
             "Requests completed.", "{v}"),
            ("atsm_request_seconds_total", "seconds", "counter",
             "Wall-clock spent serving.", "{v:.3f}"),
            ("atsm_audio_seconds_total", "audio_seconds", "counter",
             "Input audio seconds processed.", "{v:.3f}"),
            ("atsm_response_bytes_total", "bytes", "counter",
             "Response payload bytes.", "{v}"),
        ]
        for name, key, typ, help_, fmt in per:
            lines.append(f"# HELP {name} {help_}")
            lines.append(f"# TYPE {name} {typ}")
            for ep, e in sorted(s["endpoints"].items()):
                lines.append(f'{name}{{endpoint="{ep}"}} '
                             + fmt.format(v=e[key]))
        for key, v in sorted(s["counters"].items()):
            name = "atsm_" + key.replace(".", "_") + "_total"
            lines += [f"# HELP {name} Program counter {key}.",
                      f"# TYPE {name} counter", f"{name} {v}"]
        return "\n".join(lines) + "\n"


def pick_stream_block(floor_s: float, per_chunk_s: float, hop_s: float,
                      first_audio_budget_s: float = 1.5,
                      min_realtime: float = 8.0,
                      max_block: int = 64) -> int:
    """The streaming block size from the measured step model
    ``t(block) = floor_s + block * per_chunk_s``.

    The largest block whose first audio (one block step) stays inside
    ``first_audio_budget_s``: throughput grows with the block as the floor
    amortises, so the largest under budget is the fastest.  If even that
    block runs slower than ``min_realtime`` x realtime (throughput(b) =
    b * hop_s / t(b)), latency yields and the block grows while throughput
    still improves: a stream that keeps up serves an interactive client
    better than a fast first second that then stalls.  The 1.5 s budget
    and the 8x floor are the JAX package's values; ``chip_smoke.py``'s
    phase 6 measures what they choose on the H100.
    """
    def t(b: int) -> float:
        return floor_s + b * per_chunk_s

    best = 1
    for b in range(1, max_block + 1):
        if t(b) <= first_audio_budget_s:
            best = b
    while (best < max_block
           and best * hop_s / t(best) < min_realtime
           and (best + 1) * hop_s / t(best + 1) > best * hop_s / t(best)):
        best += 1
    return best


class SeparationService:
    """A ``Separator`` behind one lock: the card runs one sweep at a time,
    so concurrent requests queue here."""

    #: the ``?block=auto`` block when ``autotune_stream_block`` has not run
    #: (no warm-up): the JAX package's value; ``chip_smoke.py``'s phase 6
    #: measures it on the H100 beside the autotuned choice
    STATIC_STREAM_BLOCK = 8

    def __init__(self, separator, pretrained: bool = False,
                 spectrograms: bool = True):
        self.separator = separator
        self.pretrained = pretrained
        self.spectrograms = spectrograms
        self._lock = threading.Lock()
        self.metrics = ServiceMetrics()
        self.requests_served = 0
        self._stream_auto: dict | None = None

    def autotune_stream_block(self, candidates: tuple[int, int] = (2, 8),
                              first_audio_budget_s: float = 1.5,
                              min_realtime: float = 8.0) -> dict:
        """Measure the streaming step model on the live device and fix the
        ``?block=auto`` default from it.

        Runs one block step of silence at each candidate size twice (the
        first warms the device's caches, the second is timed and includes
        the copy of the emitted piece to the host), fits ``t(b) = floor +
        b * per_chunk`` and stores ``pick_stream_block``'s choice; a block
        of the chosen size then runs once too, so the first client finds it
        warm.  Meant for server warm-up (``apps.serve --warmup-seconds``);
        a server without warm-up serves ``STATIC_STREAM_BLOCK``.  On a
        separator with a mesh each candidate rounds up to the mesh's size;
        when both become one block there is nothing to fit, and this returns
        ``{"block": STATIC_STREAM_BLOCK, "skipped": "mesh"}``.
        """
        from ..infer import streaming

        b1, b2 = candidates
        assert b2 > b1 >= 1
        times = {}
        with self._device():
            for b in (b1, b2):
                stream = streaming.StreamingSeparator(
                    self.separator, stems=("vocals",), block_chunks=b)
                b = stream.block_chunks     # a mesh rounds it up
                if b in times:
                    continue
                silence = np.zeros((2, stream._span), np.float32)
                stream.feed(silence)                   # warm
                stream2 = streaming.StreamingSeparator(
                    self.separator, stems=("vocals",), block_chunks=b)
                t0 = time.perf_counter()
                stream2.feed(silence)                  # timed
                times[b] = time.perf_counter() - t0
        if len(times) < 2:      # the mesh made both candidates one block
            return {"block": self.STATIC_STREAM_BLOCK, "skipped": "mesh"}
        b1, b2 = sorted(times)
        per_chunk = max((times[b2] - times[b1]) / (b2 - b1), 1e-4)
        floor = max(times[b1] - b1 * per_chunk, 0.0)
        hop_s = (self.separator.segment - self.separator.overlap) \
            / self.separator.sample_rate
        block = pick_stream_block(floor, per_chunk, hop_s,
                                  first_audio_budget_s, min_realtime)
        if block not in times:
            with self._device():
                stream = streaming.StreamingSeparator(
                    self.separator, stems=("vocals",), block_chunks=block)
                stream.feed(np.zeros((2, stream._span), np.float32))
        self._stream_auto = {
            "block": block,
            "floor_s": round(floor, 4),
            "per_chunk_s": round(per_chunk, 4),
            "hop_s": round(hop_s, 4),
            "first_audio_s": round(floor + block * per_chunk, 4),
            "measured_s": {str(b): round(t, 4) for b, t in times.items()},
        }
        return self._stream_auto

    def stream_block_default(self) -> int:
        """The ``?block=auto`` resolution: the measured choice when the
        server was warmed, else the static default (measuring inside a live
        request would bill that client for it)."""
        if self._stream_auto is not None:
            return self._stream_auto["block"]
        return self.STATIC_STREAM_BLOCK

    @contextmanager
    def _device(self):
        """The device lock, instrumented: wait time (queueing) and hold
        time (occupancy) flow into ``metrics``."""
        t0 = time.perf_counter()
        with self._lock:
            t1 = time.perf_counter()
            try:
                yield
            finally:
                self.metrics.add_device(busy=time.perf_counter() - t1,
                                        wait=t1 - t0)

    def health(self) -> dict:
        return {
            "status": "ok",
            "pretrained": self.pretrained,
            "segment_seconds": self.separator.segment / self.separator.sample_rate,
            "overlap_seconds": self.separator.overlap / self.separator.sample_rate,
            "requests_served": self.requests_served,
            "stream_block": self.stream_block_default(),
            "stream_autotune": self._stream_auto,
        }

    def separate(self, wav_bytes: bytes, prompt: str,
                 want_json: bool) -> tuple[bytes, str]:
        """-> (payload, content_type)."""
        t_req = time.perf_counter()
        pngs = None
        if not want_json:
            # the hot path: an int16 upload stays int16 to the device,
            # absolute int16 comes back, and its bytes go into the WAV as
            # they are: no pass over the samples on the host
            wav = decode_wav_bytes(wav_bytes, prefer_pcm=True)
            with self._device():
                pcm = self.separator.separate_pcm(wav, prompt)
                self.requests_served += 1
            payload = (wav_header(pcm.shape[-1])
                       + np.ascontiguousarray(pcm.T).tobytes())
            self.metrics.observe("separate", time.perf_counter() - t_req,
                                 wav.shape[-1] / SAMPLE_RATE, len(payload))
            return payload, "audio/wav"
        wav = decode_wav_bytes(wav_bytes)
        with self._device():
            # the lock covers all of this request's device work, the
            # spectrograms' STFTs too, and the figure rendering, because
            # pyplot's state is not thread-safe (handler threads are
            # concurrent under ThreadingHTTPServer)
            stem = self.separator.separate(wav, prompt)
            if self.spectrograms:
                device = self.separator.device
                pngs = (_spectrogram_png(wav, "input mixture", device),
                        _spectrogram_png(stem, f"separated: {prompt}",
                                         device))
            self.requests_served += 1
        stem_wav = encode_wav_bytes(stem)
        out = {
            "stem_wav_b64": base64.b64encode(stem_wav).decode("ascii"),
            "status": (f"separated '{prompt}' from "
                       f"{wav.shape[-1] / SAMPLE_RATE:.1f} s of audio"),
        }
        if pngs is not None:
            out["spec_in_png_b64"] = base64.b64encode(pngs[0]).decode("ascii")
            out["spec_out_png_b64"] = base64.b64encode(pngs[1]).decode("ascii")
        else:
            out["spec_in_png_b64"] = out["spec_out_png_b64"] = ""
        payload = json.dumps(out).encode()
        self.metrics.observe("separate", time.perf_counter() - t_req,
                             wav.shape[-1] / SAMPLE_RATE, len(payload))
        return payload, "application/json"

    def separate_all_zip(self, wav_bytes: bytes,
                         stems: tuple[str, ...]) -> bytes:
        """Every requested stem through the group-pipelined int16 path,
        zipped as ``extracted_<stem>.wav`` (the ``separate`` command's
        names).  The int16 bytes go into the zip as they are (STORED: WAV
        does not deflate); the shared scale keeps the stems' relative
        levels, and ``scales.json`` records it (``sample = pcm * scale /
        32767``), so absolute levels can be recovered."""
        import re
        import zipfile

        t_req = time.perf_counter()
        wav = decode_wav_bytes(wav_bytes, prefer_pcm=True)
        with self._device():
            pcm, scales = self.separator.separate_all_pcm(wav, stems=stems)
            self.requests_served += 1
        buf = io.BytesIO()
        with zipfile.ZipFile(buf, "w", zipfile.ZIP_STORED) as zf:
            names = {}
            for i, stem in enumerate(stems):
                # prompts are free text: keep entry names traversal-safe
                safe = re.sub(r"[^\w \-]+", "_", stem).strip() or f"stem{i}"
                names[stem] = f"extracted_{safe}.wav"
                zf.writestr(
                    names[stem],
                    wav_header(pcm.shape[-1])
                    + np.ascontiguousarray(pcm[i].T).tobytes())
            zf.writestr("scales.json", json.dumps(
                {names[stem]: float(scales[i])
                 for i, stem in enumerate(stems)},
                indent=2))
        payload = buf.getvalue()
        self.metrics.observe("separate_all", time.perf_counter() - t_req,
                             wav.shape[-1] / SAMPLE_RATE, len(payload))
        return payload

    def separate_stream(self, wav_bytes: bytes, prompt: str, begin, write,
                        block_chunks: int = 8) -> None:
        """Progressive separation.  Calls ``begin(total_body_bytes)`` once
        after decoding (so the caller can send Content-Length first), then
        ``write(bytes)`` with the WAV header and each finalised piece as
        ``StreamingSeparator`` emits it.  The samples emitted always number
        the input's (the stream's offline-equality contract); a mismatch
        would be cut or zero-padded, so the wire length never lies."""
        from ..infer import streaming

        t_req = time.perf_counter()
        wav = decode_wav_bytes(wav_bytes)
        t = wav.shape[-1]
        # build the stream (and run the prompt's text tower) BEFORE
        # begin(): a failure up to here still gets a clean 400.  The lock
        # is taken per device block, not across client writes: a slow
        # consumer must not starve other requests while its socket drains.
        # Each stream holds its own carry, so interleaving is safe.
        with self._device():
            stream = streaming.StreamingSeparator(
                self.separator, stems=(prompt,), block_chunks=block_chunks)
        begin(44 + 4 * t)
        write(wav_header(t))
        written = 0
        feed_step = max(stream.hop * block_chunks, 1)

        def emit(piece) -> None:
            nonlocal written
            chunk = pcm16_bytes(piece[0])[: 4 * t - written]
            written += len(chunk)
            write(chunk)

        for start in range(0, t, feed_step):
            with self._device():
                pieces = stream.feed(wav[:, start:start + feed_step])
            for piece in pieces:
                emit(piece)
        with self._device():
            tail = stream.flush()
            self.requests_served += 1
        if tail.shape[-1]:
            emit(tail)
        if written < 4 * t:
            write(b"\x00" * (4 * t - written))
        self.metrics.observe("separate_stream",
                             time.perf_counter() - t_req,
                             t / SAMPLE_RATE, 44 + written)


class _Handler(BaseHTTPRequestHandler):
    service: SeparationService  # set by make_server

    def _send(self, code: int, payload: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)

    def log_message(self, fmt, *args):  # noqa: D102 - quiet by default
        pass

    def do_GET(self) -> None:  # noqa: N802 - http.server API
        url = urlparse(self.path)
        path = url.path
        if path in ("/", "/index.html"):
            self._send(200, _PAGE.encode(), "text/html; charset=utf-8")
        elif path == "/api/health":
            self._send(200, json.dumps(self.service.health()).encode(),
                       "application/json")
        elif path == "/api/metrics":
            if parse_qs(url.query).get("format", ["prom"])[0] == "json":
                self._send(200, json.dumps(
                    self.service.metrics.snapshot()).encode(),
                    "application/json")
            else:
                self._send(200, self.service.metrics.prometheus().encode(),
                           "text/plain; version=0.0.4; charset=utf-8")
        else:
            self._send(404, b"not found", "text/plain")

    def do_POST(self) -> None:  # noqa: N802 - http.server API
        url = urlparse(self.path)
        if url.path not in ("/api/separate", "/api/separate/stream",
                            "/api/separate_all"):
            self._send(404, b"not found", "text/plain")
            return
        q = parse_qs(url.query)
        prompt = (q.get("prompt", ["vocals"])[0] or "vocals").strip()
        want_json = q.get("format", ["wav"])[0] == "json"
        max_mb = int(os.environ.get("ATSM_MAX_UPLOAD_MB", "512"))
        try:
            n = int(self.headers.get("Content-Length", "0"))
            if n <= 0:
                raise ValueError("empty body; POST WAV bytes")
            if n > max_mb * 1024 * 1024:
                # drain a bounded amount so the client's in-flight body
                # write doesn't EPIPE before it reads the 413; beyond
                # that, close (draining arbitrarily defeats the cap)
                remaining = min(n, 64 * 1024 * 1024)
                while remaining > 0:
                    got = self.rfile.read(min(remaining, 1 << 20))
                    if not got:
                        break
                    remaining -= len(got)
                self._send(413, f"upload exceeds {max_mb} MB "
                           "(ATSM_MAX_UPLOAD_MB)".encode(), "text/plain")
                self.close_connection = True
                return
            body = self.rfile.read(n)
        except Exception as e:  # noqa: BLE001 - surface to the client
            self._send(400, f"separation failed: {e}".encode(), "text/plain")
            return
        if url.path == "/api/separate/stream":
            # ``block`` = device chunks a streaming step: smaller blocks
            # bring the first audio sooner, larger ones spread the fixed
            # cost of a step.  ``auto`` (and anything not an integer) takes
            # the warm-up's measured choice; an integer always overrides.
            try:
                block = int(q.get("block", ["auto"])[0])
            except ValueError:
                block = self.service.stream_block_default()
            self._stream_response(body, prompt, max(1, min(block, 64)))
            return
        try:
            if url.path == "/api/separate_all":
                stems = tuple(s.strip() for s in
                              q.get("stems", ["vocals,drums,bass,other"])[0]
                              .split(",") if s.strip())
                if not stems:
                    raise ValueError("no stems requested")
                payload = self.service.separate_all_zip(body, stems)
                ctype = "application/zip"
            else:
                payload, ctype = self.service.separate(body, prompt,
                                                       want_json)
        except Exception as e:  # noqa: BLE001 - surface to the client
            self._send(400, f"separation failed: {e}".encode(), "text/plain")
            return
        self._send(200, payload, ctype)

    def _stream_response(self, body: bytes, prompt: str,
                         block_chunks: int = 8) -> None:
        """Progressive WAV: headers carry the exact Content-Length (input
        length is known), the body flushes piece by piece as the
        streaming separator finalises samples."""
        begun = False

        def begin(total: int) -> None:
            nonlocal begun
            self.send_response(200)
            self.send_header("Content-Type", "audio/wav")
            self.send_header("Content-Length", str(total))
            self.end_headers()
            begun = True

        def write(chunk: bytes) -> None:
            self.wfile.write(chunk)
            self.wfile.flush()

        try:
            self.service.separate_stream(body, prompt, begin, write,
                                         block_chunks=block_chunks)
        except Exception as e:  # noqa: BLE001 - surface or tear down
            if begun:
                # 200 + Content-Length already on the wire: injecting a
                # 400 now would be decoded as PCM garbage — close instead,
                # so the client sees a truncated body vs the promised
                # length and can tell the stream failed.
                self.close_connection = True
                return
            self._send(400, f"separation failed: {e}".encode(), "text/plain")


def make_server(service: SeparationService, host: str = "127.0.0.1",
                port: int = 0) -> ThreadingHTTPServer:
    """Bind (port 0 = ephemeral) without blocking; the caller runs
    ``serve_forever`` (on a thread, as the tests and ``chip_smoke.py`` do)."""
    handler = type("BoundHandler", (_Handler,), {"service": service})
    return ThreadingHTTPServer((host, port), handler)


def serve(service: SeparationService, host: str, port: int) -> None:
    httpd = make_server(service, host, port)
    print(f"serving (stdlib HTTP UI) on "
          f"http://{host}:{httpd.server_address[1]}/")
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
