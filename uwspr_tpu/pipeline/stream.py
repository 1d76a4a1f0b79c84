"""Streaming orchestration: continuous sample streams -> overlapped windows
-> decoded spots, with checkpoint/resume.

Window semantics match the reference's sliding_window_stream_to_pdu
(lib/sliding_window_stream_to_pdu_impl.cc:97-138): a ring buffer of
capacity C*fl samples; once >= fl samples are buffered, emit a 120 s window
and advance by the 9 s hop (111 s overlap), guaranteeing every 111 s frame
lies wholly inside some window.

Multi-channel streams are first-class: feed (channels, n) arrays and every
window batch is decoded together (the accelerator replaces the reference's
block-thread pipeline parallelism with batch width, SURVEY.md section 2.4).
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field

import numpy as np

from uwspr_tpu.config import (
    PipelineConfig,
    StreamConfig,
    resolve_backend,
    with_serving_defaults,
)
from uwspr_tpu.pipeline.decoder import DecodeResult, Spot, WindowDecoder
from uwspr_tpu.protocol.messages import HashTable


class SlidingWindow:
    """Single-channel ring buffer with fl-window / shift-hop emission."""

    def __init__(self, cfg: StreamConfig | None = None):
        self.cfg = cfg or StreamConfig()
        self._buf = np.zeros(0, dtype=np.complex64)

    @property
    def hop(self) -> int:
        return self.cfg.shift * self.cfg.fs

    def push(self, samples: np.ndarray) -> list[np.ndarray]:
        """Append samples; return every complete window now available."""
        cap = self.cfg.capacity_windows * self.cfg.fl
        buf = np.concatenate(
            [self._buf, np.asarray(samples, dtype=np.complex64)])
        # circular-buffer overflow drops the oldest samples (reference uses
        # a boost::circular_buffer of capacity C*fl)
        self._buf = buf[-cap:] if len(buf) > cap else buf
        out = []
        while len(self._buf) >= self.cfg.fl:
            out.append(self._buf[:self.cfg.fl].copy())
            self._buf = self._buf[self.hop:]
        return out

    def state(self) -> np.ndarray:
        return self._buf.copy()

    def restore(self, buf: np.ndarray) -> None:
        self._buf = np.asarray(buf, dtype=np.complex64).copy()


@dataclass
class StreamStats:
    windows: int = 0
    candidates: int = 0
    fano_attempts: int = 0
    spots: int = 0
    decode_seconds: float = 0.0


class StreamDecoder:
    """Continuous decoder over one or many channels.

    engine: "host" (staged orchestration), "device" (one XLA program per
    window), "hybrid" (device program through the gates, host Fano), or
    "auto" (the platform's choice, config.resolve_backend).
    """

    def __init__(self, config: PipelineConfig | None = None,
                 n_channels: int = 1, hashtable: HashTable | None = None,
                 engine: str = "auto", passes: int = 1):
        self.config = config or PipelineConfig()
        self.passes = passes
        if engine == "auto":
            engine = resolve_backend().engine
        self.engine = engine
        self.hashtable = hashtable if hashtable is not None else HashTable()
        if engine in ("device", "hybrid"):
            from uwspr_tpu.pipeline.jit_decoder import DeviceDecoder
            dcfg = self.config
            if resolve_backend().serving_defaults:
                # serving point for fields left at config defaults (per-
                # window decode, so no cross-window compaction)
                dcfg = with_serving_defaults(dcfg, 1)
            self._device = DeviceDecoder(
                dcfg,
                fano_mode="host" if engine == "hybrid" else "device")
            self.decoder = None
        else:
            self._device = None
            self.decoder = WindowDecoder(self.config,
                                         hashtable=self.hashtable)
        self.windows = [SlidingWindow(self.config.stream)
                        for _ in range(n_channels)]
        self.stats = StreamStats()

    def _decode_once(self, window: np.ndarray) -> DecodeResult:
        if self._device is None:
            return self.decoder(window)
        out = self._device(window)
        r = DecodeResult(spots=self._device.spots(out, self.hashtable))
        r.n_candidates = int(out.valid.sum())
        r.n_fano_attempts = int(out.fano_attempts)
        return r

    def _decode(self, window: np.ndarray) -> DecodeResult:
        if self.passes <= 1:
            return self._decode_once(window)
        # successive interference cancellation between passes
        from uwspr_tpu.pipeline.multipass import multipass_spots
        meta = {"cand": 0, "fano": 0}

        def decode_fn(z):
            r = self._decode_once(z)
            meta["cand"] = max(meta["cand"], r.n_candidates)
            meta["fano"] += r.n_fano_attempts
            return r.spots

        spots = multipass_spots(window, decode_fn, self.config,
                                passes=self.passes)
        out = DecodeResult(spots=spots)
        out.n_candidates = meta["cand"]
        out.n_fano_attempts = meta["fano"]
        return out

    def push(self, samples: np.ndarray) -> list[tuple[int, DecodeResult]]:
        """samples: (n,) or (channels, n). Returns [(channel, result), ...]."""
        samples = np.atleast_2d(np.asarray(samples, dtype=np.complex64))
        results: list[tuple[int, DecodeResult]] = []
        for ch, row in enumerate(samples):
            for window in self.windows[ch].push(row):
                t0 = time.perf_counter()
                r = self._decode(window)
                self.stats.decode_seconds += time.perf_counter() - t0
                self.stats.windows += 1
                self.stats.candidates += r.n_candidates
                self.stats.fano_attempts += r.n_fano_attempts
                self.stats.spots += len(r.spots)
                results.append((ch, r))
        return results

    # -- checkpoint/resume (SURVEY.md section 5) ---------------------------

    def save_checkpoint(self, directory: str | os.PathLike) -> None:
        os.makedirs(directory, exist_ok=True)
        np.savez(os.path.join(directory, "ring_buffers.npz"),
                 **{f"ch{i}": w.state() for i, w in enumerate(self.windows)})
        self.hashtable.save(os.path.join(directory, "hashtable.txt"))
        with open(os.path.join(directory, "stats.json"), "w") as f:
            json.dump(self.stats.__dict__, f)

    def load_checkpoint(self, directory: str | os.PathLike) -> None:
        data = np.load(os.path.join(directory, "ring_buffers.npz"))
        for i, w in enumerate(self.windows):
            key = f"ch{i}"
            if key in data:
                w.restore(data[key])
        ht_path = os.path.join(directory, "hashtable.txt")
        if os.path.exists(ht_path):
            self.hashtable = HashTable.load(ht_path)
            if self.decoder is not None:
                self.decoder.hashtable = self.hashtable
        stats_path = os.path.join(directory, "stats.json")
        if os.path.exists(stats_path):
            with open(stats_path) as f:
                self.stats = StreamStats(**json.load(f))


class BatchedStreamDecoder:
    """Production serving engine: native C++ ingest/windowing + fixed-width
    batched XLA decode.

    The reference's runtime is GNU Radio's C++ scheduler — per-block
    threads moving samples through ring buffers, one window decoded at a
    time. Here the native windower (pipeline/native/stream_native.cc)
    ingests multichannel blocks and extracts ready windows straight into a
    batched (W, 2, fl) device-feed buffer, and ONE compiled XLA program of
    fixed width ``batch_windows`` decodes each batch (the vmapped pipeline
    + cross-window Fano batch). Short batches at flush are zero-padded to
    the compiled width — no recompiles, ever.

    push() returns [(channel, DecodeResult), ...] for every batch that
    filled; flush() drains the remaining ready windows.
    """

    def __init__(self, config: PipelineConfig | None = None,
                 n_channels: int = 1, batch_windows: int = 32,
                 hashtable: HashTable | None = None,
                 fano_mode: str = "device"):
        from uwspr_tpu.pipeline.jit_decoder import DeviceDecoder
        from uwspr_tpu.pipeline.native import NativeWindower
        self.config = config or PipelineConfig()
        scfg = self.config.stream
        self.batch_windows = batch_windows
        self.hashtable = hashtable if hashtable is not None else HashTable()
        hop = scfg.shift * scfg.fs
        # The ring must be able to hold a full batch of ready windows per
        # channel, or push() (which drains only complete batches) would
        # never fire and the ring would silently drop samples forever:
        # `ready` saturates at (cap - fl)/hop + 1, so cap needs
        # fl + (batch_windows - 1) * hop samples.
        need = -(-(scfg.fl + (batch_windows - 1) * hop) // scfg.fl)
        self.windower = NativeWindower(n_channels, scfg.fl, hop,
                                       max(scfg.capacity_windows, need))
        dcfg = self.config
        if resolve_backend().serving_defaults:
            # serving point for fields left at config defaults
            dcfg = with_serving_defaults(dcfg, batch_windows)
        self._device = DeviceDecoder(dcfg, fano_mode=fano_mode)
        self.stats = StreamStats()

    def _decode_batch(self, ri: np.ndarray, chans: np.ndarray):
        W = len(ri)
        if W < self.batch_windows:          # pad to the compiled width
            ri = np.concatenate(
                [ri, np.zeros((self.batch_windows - W,) + ri.shape[1:],
                              dtype=ri.dtype)])
        t0 = time.perf_counter()
        out = self._device.decode_ri_batch(ri)
        self.stats.decode_seconds += time.perf_counter() - t0
        results = []
        for w in range(W):
            one = out.window(w)
            r = DecodeResult(spots=self._device.spots(one, self.hashtable))
            r.n_candidates = int(one.valid.sum())
            r.n_fano_attempts = int(one.fano_attempts)
            self.stats.windows += 1
            self.stats.candidates += r.n_candidates
            self.stats.fano_attempts += r.n_fano_attempts
            self.stats.spots += len(r.spots)
            results.append((int(chans[w]), r))
        return results

    def _drain(self, full_only: bool):
        results = []
        while True:
            ready = self.windower.ready
            if ready == 0 or (full_only and ready < self.batch_windows):
                break
            ri, chans = self.windower.pop_batch(self.batch_windows)
            results.extend(self._decode_batch(ri, chans))
        return results

    def push(self, samples: np.ndarray):
        """samples: (n,) or (channels, n) or planar (channels, 2, n).
        Decodes every full ``batch_windows``-wide batch now available."""
        self.windower.push(np.atleast_2d(np.asarray(samples)))
        return self._drain(full_only=True)

    def flush(self):
        """Decode all remaining ready windows (zero-padded final batch)."""
        return self._drain(full_only=False)


@dataclass
class SpotAggregator:
    """Dedupe spots across overlapping windows: same message within
    tolerance_hz is the same transmission."""

    tolerance_hz: float = 1.5
    seen: dict = field(default_factory=dict)
    unique: list[Spot] = field(default_factory=list)

    def add(self, spot: Spot) -> bool:
        # bucket by freq, but check the neighbor buckets with a real
        # |delta f| comparison — two decodes 0.02 Hz apart must not pass
        # as distinct just because they straddle a bucket edge
        b = round(spot.freq / self.tolerance_hz)
        for nb in (b - 1, b, b + 1):
            prev = self.seen.get((spot.message, nb))
            if prev is not None and (abs(prev.freq - spot.freq)
                                     < self.tolerance_hz):
                return False
        self.seen[(spot.message, b)] = spot
        self.unique.append(spot)
        return True


__all__ = ["SlidingWindow", "StreamDecoder", "BatchedStreamDecoder",
           "StreamStats", "SpotAggregator"]
