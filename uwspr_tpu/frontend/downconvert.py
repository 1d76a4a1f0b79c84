"""Audio-rate front end: 12 kS/s real audio <-> 375 S/s complex baseband.

Receiver (reference chain, examples/AudioSourceDecode.grc: band-pass at
1500 +/- 10 Hz -> freq-translate -1500 Hz -> low-pass -> decimate x32):
re-designed as one fused stage — complex mix to baseband, then a single
polyphase anti-alias low-pass evaluated only at the decimated output points
(one strided convolution). The passband of
interest is only +/-halfbandwidth Hz and the first alias band after x32
decimation starts at 375 - halfbandwidth Hz, so a short windowed-sinc
(257 taps) achieves what the reference's ~4000-tap 10 Hz-transition chain
does, at 1/15th the FLOPs.

Sender (examples/c2ToWaveFile.grc: interpolate x32 with a 200 Hz low-pass
-> translate to +1500 Hz -> real audio): upconvert() mirrors it.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from uwspr_tpu.config import FrontendConfig


def design_lowpass(num_taps: int, cutoff_hz: float, fs: float) -> np.ndarray:
    """Hamming windowed-sinc low-pass FIR, unity DC gain."""
    n = np.arange(num_taps) - (num_taps - 1) / 2.0
    fc = cutoff_hz / fs
    h = 2 * fc * np.sinc(2 * fc * n)
    h *= np.hamming(num_taps)
    return (h / h.sum()).astype(np.float32)


@functools.partial(jax.jit, static_argnames=("decim",))
def _mix_and_decimate(audio: jnp.ndarray, lo: jnp.ndarray,
                      taps: jnp.ndarray, *, decim: int) -> jnp.ndarray:
    """audio (N,) f32, lo (2, N) f32 mixer cos/-sin (host-computed in
    float64: a float32 phase ramp loses ~0.1 rad by 1e6 samples and is
    garbage past 2^24). Returns (2, M) float32 real/imag planes."""
    re = audio * lo[0]
    im = audio * lo[1]
    ntaps = taps.shape[0]
    pad = ntaps // 2

    def conv_stride(x):
        x4 = x.reshape(1, 1, -1)
        k4 = taps[::-1].reshape(1, 1, -1)
        y = jax.lax.conv_general_dilated(
            x4, k4, window_strides=(decim,), padding=[(pad, pad)],
            dimension_numbers=("NCH", "IOH", "NCH"),
            precision=jax.lax.Precision.HIGHEST)
        return y[0, 0]

    return jnp.stack([conv_stride(re), conv_stride(im)])


class Downconverter:
    def __init__(self, cfg: FrontendConfig | None = None, num_taps: int = 257):
        self.cfg = cfg or FrontendConfig()
        # stopband must begin by fs_out - halfbandwidth to protect the
        # passband from decimation aliasing; center the cutoff well below
        fs_out = self.cfg.audio_rate / self.cfg.decimation
        cutoff = min(100.0, fs_out / 3)
        self.taps = design_lowpass(num_taps, cutoff, self.cfg.audio_rate)

    def __call__(self, audio: np.ndarray) -> np.ndarray:
        """(N,) float audio at audio_rate -> (N//decim,) complex64 baseband."""
        cfg = self.cfg
        n = (len(audio) // cfg.decimation) * cfg.decimation
        w = ((-2.0 * np.pi * cfg.center_freq / cfg.audio_rate)
             * np.arange(n, dtype=np.float64))
        lo = np.stack([np.cos(w), np.sin(w)]).astype(np.float32)
        out = np.asarray(_mix_and_decimate(
            jnp.asarray(audio[:n], jnp.float32), jnp.asarray(lo),
            jnp.asarray(self.taps), decim=cfg.decimation))
        return (out[0] + 1j * out[1]).astype(np.complex64)


def downconvert(audio: np.ndarray, cfg: FrontendConfig | None = None
                ) -> np.ndarray:
    return Downconverter(cfg)(audio)


class StreamingDownconverter:
    """Block-wise downconversion for live audio sources (stdin, sound
    card): carries the FIR tail and the mixer phase across pushes, so a
    continuous stream fed in arbitrary chunks equals the one-shot
    Downconverter output up to a fixed (num_taps//2)-audio-sample group
    delay. Host-side numpy — the per-block FLOPs (~3 M MAC/s of audio) are
    negligible next to the decode itself."""

    def __init__(self, cfg: FrontendConfig | None = None, num_taps: int = 257):
        self.cfg = cfg or FrontendConfig()
        fs_out = self.cfg.audio_rate / self.cfg.decimation
        cutoff = min(100.0, fs_out / 3)
        self.taps = design_lowpass(num_taps, cutoff, self.cfg.audio_rate
                                   ).astype(np.float64)
        self._tail = np.zeros(num_taps - 1, np.float32)
        self._pos = -(num_taps - 1)       # absolute index of _tail[0]
        self._rem = np.zeros(0, np.float32)

    def push(self, audio: np.ndarray) -> np.ndarray:
        """(n,) audio samples -> (m,) complex64 baseband (m = n//decim once
        buffered remainders even out)."""
        cfg = self.cfg
        audio = np.concatenate([self._rem,
                                np.asarray(audio, dtype=np.float32)])
        n = (len(audio) // cfg.decimation) * cfg.decimation
        self._rem = audio[n:]
        if n == 0:
            return np.zeros(0, np.complex64)
        x = np.concatenate([self._tail, audio[:n]])
        t = self._pos + np.arange(len(x), dtype=np.float64)
        lo = np.exp(-2j * np.pi * cfg.center_freq / cfg.audio_rate * t)
        y = np.convolve(x * lo, self.taps, mode="valid")[::cfg.decimation]
        self._pos += n
        self._tail = x[n:].copy()
        return y.astype(np.complex64)


def upconvert(baseband: np.ndarray, cfg: FrontendConfig | None = None,
              num_taps: int = 513, amplitude: float = 0.5) -> np.ndarray:
    """375 S/s complex baseband -> real audio at audio_rate centered at cf.

    Mirrors examples/c2ToWaveFile.grc: x32 zero-stuff interpolation with a
    200 Hz low-pass, translate to +cf, take the real part.
    """
    cfg = cfg or FrontendConfig()
    decim = cfg.decimation
    z = np.asarray(baseband, dtype=np.complex64)
    up = np.zeros(len(z) * decim, dtype=np.complex64)
    up[::decim] = z
    taps = design_lowpass(num_taps, 200.0, cfg.audio_rate) * decim
    up = np.convolve(up, taps, mode="same")
    t = np.arange(len(up), dtype=np.float64)
    lo = np.exp(2j * np.pi * cfg.center_freq * t / cfg.audio_rate)
    audio = (up * lo).real
    peak = np.abs(audio).max() or 1.0
    return (amplitude * audio / peak).astype(np.float32)


__all__ = ["Downconverter", "StreamingDownconverter", "downconvert",
           "upconvert", "design_lowpass"]
