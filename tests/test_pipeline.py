"""End-to-end decode tests (the reference's golden known-answer paths)."""

import numpy as np
import pytest

from uwspr_tpu.config import PipelineConfig
from uwspr_tpu.io.c2file import C2_SAMPLES, apply_sim_drift, read_c2, write_c2
from uwspr_tpu.io.channel import awgn
from uwspr_tpu.pipeline.decoder import WindowDecoder, decode_c2_file
from uwspr_tpu.protocol.modulate import synthesize_frame


@pytest.fixture(scope="module")
def decoder():
    return WindowDecoder(PipelineConfig())


def test_golden_ve3emb_decode(decoder, reference_examples):
    """The reference's headline known answer (README.md:37,43)."""
    c2 = read_c2(reference_examples / "VE3EMB.c2")
    result = decoder(c2.samples)
    assert [s.message for s in result.spots] == ["VE3EMB FN25 30"]
    s = result.spots[0]
    # the spot carries the REFINED frequency (reference logs freq1 after
    # fine sync); the signal sits in the -0.732 Hz coarse bin
    assert s.freq == pytest.approx(-0.732, abs=0.25)
    assert s.snr > 20


def test_synthesized_frame_decode(decoder):
    z = synthesize_frame("K1ABC", "EM79", 37, start_sample=1200,
                         freq_offset=2.5)
    result = decoder(awgn(z, -18.0, rng=np.random.default_rng(5)))
    assert "K1ABC EM79 37" in [s.message for s in result.spots]


def test_two_frames_one_window(decoder):
    z = (synthesize_frame("K1ABC", "EM79", 37, start_sample=900,
                          freq_offset=3.0)
         + synthesize_frame("VE3EMB", "FN25", 30, start_sample=2000,
                            freq_offset=-5.5))
    result = decoder(awgn(z, -14.0, rng=np.random.default_rng(6)))
    msgs = {s.message for s in result.spots}
    assert {"K1ABC EM79 37", "VE3EMB FN25 30"} <= msgs


def test_c2_roundtrip_decode(decoder, tmp_path):
    z = synthesize_frame("K1ABC", "EM79", 37, start_sample=750,
                         freq_offset=1.0)
    p = tmp_path / "t.c2"
    write_c2(p, z, name="test")
    c2 = read_c2(p)
    assert c2.samples.shape == (C2_SAMPLES,)
    np.testing.assert_allclose(c2.samples, z, atol=1e-6)
    result = decode_c2_file(p)
    assert "K1ABC EM79 37" in [s.message for s in result.spots]


def test_noise_only_no_spots(decoder):
    rng = np.random.default_rng(9)
    z = (0.1 * (rng.normal(size=45000) + 1j * rng.normal(size=45000))
         ).astype(np.complex64)
    result = decoder(z)
    assert result.spots == []


def test_sim_drift_injection_decodes(reference_examples):
    """c2file_source's synthetic drift ramp must still decode at low rates
    (exercises the demod's tolerance like the reference's drift_rate knob)."""
    c2 = read_c2(reference_examples / "VE3EMB.c2")
    drifted = apply_sim_drift(c2.samples, drift_rate=0.005)
    result = WindowDecoder(PipelineConfig())(drifted)
    assert "VE3EMB FN25 30" in [s.message for s in result.spots]


def test_with_serving_defaults():
    """Serving defaults: bf16 + 2x-batch compaction for narrowband
    default configs; explicit settings and wideband configs preserved."""
    from uwspr_tpu.config import (CoarseConfig, DemodConfig, PipelineConfig,
                                  with_serving_defaults)

    base = PipelineConfig()
    s = with_serving_defaults(base, 32)
    assert s.demod.probe_dtype == "bf16"
    assert s.demod.refine_max_lanes == 64
    assert s.demod.fano_compact_lanes == 64
    assert s.demod.cand_compact_lanes == 64   # 2x batch
    # per-window serving: no cross-window compaction
    s1 = with_serving_defaults(base, 1)
    assert s1.demod.probe_dtype == "bf16"
    assert s1.demod.refine_max_lanes == 0
    assert s1.demod.fano_compact_lanes == 0
    assert s1.demod.cand_compact_lanes == 0
    # explicit settings win
    exp = PipelineConfig(demod=DemodConfig(probe_dtype="bf16",
                                           refine_max_lanes=512))
    s2 = with_serving_defaults(exp, 32)
    assert s2.demod.refine_max_lanes == 512
    assert s2.demod.fano_compact_lanes == 64
    assert s2.demod.cand_compact_lanes == 64
    # wideband static lane count: compaction sized 16x batch, bounded
    # at 512 lanes
    wb = PipelineConfig(coarse=CoarseConfig(halfbandwidth=187, maxfreqs=200))
    s3 = with_serving_defaults(wb, 32)
    assert s3.demod.probe_dtype == "bf16"
    assert s3.demod.refine_max_lanes == 512
    assert s3.demod.fano_compact_lanes == 512
    assert s3.demod.cand_compact_lanes == 512
    s3b = with_serving_defaults(wb, 8)
    assert s3b.demod.cand_compact_lanes == 128
    # untouched config object comes back as-is when nothing applies
    full = PipelineConfig(
        coarse=CoarseConfig(stft_impl="matmul_bf16"),
        demod=DemodConfig(
            probe_dtype="bf16", refine_max_lanes=8, fano_compact_lanes=8,
            cand_compact_lanes=8))
    assert with_serving_defaults(full, 32) is full
    # r5: the serving STFT upgrades only the "auto" sentinel default to
    # the measured matmul_bf16 formulation; an EXPLICIT "fft" means the
    # user asked for the f32-exact FFT and is never upgraded
    assert s.coarse.stft_impl == "matmul_bf16"
    exp_fft = PipelineConfig(coarse=CoarseConfig(stft_impl="fft"))
    assert with_serving_defaults(exp_fft, 32).coarse.stft_impl == "fft"
