"""uwspr command-line interface.

    python -m uwspr_tpu.cli decode examples/VE3EMB.c2
    python -m uwspr_tpu.cli decode capture.wav --wav
    python -m uwspr_tpu.cli encode "VE3EMB" "FN25" 30 -o frame.c2
    python -m uwspr_tpu.cli sweep --snr -15 -30 -1 --trials 20
    python -m uwspr_tpu.cli serve --channels 4 --windows 10

Replaces the reference's GRC flowgraphs as the user-facing application
surface (SURVEY.md section 1, GUI/flowgraph layer).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def _apply_platform(args):
    """Select the JAX backend (--platform cpu|gpu; auto = JAX's default,
    JAX_PLATFORMS honoured) before first use, then enable the persistent
    compile cache."""
    if getattr(args, "platform", "auto") != "auto":
        import jax
        jax.config.update("jax_platforms", args.platform)
    from uwspr_tpu.utils.cache import enable_compile_cache
    enable_compile_cache()


def _make_engine(args, ht):
    """'device': one jitted XLA program per window (the GPU serving path —
    no host round trips between stages).
    'hybrid': device pipeline through the sync/rms gates, Fano on the
    host (native C++) — same results, per-lane early exit.
    'host': staged host orchestration (flexible, fast on CPU).
    'auto': the platform's choice (config.resolve_backend)."""
    from uwspr_tpu.config import (PipelineConfig, resolve_backend,
                                  with_serving_defaults)
    backend = resolve_backend()
    engine = args.engine
    if engine == "auto":
        engine = backend.engine
    config = _args_config(args)
    if engine in ("device", "hybrid"):
        from uwspr_tpu.pipeline.jit_decoder import DeviceDecoder
        if backend.serving_defaults:
            # serving point for fields left at config defaults; explicit
            # flags win. _args_config returns None for library defaults.
            config = with_serving_defaults(config or PipelineConfig(), 1)
        dec = DeviceDecoder(
            config, fano_mode="host" if engine == "hybrid" else "device")
        return dec, lambda window: dec.spots(dec(window), ht), engine
    from uwspr_tpu.pipeline.decoder import WindowDecoder
    dec = WindowDecoder(config, hashtable=ht)
    return dec, lambda window: dec(window).spots, "host"


def _args_config(args):
    """PipelineConfig from CLI tuning flags (None = library defaults)."""
    overrides = {}
    if getattr(args, "osd_depth", 0):
        overrides["osd_depth"] = args.osd_depth
    if getattr(args, "maxcycles", None):
        overrides["maxcycles"] = args.maxcycles
    if getattr(args, "jiggles", None):
        overrides["n_jiggles"] = args.jiggles
    if not overrides:
        return None
    from uwspr_tpu.config import DemodConfig, PipelineConfig
    return PipelineConfig(demod=DemodConfig(**overrides))



def _read_wav_checked(path, expected_rate: int = 12000):
    """read_wav + sample-rate validation: the downconversion chain is
    designed for 12 kS/s audio; silently decoding a 48 kHz file would
    produce zero spots with no hint why."""
    from uwspr_tpu.io.wavfile import read_wav
    audio, rate = read_wav(path)
    if rate != expected_rate:
        raise SystemExit(f"{path}: {rate} S/s audio; the frontend expects "
                         f"{expected_rate} S/s")
    return audio


def _cmd_decode(args):
    from uwspr_tpu.protocol.messages import HashTable
    from uwspr_tpu.utils.spotlog import SpotLogger

    ht = HashTable.load(args.hashtable) if args.hashtable else HashTable()
    decoder, decode_spots, engine = _make_engine(args, ht)
    if getattr(args, "passes", 1) > 1:
        from uwspr_tpu.pipeline.multipass import multipass_spots
        single_pass = decode_spots
        decode_spots = lambda w: multipass_spots(  # noqa: E731
            w, single_pass, decoder.config, passes=args.passes)
    logger = (SpotLogger(args.messagelog, args.jsonl, args.spots,
                         args.allwspr)
              if (args.messagelog or args.jsonl or args.spots
                  or args.allwspr) else None)

    if args.wav or str(args.file).lower().endswith(".wav"):
        from uwspr_tpu.frontend.downconvert import downconvert
        audio = _read_wav_checked(args.file)
        z = downconvert(audio)
    else:
        from uwspr_tpu.io.c2file import read_c2
        z = read_c2(args.file).samples
    if args.sim_drift:
        # synthetic linear drift injection to exercise the drift search
        # (reference: c2file_source drift_rate, c2file_source_impl.cc:117-133)
        from uwspr_tpu.io.c2file import apply_sim_drift
        z = apply_sim_drift(z, args.sim_drift)

    fl = decoder.config.stream.fl
    hop = decoder.config.stream.shift * decoder.config.stream.fs
    n_windows = max(1, (len(z) - fl) // hop + 1)
    t0 = time.time()
    total = 0
    from uwspr_tpu.pipeline.stream import SpotAggregator
    from uwspr_tpu.utils.profiler import trace
    agg = SpotAggregator()
    with trace(args.trace_dir):
        for w in range(n_windows):
            window = z[w * hop: w * hop + fl]
            if len(window) < fl:
                break
            for s in decode_spots(window):
                if not args.all_spots and not agg.add(s):
                    continue   # same message already seen in an
                               # overlapping window / adjacent candidate
                total += 1
                tag = f", osd{s.osd}" if s.osd else ""
                print(f"{s.message}    (freq {s.freq:+.2f} Hz, SNR "
                      f"{s.snr:.1f} dB, sync {s.sync:.2f}, "
                      f"{'nonlinear' if s.mode else 'linear'}{tag})")
                if logger:
                    logger.log(s)
    dt = time.time() - t0
    print(f"# {total} spot(s) from {n_windows} window(s) in {dt:.2f}s "
          f"({engine} engine)", file=sys.stderr)
    if args.hashtable:
        ht.save(args.hashtable)


def _cmd_encode(args):
    from uwspr_tpu.io.c2file import write_c2
    from uwspr_tpu.protocol.modulate import synthesize_frame

    z = synthesize_frame(args.callsign, args.grid, args.power,
                         start_sample=args.start,
                         freq_offset=args.freq_offset)
    write_c2(args.output, z, name=args.callsign[:13])
    print(f"wrote {args.output}: '{args.callsign} {args.grid} {args.power}'"
          f" at {args.freq_offset:+.2f} Hz, start sample {args.start}")


def _cmd_c2towav(args):
    """c2 baseband -> 12 kS/s wav at 1500 Hz (examples/c2ToWaveFile.grc)."""
    from uwspr_tpu.frontend.downconvert import upconvert
    from uwspr_tpu.io.c2file import apply_sim_drift, read_c2
    from uwspr_tpu.io.wavfile import write_wav

    z = read_c2(args.file).samples
    if args.drift_rate:
        z = apply_sim_drift(z, args.drift_rate)
    audio = upconvert(z, amplitude=args.amplitude)
    write_wav(args.output, audio, 12000)
    print(f"wrote {args.output}: {len(audio)} samples @ 12 kS/s")


def _cmd_wavtoc2(args):
    """12 kS/s wav -> c2 baseband capture (inverse of c2towav)."""
    from uwspr_tpu.frontend.downconvert import downconvert
    from uwspr_tpu.io.c2file import write_c2

    audio = _read_wav_checked(args.file)
    z = downconvert(audio)
    write_c2(args.output, z[:45000])
    print(f"wrote {args.output}")


def _cmd_sweep(args):
    from uwspr_tpu.pipeline.sweep import snr_sweep

    snrs = np.arange(args.snr[0], args.snr[1] + args.snr[2] / 2, args.snr[2])
    interference = None
    if args.whales:
        from uwspr_tpu.frontend.downconvert import downconvert
        interference = downconvert(_read_wav_checked(args.whales))

    def progress(snr, t, ok):
        print(f"\rSNR {snr:+6.1f} dB: trial {t + 1}, {ok} ok", end="",
              file=sys.stderr)

    import jax

    from uwspr_tpu.config import resolve_backend
    engine = args.engine
    if engine == "auto":
        engine = resolve_backend().engine
    r = snr_sweep(snrs, trials=args.trials, interference=interference,
                  progress=progress, seed=args.seed, engine=engine,
                  config=_args_config(args))
    print("", file=sys.stderr)
    doc = {"trials": r.trials, "seed": args.seed, "engine": engine,
           "backend": jax.default_backend(),
           "callsign": "VE3EMB", "grid": "FN25", "power": 30,
           "snr_convention": "2500 Hz reference bandwidth",
           "randomized": "freq offset +/-5 Hz, start 0..2 s per trial",
           "decode_rate": r.as_dict()}
    line = json.dumps(doc)
    print(line)
    if args.output:
        with open(args.output, "w") as f:
            f.write(json.dumps(doc, indent=1) + "\n")
        print(f"wrote {args.output}", file=sys.stderr)


def _synthetic_source(args, hop, info):
    """Self-generated traffic: frames stream contiguously across hop
    boundaries (a 111 s frame spans ~13 hops), riding on hop-by-hop AWGN
    at the requested SNR — the streaming analogue of the reference's
    closed-loop flowgraph (examples/WaveFilePlusNoiseDecode.grc)."""
    from uwspr_tpu.io.channel import noise_sigma
    from uwspr_tpu.protocol.modulate import synthesize_frame

    rng = np.random.default_rng(0)
    sigma = noise_sigma(args.snr)
    pending = [np.zeros(0, np.complex64) for _ in range(args.channels)]
    for _ in range(args.windows):
        block = (rng.normal(scale=sigma, size=(args.channels, hop))
                 + 1j * rng.normal(scale=sigma, size=(args.channels, hop))
                 ).astype(np.complex64)
        for ch in range(args.channels):
            if len(pending[ch]) == 0 and rng.random() < args.duty:
                pending[ch] = synthesize_frame(
                    "VE3EMB", "FN25", 30, pad_to=None,
                    freq_offset=rng.uniform(-5, 5)).copy()
                info["sent"] += 1
            n = min(hop, len(pending[ch]))
            if n:
                block[ch, :n] += pending[ch][:n]
                pending[ch] = pending[ch][n:]
        yield block


def _stdin_source(args, hop):
    """Live external samples on stdin — the path that makes ``serve`` a
    real receiver (reference flagship examples/AudioSourceDecode.grc):
    cf32 = interleaved float32 I/Q at 375 S/s baseband; s16 = 12 kS/s
    signed 16-bit mono audio, downconverted block-by-block with carried
    filter/mixer state."""
    if args.format == "cf32":
        buf = b""
        while True:
            data = sys.stdin.buffer.read(8 * hop)
            if not data:
                return
            buf += data
            n = (len(buf) // 8) * 8
            if n == 0:
                continue
            iq = np.frombuffer(buf[:n], "<f4")
            buf = buf[n:]
            yield (iq[0::2] + 1j * iq[1::2]).astype(np.complex64)[None, :]
    else:                                   # s16 audio at 12 kS/s
        from uwspr_tpu.frontend.downconvert import StreamingDownconverter
        dc = StreamingDownconverter()
        while True:
            data = sys.stdin.buffer.read(2 * 32 * hop)
            if not data:
                return
            audio = np.frombuffer(data, "<i2").astype(np.float32) / 32768.0
            z = dc.push(audio)
            if len(z):
                yield z[None, :]


def _audio_capture_source(args, hop):
    """Live soundcard capture — the reference's ``audio_source``
    (examples/AudioSourceDecode.grc). ``--input audio`` or
    ``--input audio:<device>`` opens io.audio.AudioCapture (sounddevice /
    pyaudio / ctypes-ALSA / arecord, first available) at 12 kS/s s16
    mono and downconverts block-by-block like the stdin path. Raises a
    clear error naming every probed backend when no soundcard stack
    exists (use '-' with an external recorder piping s16 then)."""
    from uwspr_tpu.frontend.downconvert import StreamingDownconverter
    from uwspr_tpu.io.audio import AudioCapture, AudioUnavailable

    device = (args.input.split(":", 1)[1]
              if ":" in args.input else None)
    try:
        cap = AudioCapture(rate=12000, device=device,
                           blocksize=2 * 32 * hop // 2)
    except AudioUnavailable as e:
        raise SystemExit(
            f"{e}\nhint: pipe an external recorder instead, e.g. "
            "`arecord -f S16_LE -r 12000 -c 1 -t raw | uwspr serve "
            "--input - --format s16`") from None
    print(f"# audio capture via {cap.backend_name}"
          + (f" (device {device})" if device else ""), flush=True)
    dc = StreamingDownconverter()
    for block in cap:
        if not len(block):
            continue
        audio = block.astype(np.float32) / 32768.0
        z = dc.push(audio)
        if len(z):
            yield z[None, :]


def _file_source(args, hop):
    """Follow a capture file (.c2 or .wav), optionally looping (the
    reference c2file_source's ``repeat``); --windows bounds the repeated
    stream."""
    limit = args.windows * hop if args.repeat else None
    if str(args.input).lower().endswith(".wav"):
        from uwspr_tpu.frontend.downconvert import downconvert
        from uwspr_tpu.io.c2file import array_stream
        audio = _read_wav_checked(args.input)
        src = array_stream(downconvert(audio), repeat=args.repeat, block=hop)
    else:
        from uwspr_tpu.io.c2file import c2_stream
        src = c2_stream(args.input, repeat=args.repeat,
                        drift_rate=args.sim_drift, block=hop)
    sent = 0
    for chunk in src:
        if limit is not None and sent >= limit:
            return
        sent += len(chunk)
        yield chunk[None, :]


def _parse_mesh(spec: str):
    """'CxT' -> (n_channel, n_time) with a helpful error."""
    try:
        c, t = spec.lower().split("x")
        c, t = int(c), int(t)
        assert c >= 1 and t >= 1
        return c, t
    except (ValueError, AssertionError):
        raise SystemExit(f"--mesh expects CxT (e.g. 2x4), got {spec!r}")


def _cmd_serve_mesh(args, channels, external, ht, logger, source, info):
    """serve --mesh CxT: the multi-chip receiver application — the stream
    is sharded over a (channel, time) jax mesh and decoded by
    ShardedStreamDecoder (SURVEY.md §7.1.8/9: serve at 1 chip / 1 host /
    N hosts; reference flagship examples/AudioSourceDecode.grc)."""
    import jax

    from uwspr_tpu.config import resolve_backend
    from uwspr_tpu.parallel.mesh import ShardedStreamDecoder, make_mesh

    if args.runtime == "native":
        raise SystemExit("--mesh uses the sharded XLA runtime; drop "
                         "--runtime native")
    if getattr(args, "passes", 1) > 1:
        raise SystemExit("--passes is a single-device (python runtime) "
                         "feature; drop it for --mesh")
    engine = args.engine
    if engine == "auto":
        # the platform's device engine on the GPU. On the CPU the
        # while-loop Fano inside the sharded program makes shards reach
        # the closing psum minutes apart, tripping XLA:CPU's 40 s
        # collective-rendezvous abort — hybrid (host Fano) is the safe
        # default there; --engine device still honored for small budgets.
        engine = resolve_backend().engine
        if engine != "device":
            engine = "hybrid"
    elif engine not in ("device", "hybrid"):
        raise SystemExit("--mesh serves through the sharded XLA engines; "
                         "use --engine device or hybrid")
    n_ch, n_time = _parse_mesh(args.mesh)
    if len(jax.devices()) < n_ch * n_time:
        raise SystemExit(f"--mesh {args.mesh} needs {n_ch * n_time} "
                         f"devices, have {len(jax.devices())}")
    if channels % n_ch:
        raise SystemExit(f"--channels {channels} must be a multiple of the "
                         f"mesh channel axis {n_ch}")
    mesh = make_mesh(n_ch, n_time)
    sd = ShardedStreamDecoder(config=_args_config(args), mesh=mesh,
                              n_channels=channels,
                              wins_per_shard=args.wins_per_shard,
                              hashtable=ht, engine=engine)
    t0 = time.time()
    for block in source:
        for ch, w, s in sd.push(np.broadcast_to(
                block, (channels, block.shape[-1]))
                if block.shape[0] != channels else block):
            print(f"ch{ch} w{w}: {s.message} ({s.freq:+.2f} Hz)", flush=True)
            if logger:
                logger.log(s)
    for ch, w, s in sd.flush():
        print(f"ch{ch} w{w}: {s.message} ({s.freq:+.2f} Hz)", flush=True)
        if logger:
            logger.log(s)
    dt = time.time() - t0
    st = sd.stats
    sent = f"{info['sent']} frames sent, " if not external else ""
    print(f"# mesh {n_ch}x{n_time} ({engine}): {st.steps} steps, "
          f"{st.windows} windows, {sent}{st.spots} spots, "
          f"{st.windows * 45000 / max(dt, 1e-9):.0f} window-samples/s",
          file=sys.stderr)
    if logger:
        logger.close()
    if args.hashtable:
        ht.save(args.hashtable)


def _cmd_serve(args):
    """Continuous receiver: decode a live or synthetic multichannel stream.

    --input synthetic (default) generates closed-loop traffic; '-' reads
    raw samples from stdin; a .c2/.wav path follows the file (--repeat to
    loop). External inputs are single-channel (replicated across --channels
    under --mesh)."""
    from uwspr_tpu.pipeline.stream import StreamDecoder
    from uwspr_tpu.protocol.messages import HashTable
    from uwspr_tpu.utils.spotlog import SpotLogger

    external = args.input != "synthetic"
    channels = 1 if external else args.channels
    ht = HashTable.load(args.hashtable) if args.hashtable else HashTable()
    if args.mesh:
        logger = (SpotLogger(args.messagelog, args.jsonl, args.spots,
                             args.allwspr)
                  if (args.messagelog or args.jsonl or args.spots
                      or args.allwspr) else None)
        if external:
            channels = max(1, args.channels)
        # hop for source blocking (config defaults; mesh decoder re-derives)
        hop = 9 * 375
        info = {"sent": 0}
        source = (_synthetic_source(args, hop, info) if not external
                  else _stdin_source(args, hop) if args.input == "-"
                  else _audio_capture_source(args, hop)
                  if args.input.startswith("audio")
                  else _file_source(args, hop))
        return _cmd_serve_mesh(args, channels, external, ht, logger,
                               source, info)
    if args.runtime == "native":
        if getattr(args, "passes", 1) > 1:
            raise SystemExit("--passes requires --runtime python "
                             "(interference cancellation re-decodes each "
                             "window between passes)")
        if args.engine == "host":
            raise SystemExit("--runtime native serves through the batched "
                             "XLA engines; use --engine device/hybrid, or "
                             "--runtime python for host orchestration")
        from uwspr_tpu.pipeline.stream import BatchedStreamDecoder
        sd = BatchedStreamDecoder(
            n_channels=channels, hashtable=ht, batch_windows=args.batch,
            fano_mode="host" if args.engine == "hybrid" else "device")
        hop = sd.config.stream.shift * sd.config.stream.fs
    elif args.runtime == "ring":
        if getattr(args, "passes", 1) > 1:
            raise SystemExit("--passes requires --runtime python")
        if args.engine == "host":
            raise SystemExit("--runtime ring serves through the batched "
                             "XLA engines; use --engine device/hybrid")
        from uwspr_tpu.pipeline.device_ring import RingServe
        sd = RingServe(
            n_channels=channels, hashtable=ht,
            fano_mode="host" if args.engine == "hybrid" else "device")
        hop = sd.ring.hop
    else:
        sd = StreamDecoder(n_channels=channels, hashtable=ht,
                           engine=args.engine,
                           passes=getattr(args, "passes", 1))
        hop = sd.windows[0].hop
    logger = (SpotLogger(args.messagelog, args.jsonl, args.spots,
                         args.allwspr)
              if (args.messagelog or args.jsonl or args.spots
                  or args.allwspr) else None)
    info = {"sent": 0}
    source = (_synthetic_source(args, hop, info) if not external
              else _stdin_source(args, hop) if args.input == "-"
              else _audio_capture_source(args, hop)
              if args.input.startswith("audio")
              else _file_source(args, hop))

    def emit(results):
        for ch, r in results:
            for s in r.spots:
                print(f"ch{ch}: {s.message} ({s.freq:+.2f} Hz)", flush=True)
                if logger:
                    logger.log(s)

    t0 = time.time()
    for block in source:
        emit(sd.push(block))
    if args.runtime == "native":
        emit(sd.flush())
    dt = time.time() - t0
    st = sd.stats
    sent = f"{info['sent']} frames sent, " if not external else ""
    print(f"# {st.windows} windows, {sent}{st.spots} spots, "
          f"{st.windows * 45000 / max(dt, 1e-9):.0f} window-samples/s",
          file=sys.stderr)
    if logger:
        logger.close()
    if args.hashtable:
        ht.save(args.hashtable)


def _grc_receiver_source(src, cfg, hop, windows_limit):
    """SourceSpec -> generator of (1, hop) baseband blocks."""
    if src.kind == "c2":
        from uwspr_tpu.io.c2file import c2_stream
        limit = windows_limit * hop if src.repeat else None
        sent = 0
        for chunk in c2_stream(src.files[0], repeat=src.repeat,
                               drift_rate=src.drift_rate, block=hop):
            if limit is not None and sent >= limit:
                return
            sent += len(chunk)
            yield chunk[None, :]
        return
    if src.kind in ("wav", "wav_mix"):
        from uwspr_tpu.frontend.downconvert import downconvert
        from uwspr_tpu.io.wavfile import read_wav
        tracks = []
        for path, gain in zip(src.files, src.gains):
            audio, rate = read_wav(path)
            if rate != cfg.frontend.audio_rate:
                raise SystemExit(f"{path}: {rate} S/s, flowgraph expects "
                                 f"{cfg.frontend.audio_rate}")
            tracks.append(audio * np.float32(gain))
        # the longest file sets the stream length; shorter files loop over
        # it (GRC repeat=True semantics), independent of XML block order
        target = max(len(a) for a in tracks)
        mixed = np.zeros(target, np.float32)
        for a in tracks:
            reps = int(np.ceil(target / len(a)))
            mixed += np.tile(a, reps)[:target]
        from uwspr_tpu.io.c2file import array_stream
        z = np.asarray(downconvert(mixed, cfg.frontend))
        limit = windows_limit * hop if src.repeat else len(z)
        sent = 0
        for chunk in array_stream(z, repeat=src.repeat, block=hop):
            if sent >= limit:
                return
            yield chunk[None, :]
            sent += len(chunk)
        return
    # live audio (AudioSourceDecode.grc): a real soundcard via
    # io.audio.AudioCapture when a capture stack exists, else s16 on
    # stdin (the portable transport an external recorder can feed)
    from uwspr_tpu.frontend.downconvert import StreamingDownconverter
    dc = StreamingDownconverter(cfg.frontend)
    decim = cfg.frontend.decimation
    try:
        from uwspr_tpu.io.audio import AudioCapture
        cap = AudioCapture(rate=cfg.frontend.audio_rate,
                           blocksize=decim * hop)
        print(f"# audio capture via {cap.backend_name}", file=sys.stderr)
        for block in cap:
            if not len(block):
                continue
            z = dc.push(block.astype(np.float32) / 32768.0)
            if len(z):
                yield z[None, :]
        return
    except Exception:
        print("# no soundcard backend; reading s16 audio from stdin",
              file=sys.stderr)
    while True:
        data = sys.stdin.buffer.read(2 * decim * hop)
        if not data:
            return
        audio = np.frombuffer(data, "<i2").astype(np.float32) / 32768.0
        z = dc.push(audio)
        if len(z):
            yield z[None, :]


def _cmd_grc(args):
    """Run a reference GRC flowgraph through the decode pipeline."""
    import os
    from uwspr_tpu.grc import classify, describe, parse_grc, pipeline_config

    fg = parse_grc(args.file)
    files_dir = args.files_dir or os.path.dirname(os.path.abspath(args.file))
    print(describe(fg, files_dir), file=sys.stderr)
    if args.show:
        return
    kind, src, sink = classify(fg, files_dir)
    cfg = pipeline_config(fg)

    if kind == "sender":
        from uwspr_tpu.frontend.downconvert import upconvert
        from uwspr_tpu.io.c2file import read_c2
        from uwspr_tpu.io.wavfile import write_wav
        z = read_c2(src.files[0]).samples
        audio = upconvert(z, cfg.frontend)
        out = args.output
        if out is None and sink and sink.kind == "wav" and sink.file:
            out = os.path.basename(str(sink.file))  # author's path -> cwd
        if out is None:
            raise SystemExit("flowgraph sinks to the soundcard; "
                             "use -o out.wav")
        write_wav(out, np.asarray(audio), sink.rate if sink else 12000)
        print(f"wrote {out}: {len(audio)} samples @ "
              f"{sink.rate if sink else 12000} S/s")
        return

    from uwspr_tpu.pipeline.stream import StreamDecoder
    from uwspr_tpu.protocol.messages import HashTable
    ht = HashTable.load(args.hashtable) if args.hashtable else HashTable()
    sd = StreamDecoder(config=cfg, n_channels=1, hashtable=ht,
                       engine=args.engine)
    hop = cfg.stream.shift * cfg.stream.fs
    t0 = time.time()
    for block in _grc_receiver_source(src, cfg, hop, args.windows):
        for ch, r in sd.push(block):
            for s in r.spots:
                print(f"{s.message}    (freq {s.freq:+.2f} Hz, SNR "
                      f"{s.snr:.1f} dB)", flush=True)
    st = sd.stats
    print(f"# {st.windows} windows, {st.spots} spots in "
          f"{time.time() - t0:.2f}s", file=sys.stderr)
    if args.hashtable:
        ht.save(args.hashtable)


def _cmd_warmup(args):
    """Populate the persistent XLA compile cache for the serving
    programs, so cold `serve`/`bench` starts skip the first compile
    (the analogue of pre-generating FFTW wisdom,
    lib/FDR_impl.cc:142-150). One warmup per (batch width,
    engine, band) tuple; re-runs are no-ops (cache hits)."""
    import jax
    import jax.numpy as jnp

    from uwspr_tpu.config import (CoarseConfig, PipelineConfig,
                                  with_serving_defaults)
    from uwspr_tpu.pipeline.jit_decoder import DeviceDecoder

    widths = [int(w) for w in args.batch.split(",")]
    print(f"backend: {jax.default_backend()}; persistent cache active")
    for w in widths:
        coarse = (CoarseConfig(halfbandwidth=187, maxfreqs=200)
                  if args.wideband else CoarseConfig())
        cfg = with_serving_defaults(PipelineConfig(coarse=coarse), w)
        for engine in args.engines.split(","):
            dec = DeviceDecoder(
                cfg, fano_mode="host" if engine == "hybrid" else "device")
            ri = jnp.zeros((w, 2, cfg.stream.fl), jnp.float32)
            t0 = time.time()
            dec.decode_windows_ri(ri).block_until_ready()
            print(f"  W={w} engine={engine} "
                  f"{'wideband' if args.wideband else 'narrowband'}: "
                  f"compiled+ran in {time.time() - t0:.1f}s")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="uwspr",
                                description="WSPR weak-signal decoder")
    p.add_argument("--platform", choices=["auto", "cpu", "gpu"],
                   default="auto", help="JAX backend (default: environment)")
    sub = p.add_subparsers(dest="cmd", required=True)

    d = sub.add_parser("decode", help="decode a .c2 or .wav capture")
    d.add_argument("file")
    d.add_argument("--wav", action="store_true")
    d.add_argument("--engine", choices=["auto", "host", "device", "hybrid"],
                   default="auto",
                   help="device = one XLA program per window (GPU "
                        "default); host = staged orchestration (CPU "
                        "default); hybrid = device program, host Fano")
    d.add_argument("--hashtable", default=None)
    d.add_argument("--messagelog", default=None)
    d.add_argument("--jsonl", default=None)
    d.add_argument("--spots", default=None,
                   help="append wsprd-style wspr_spots.txt lines here")
    d.add_argument("--allwspr", default=None,
                   help="append wsprd-style ALL_WSPR.TXT lines here")
    d.add_argument("--sim-drift", type=float, default=0.0,
                   help="inject synthetic linear drift (Hz/minute) before "
                        "decoding, like the reference c2file_source")
    d.add_argument("--trace-dir", default=None,
                   help="write an XLA profiler trace (TensorBoard format)")
    d.add_argument("--osd-depth", type=int, default=0,
                   help="ordered-statistics decoding fallback when Fano "
                        "fails (deep-SNR; spots tagged 'osd' — below "
                        "-30 dB cross-check calls externally)")
    d.add_argument("--passes", type=int, default=1,
                   help="successive-interference-cancellation passes: "
                        "decoded frames are re-synthesized at their refined "
                        "(freq, shift, drift), fitted, subtracted, and the "
                        "window re-decoded (unmasks weak co-channel frames; "
                        "the reference has no equivalent)")
    d.add_argument("--all-spots", action="store_true",
                   help="print every (window, candidate) decode instead of "
                        "deduplicating by message+frequency")
    d.set_defaults(fn=_cmd_decode)

    cw = sub.add_parser("c2towav", help="c2 -> 12 kS/s wav at 1500 Hz")
    cw.add_argument("file")
    cw.add_argument("-o", "--output", default="out.wav")
    cw.add_argument("--amplitude", type=float, default=0.5)
    cw.add_argument("--drift-rate", type=float, default=0.0)
    cw.set_defaults(fn=_cmd_c2towav)

    wc = sub.add_parser("wavtoc2", help="12 kS/s wav -> c2 baseband")
    wc.add_argument("file")
    wc.add_argument("-o", "--output", default="out.c2")
    wc.set_defaults(fn=_cmd_wavtoc2)

    e = sub.add_parser("encode", help="synthesize a frame to .c2 (wsprsim)")
    e.add_argument("callsign")
    e.add_argument("grid")
    e.add_argument("power", type=int)
    e.add_argument("-o", "--output", default="frame.c2")
    e.add_argument("--freq-offset", type=float, default=0.0)
    e.add_argument("--start", type=int, default=750)
    e.set_defaults(fn=_cmd_encode)

    s = sub.add_parser("sweep", help="closed-loop SNR sweep")
    s.add_argument("--snr", nargs=3, type=float, default=[-15, -30, -1],
                   metavar=("START", "STOP", "STEP"))
    s.add_argument("--trials", type=int, default=20)
    s.add_argument("--whales", default=None,
                   help="wav file mixed in as interference")
    s.add_argument("--engine", choices=["auto", "host", "device", "hybrid"],
                   default="auto",
                   help="host = per-trial WindowDecoder; device = each "
                        "SNR point's trials batched in one device program")
    s.add_argument("--osd-depth", type=int, default=0,
                   help="OSD fallback order (0 = off)")
    s.add_argument("--seed", type=int, default=0)
    s.add_argument("-o", "--output", default=None,
                   help="also write the result JSON to this file")
    s.set_defaults(fn=_cmd_sweep)

    v = sub.add_parser("serve", help="continuous receiver (live/synthetic)")
    v.add_argument("--input", default="synthetic",
                   help="'synthetic' (default), '-' for raw samples on "
                        "stdin, 'audio' or 'audio:<device>' for live "
                        "soundcard capture, or a .c2/.wav capture to "
                        "follow")
    v.add_argument("--format", choices=["cf32", "s16"], default="cf32",
                   help="stdin sample format: cf32 = interleaved float32 "
                        "I/Q at 375 S/s; s16 = 12 kS/s 16-bit mono audio")
    v.add_argument("--repeat", action="store_true",
                   help="loop a file input (reference c2file_source repeat)")
    v.add_argument("--sim-drift", type=float, default=0.0,
                   help="inject linear drift into a .c2 input (Hz/min)")
    v.add_argument("--engine", choices=["auto", "host", "device", "hybrid"],
                   default="auto")
    v.add_argument("--runtime", choices=["python", "native", "ring"],
                   default="python",
                   help="native = C++ ingest/windowing + fixed-width "
                        "batched XLA decode (BatchedStreamDecoder); "
                        "ring = device-resident sample ring, hop-only "
                        "h2d ingest (DeviceRingDecoder — the serving "
                        "mode for host-fed GPU deployments)")
    v.add_argument("--mesh", default=None, metavar="CxT",
                   help="serve through a (channel, time) device mesh via "
                        "ShardedStreamDecoder — the multi-chip receiver "
                        "(e.g. 2x4; channels sharded, the time axis "
                        "decodes hop blocks with ppermute halo exchange)")
    v.add_argument("--wins-per-shard", type=int, default=4,
                   help="windows decoded per time shard per mesh step "
                        "(larger amortizes the halo exchange; adds "
                        "step latency)")
    v.add_argument("--maxcycles", type=int, default=None,
                   help="Fano budget in cycles/bit (default: the reference "
                        "10000; smaller trades deep-SNR sensitivity for "
                        "bounded worst-case step latency)")
    v.add_argument("--jiggles", type=int, default=None,
                   help="time-jiggle retry attempts per candidate "
                        "(default: the reference 17)")
    v.add_argument("--batch", type=int, default=8,
                   help="windows per XLA batch for --runtime native")
    v.add_argument("--passes", type=int, default=1,
                   help="interference-cancellation passes per window "
                        "(python runtime)")
    v.add_argument("--channels", type=int, default=4)
    v.add_argument("--windows", type=int, default=30,
                   help="hop-blocks to stream (first window after 14); "
                        "bounds synthetic and --repeat inputs")
    v.add_argument("--snr", type=float, default=-18.0)
    v.add_argument("--duty", type=float, default=0.3,
                   help="per-hop probability of starting a new frame")
    v.add_argument("--hashtable", default=None)
    v.add_argument("--messagelog", default=None)
    v.add_argument("--jsonl", default=None)
    v.add_argument("--spots", default=None)
    v.add_argument("--allwspr", default=None)
    v.set_defaults(fn=_cmd_serve)

    wu = sub.add_parser("warmup", help="pre-compile the serving programs "
                                       "into the persistent cache (one-"
                                       "time; cuts cold serve/bench "
                                       "start by minutes)")
    wu.add_argument("--batch", default="128",
                    help="comma-separated window-batch widths (default "
                         "128, the serving batch)")
    wu.add_argument("--engines", default="device,hybrid",
                    help="comma-separated engines to warm")
    wu.add_argument("--wideband", action="store_true",
                    help="warm the halfbandwidth=187 wideband config "
                         "instead of narrowband")
    wu.set_defaults(fn=_cmd_warmup)

    g = sub.add_parser("grc", help="run a GNU Radio Companion flowgraph "
                                   "(the reference's .grc files)")
    g.add_argument("file", help="GRC 3.7 XML flowgraph")
    g.add_argument("--show", action="store_true",
                   help="print the parsed mapping and exit")
    g.add_argument("--files-dir", default=None,
                   help="directory to resolve the flowgraph's capture files "
                        "(default: the flowgraph's own directory)")
    g.add_argument("--windows", type=int, default=30,
                   help="hop-blocks to stream for repeating sources")
    g.add_argument("--engine", choices=["auto", "host", "device", "hybrid"],
                   default="auto")
    g.add_argument("--hashtable", default=None)
    g.add_argument("-o", "--output", default=None,
                   help="sender flowgraphs: output wav path")
    g.set_defaults(fn=_cmd_grc)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    _apply_platform(args)
    args.fn(args)


if __name__ == "__main__":
    main()
