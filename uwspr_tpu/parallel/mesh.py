"""Multi-chip / multi-host scaling: channel x time sharding over a Mesh.

The reference has no distributed capability at all (SURVEY.md section 2.4);
its implicit "pipeline parallelism" (GNU Radio block threads working on
PDUs in flight) is replaced by data parallelism over a 2-D device mesh:

- axis "channel": independent receive channels, embarrassingly parallel;
- axis "time": a continuous stream is split into hop-aligned blocks, one
  per shard. Every 120 s window overlaps the following samples by fl-hop
  (111 s), so each shard must see a *right halo* of fl-hop samples beyond
  its own block — the overlap-save equivalent of the reference's
  ring-buffer window builder
  (lib/sliding_window_stream_to_pdu_impl.cc:113-135).

Because the halo (fl-hop = 41625 samples) is usually LONGER than a
hop-aligned block, the halo is assembled by a *chained* lax.ppermute:
ceil(halo/block) rounds, each forwarding one more right-neighbor block
over ICI. Shards whose halo extends past the end of the step's data patch
the missing region from a host-provided ``tail`` (the next samples of the
stream, or zeros at end-of-stream). The time axis is therefore NOT
circular: window w of shard t covers exactly global samples
[t*block + w*hop, t*block + w*hop + fl), identical to a single-device
sliding window over the concatenated stream.

Global spot statistics are reduced with psum. Decoded payloads stay
sharded; the host gathers only the (C, 7)-byte messages.

``ShardedStreamDecoder`` is the streaming driver: it buffers a continuous
multichannel stream on the host, feeds fixed-size hop-aligned steps
through the sharded decode (passing the first fl-hop samples of the
*next* step as the tail), unpacks spots, and supports checkpoint/resume
like the single-host StreamDecoder. Like the single-host decoder it has
two engines: "device" (Fano inside the sharded XLA program) and "hybrid"
(shards stop at the sync/rms gates; the gathered packed prefano runs
through the native C++ host Fano with OSD fallback — the deep-SNR
serving mode, see pipeline.jit_decoder fano_mode).
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from uwspr_tpu.config import PipelineConfig
from uwspr_tpu.pipeline.jit_decoder import DeviceDecoder, DeviceDecoderOutput


def make_mesh(n_channel: int, n_time: int, devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    assert len(devices) >= n_channel * n_time, \
        f"need {n_channel * n_time} devices, have {len(devices)}"
    devs = np.array(devices[: n_channel * n_time]).reshape(n_channel, n_time)
    return Mesh(devs, axis_names=("channel", "time"))


def extend_with_halo(x_ri: jnp.ndarray, tail_ri: jnp.ndarray, *,
                     n_time: int, block_len: int, halo: int,
                     axis_name: str = "time") -> jnp.ndarray:
    """Per-shard (ch_l, 2, block_len) block -> (ch_l, 2, block_len + halo).

    Runs inside shard_map. Chains ceil(halo/block_len) ppermute rounds so
    shard t accumulates the blocks of shards t+1, t+2, ...; positions past
    the last shard are patched from ``tail_ri`` (ch_l, 2, halo), which is
    replicated along the time axis and holds the stream samples that
    globally follow this step's data.
    """
    if n_time == 1:
        return jnp.concatenate([x_ri, tail_ri], axis=2)
    k = -(-halo // block_len)                       # ppermute rounds
    t = jax.lax.axis_index(axis_name)
    pad = k * block_len - halo
    tail_pad = jnp.pad(tail_ri, ((0, 0), (0, 0), (0, pad)))
    perm = [(i, (i - 1) % n_time) for i in range(n_time)]
    pieces = [x_ri]
    recv = x_ri
    for m in range(1, k + 1):
        # after m rounds, shard t holds shard (t+m) mod n_time's block
        recv = jax.lax.ppermute(recv, axis_name, perm=perm)
        in_range = (t + m) < n_time
        # wrapped shards carry next-step data: take it from the tail, whose
        # offset within this shard's halo is (t+m-n_time)*block_len
        off = jnp.maximum(t + m - n_time, 0) * block_len
        patch = jax.lax.dynamic_slice_in_dim(tail_pad, off, block_len, axis=2)
        pieces.append(jnp.where(in_range, recv, patch))
    ext = jnp.concatenate(pieces, axis=2)
    return ext[:, :, : block_len + halo]


class ShardedDecoder:
    """Decode (channels, time_samples) arrays sharded over a mesh.

    time_samples per shard must be a multiple of the window hop; each shard
    decodes block_len // hop windows. Window starts are global-contiguous
    across time shards (shard t's window w starts at t*block_len + w*hop),
    so the output's window axis is in global stream order.
    """

    def __init__(self, config: PipelineConfig | None = None,
                 mesh: Mesh | None = None, fano_mode: str = "device"):
        # fano_mode "device": the whole decode (incl. Fano) runs in the
        # sharded XLA program. "host" (the hybrid engine, mesh edition):
        # each shard stops after the sync/rms gates and returns the packed
        # prefano array; the host gathers it and runs the native C++ Fano
        # (+ OSD fallback if configured) via _host_fano_assemble — same
        # deep-SNR rationale as DeviceDecoder(fano_mode="host").
        self.config = config or PipelineConfig()
        self.mesh = mesh or make_mesh(len(jax.devices()), 1)
        self.fano_mode = fano_mode
        self.decoder = DeviceDecoder(self.config, fano_mode=fano_mode)
        self._step = None

    @property
    def fl(self) -> int:
        return self.config.stream.fl

    @property
    def hop(self) -> int:
        return self.config.stream.shift * self.config.stream.fs

    @property
    def halo(self) -> int:
        return self.fl - self.hop

    def _build(self, ch_local: int, block_len: int):
        fl, hop, halo = self.fl, self.hop, self.halo
        n_win = block_len // hop
        n_time = self.mesh.shape["time"]
        decode_batched = self.decoder._decode_windows_batched
        hybrid = self.fano_mode == "host"

        def shard_fn(x_ri, tail_ri):        # (ch_l, 2, block_len), (ch_l, 2, halo)
            ext_ri = extend_with_halo(x_ri, tail_ri, n_time=n_time,
                                      block_len=block_len, halo=halo)
            # every (channel, window) of the shard through the SAME batched
            # program as DeviceDecoder.decode_windows_ri (vmapped pre-Fano
            # pipeline, refine-lane compaction if configured, one
            # cross-window two-phase Fano batch) — the probe einsums carry
            # ch_l*n_win*C lanes.
            starts = jnp.arange(n_win) * hop
            idx = starts[:, None] + jnp.arange(fl)[None, :]
            wins_ri = (ext_ri[:, :, idx]                # (ch_l, 2, n_win, fl)
                       .transpose(0, 2, 1, 3)
                       .reshape(ch_local * n_win, 2, fl))
            if hybrid:
                packed = decode_batched(wins_ri)        # (W_l, C, 11+2J+162J)
                out = {"prefano": packed.reshape(
                    (ch_local, n_win) + packed.shape[1:])}
                # spots are decided by the host Fano; the device-side count
                # is the worth lanes (pending host decodes) for observability
                n_local = ((packed[..., 0] > 0.5)
                           & (packed[..., 1] > 0.5)).sum()
            else:
                flat = decode_batched(wins_ri, pack=False)
                out = {k: v.reshape((ch_local, n_win) + v.shape[1:])
                       for k, v in flat.items()}
                n_local = out["success"].sum()
            n_global = jax.lax.psum(n_local, ("channel", "time"))
            return out, n_global

        # check_vma=False: the decoder's internal lax.scan/while_loop carries
        # start from literal constants, which the varying-axis checker would
        # require pvary annotations on at every init; execution is unaffected.
        fn = jax.shard_map(shard_fn, mesh=self.mesh,
                           in_specs=(P("channel", None, "time"),
                                     P("channel", None, None)),
                           out_specs=(P("channel", "time"), P()),
                           check_vma=False)
        return jax.jit(fn)

    def _sharded_inputs(self, x: np.ndarray, tail: np.ndarray | None,
                        local: bool = False):
        """Host (channels, T) complex + optional (channels, halo) tail ->
        globally sharded (channels, 2, T) / (channels, 2, halo) f32 arrays.

        local=False: ``x`` is the FULL global array, identical on every
        process (the make_array_from_callback path serves each process's
        devices their global slices from it).  local=True (multi-host):
        ``x`` holds only this process's channel rows — the
        ``distributed.process_local_channels`` block — and the global
        array is assembled with jax.make_array_from_process_local_data.
        """
        x = np.asarray(x)
        channels = x.shape[0]
        if tail is None:
            tail = np.zeros((channels, self.halo), dtype=np.complex64)
        tail = np.asarray(tail)
        assert tail.shape == (channels, self.halo), tail.shape

        def to_ri(a):
            return np.stack([a.real.astype(np.float32),
                             a.imag.astype(np.float32)], axis=1)

        x_ri, tail_ri = to_ri(x), to_ri(tail)
        sh_x = NamedSharding(self.mesh, P("channel", None, "time"))
        sh_t = NamedSharding(self.mesh, P("channel", None, None))
        if local and jax.process_count() > 1:
            gx = jax.make_array_from_process_local_data(sh_x, x_ri)
            gt = jax.make_array_from_process_local_data(sh_t, tail_ri)
        else:
            gx = jax.make_array_from_callback(x_ri.shape, sh_x,
                                              lambda idx: x_ri[idx])
            gt = jax.make_array_from_callback(tail_ri.shape, sh_t,
                                              lambda idx: tail_ri[idx])
        return gx, gt

    def decode(self, x: np.ndarray, tail: np.ndarray | None = None,
               local: bool = False):
        """x: (channels, time_samples) complex64, divisible by mesh shape;
        tail: (channels, fl-hop) samples that follow x in the stream
        (zeros = end of stream).

        Multi-host: either pass the full global x on EVERY process
        (local=False, default), or pass only this process's channel rows
        (``distributed.process_local_channels``) with local=True.

        Returns (outputs dict of global arrays (channels, windows, C, ...),
        total_spots scalar). Window w along axis 1 starts at global sample
        w*hop. fano_mode="host": the dict holds one key "prefano" (the
        packed pre-Fano array for _host_fano_assemble) and the scalar
        counts worth lanes (pending host decodes), not spots.
        """
        n_ch, n_t = self.mesh.shape["channel"], self.mesh.shape["time"]
        channels, total = x.shape
        if local:
            channels *= jax.process_count()
        assert channels % n_ch == 0
        assert total % n_t == 0
        block_len = total // n_t
        assert block_len % self.hop == 0, \
            "per-shard block length must be a multiple of the hop"
        key = (channels // n_ch, block_len)
        if self._step is None or self._step[0] != key:
            self._step = (key, self._build(*key))
        gx, gt = self._sharded_inputs(x, tail, local=local)
        return self._step[1](gx, gt)


@dataclasses.dataclass
class ShardedStreamStats:
    steps: int = 0
    windows: int = 0
    spots: int = 0


class ShardedStreamDecoder:
    """Continuous multichannel decoding over a (channel, time) mesh.

    The mesh analogue of pipeline.stream.StreamDecoder: push() buffers
    samples per channel on the host; whenever a full step
    (n_time * wins_per_shard hops) plus its fl-hop lookahead tail is
    buffered, one sharded decode step runs. Consecutive steps are
    continuous: step boundaries are hop-aligned and the tail of step s is
    the head of step s+1, so the emitted window sequence is identical to a
    single-device sliding window (window w starts at global sample w*hop
    — the reference's windowing contract,
    lib/sliding_window_stream_to_pdu_impl.cc:113-135).
    """

    def __init__(self, config: PipelineConfig | None = None,
                 mesh: Mesh | None = None, n_channels: int | None = None,
                 wins_per_shard: int = 1, hashtable=None,
                 engine: str = "device"):
        # engine "device" | "hybrid" — same names/semantics as the
        # single-host StreamDecoder: "hybrid" runs each shard's XLA
        # program through the sync/rms gates and the native C++ Fano
        # (+ OSD fallback, DemodConfig.osd_depth) on the host.
        from uwspr_tpu.protocol.messages import HashTable
        assert engine in ("device", "hybrid"), engine
        self.engine = engine
        self.dec = ShardedDecoder(
            config, mesh, fano_mode="host" if engine == "hybrid" else "device")
        self.mesh = self.dec.mesh
        self.config = self.dec.config
        self.n_time = self.mesh.shape["time"]
        self.n_channels = (n_channels if n_channels is not None
                           else self.mesh.shape["channel"])
        assert self.n_channels % self.mesh.shape["channel"] == 0
        self.wins_per_shard = wins_per_shard
        self.step_len = self.n_time * wins_per_shard * self.dec.hop
        self.hashtable = hashtable if hashtable is not None else HashTable()
        self._buf = np.zeros((self.n_channels, 0), dtype=np.complex64)
        self.windows_emitted = 0          # global window index of next emit
        self.stats = ShardedStreamStats()

    @property
    def hop(self) -> int:
        return self.dec.hop

    @property
    def halo(self) -> int:
        return self.dec.halo

    def _emit(self, out, n_windows: int):
        """Gather one step's sharded outputs and unpack spots on the host.

        Returns [(channel, global_window_index, Spot), ...]. Hybrid: the
        gathered packed prefano runs through the native host Fano (+ OSD
        fallback) before unpacking — one d2h array per step either way.
        """
        host = {k: np.asarray(v)[:, :n_windows] for k, v in out.items()}
        results = []
        n_spots = 0
        if "prefano" in host:               # hybrid engine
            asm = self.dec.decoder._host_fano_assemble(host["prefano"])
            n_spots = int(asm.success.sum())
            for ch in range(self.n_channels):
                for w in range(n_windows):
                    one = asm.window(ch).window(w)
                    if not one.success.any():
                        continue
                    for spot in self.dec.decoder.spots(one, self.hashtable):
                        results.append((ch, self.windows_emitted + w, spot))
        else:
            n_spots = int(host["success"].sum())
            for ch in range(self.n_channels):
                for w in range(n_windows):
                    if not host["success"][ch, w].any():
                        continue
                    one = DeviceDecoderOutput(
                        **{k: host[k][ch, w] for k in host})
                    for spot in self.dec.decoder.spots(one, self.hashtable):
                        results.append(
                            (ch, self.windows_emitted + w, spot))
        self.stats.steps += 1
        self.stats.windows += n_windows * self.n_channels
        self.stats.spots += n_spots
        self.windows_emitted += n_windows
        return results

    def push(self, samples: np.ndarray):
        """samples: (n,) or (channels, n). Returns
        [(channel, global_window_index, Spot), ...] for every step that
        completed."""
        samples = np.atleast_2d(np.asarray(samples, dtype=np.complex64))
        assert samples.shape[0] == self.n_channels
        self._buf = np.concatenate([self._buf, samples], axis=1)
        results = []
        while self._buf.shape[1] >= self.step_len + self.halo:
            x = self._buf[:, :self.step_len]
            tail = self._buf[:, self.step_len:self.step_len + self.halo]
            out, _ = self.dec.decode(x, tail)
            self._buf = self._buf[:, self.step_len:]
            n_windows = self.step_len // self.hop
            results.extend(self._emit(out, n_windows))
        return results

    def flush(self):
        """End of stream: decode the windows still completable from the
        buffered samples (those with start + fl <= buffered length),
        zero-padding the step to its fixed shape. Windows that would
        extend into the zero padding are NOT emitted, matching the
        single-device StreamDecoder (which never emits partial windows)."""
        true_len = self._buf.shape[1]
        n_true = max(0, (true_len - self.config.stream.fl) // self.hop + 1)
        if n_true == 0:
            return []
        padded = np.zeros((self.n_channels, self.step_len + self.halo),
                          dtype=np.complex64)
        padded[:, :true_len] = self._buf
        out, _ = self.dec.decode(padded[:, :self.step_len],
                                 padded[:, self.step_len:])
        results = self._emit(out, n_true)   # spots recounted on kept windows
        self._buf = self._buf[:, n_true * self.hop:]
        return results

    # -- checkpoint/resume (parity with StreamDecoder, SURVEY.md §5) -------

    def save_checkpoint(self, directory: str | os.PathLike) -> None:
        os.makedirs(directory, exist_ok=True)
        np.savez(os.path.join(directory, "mesh_buffer.npz"), buf=self._buf)
        self.hashtable.save(os.path.join(directory, "hashtable.txt"))
        state = dict(self.stats.__dict__, windows_emitted=self.windows_emitted)
        with open(os.path.join(directory, "stream_state.json"), "w") as f:
            json.dump(state, f)

    def load_checkpoint(self, directory: str | os.PathLike) -> None:
        from uwspr_tpu.protocol.messages import HashTable
        data = np.load(os.path.join(directory, "mesh_buffer.npz"))
        self._buf = data["buf"].astype(np.complex64)
        ht = os.path.join(directory, "hashtable.txt")
        if os.path.exists(ht):
            self.hashtable = HashTable.load(ht)
        sp = os.path.join(directory, "stream_state.json")
        if os.path.exists(sp):
            with open(sp) as f:
                state = json.load(f)
            self.windows_emitted = state.pop("windows_emitted", 0)
            self.stats = ShardedStreamStats(**state)


@functools.lru_cache(maxsize=None)
def cpu_mesh(n_channel: int, n_time: int) -> Mesh:
    """Virtual CPU-device mesh for tests/CI (xla_force_host_platform...)."""
    return make_mesh(n_channel, n_time)


__all__ = ["make_mesh", "extend_with_halo", "ShardedDecoder",
           "ShardedStreamDecoder", "ShardedStreamStats", "cpu_mesh"]
