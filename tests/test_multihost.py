"""Multi-host decode via jax.distributed CPU simulation.

Two OS processes form a jax.distributed job (coordinator on localhost),
each contributing 2 virtual CPU devices; the (channel, time) mesh spans
both processes, so the ppermute halo exchange crosses the process
boundary — the CI stand-in for a multi-host GPU deployment.
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

_WORKER = r"""
import os, sys
proc_id = int(sys.argv[1])
port = sys.argv[2]
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
jax.config.update("jax_platforms", "cpu")
jax.distributed.initialize(coordinator_address=f"localhost:{port}",
                           num_processes=2, process_id=proc_id)
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
sys.path.insert(0, sys.argv[3])
from uwspr_tpu.config import CoarseConfig, DemodConfig, PipelineConfig, StreamConfig
from uwspr_tpu.parallel.distributed import global_mesh
from uwspr_tpu.parallel.mesh import ShardedDecoder
from uwspr_tpu.io.channel import noise_sigma
from uwspr_tpu.protocol.modulate import synthesize_frame

assert jax.process_count() == 2, jax.process_count()
assert len(jax.devices()) == 4

mesh = global_mesh(n_channel=2, n_time=2)
config = PipelineConfig(coarse=CoarseConfig(maxfreqs=4),
                        demod=DemodConfig(maxcycles=128, n_jiggles=3),
                        stream=StreamConfig())
dec = ShardedDecoder(config, mesh)
hop, halo = dec.hop, dec.halo

# a FULL decodable frame: its 41472 samples span both 3375-sample time
# blocks plus the tail, so a decode proves the cross-process ppermute
# halo exchange carries correct samples
rng = np.random.default_rng(0)          # same stream on both hosts
sigma = noise_sigma(-14.0)
total_len = 2 * hop
x = (rng.normal(scale=sigma, size=(2, total_len))
     + 1j * rng.normal(scale=sigma, size=(2, total_len))).astype(np.complex64)
tail = (rng.normal(scale=sigma, size=(2, halo))
        + 1j * rng.normal(scale=sigma, size=(2, halo))).astype(np.complex64)
frame = synthesize_frame("VE3EMB", "FN25", 30, pad_to=None, freq_offset=1.0)
stream = np.concatenate([x, tail], axis=1)
stream[0, 300:300 + len(frame)] += frame
x, tail = stream[:, :total_len], stream[:, total_len:]

# decode() builds the global arrays with make_array_from_callback, which
# works in multi-process jobs (each process supplies its local shards)
out, n_spots = dec.decode(x, tail)
total = int(np.asarray(n_spots))        # psum'd: replicated on every host
assert total >= 1, f"boundary-straddling frame did not decode ({total})"
local = out["success"].addressable_shards
assert len(local) == 2, len(local)                   # 2 local devices

# each process unpacks the messages its local shards decoded
from uwspr_tpu.protocol.messages import unpack_message
found = []
for ss, ps in zip(out["success"].addressable_shards,
                  out["payload"].addressable_shards):
    succ = np.asarray(ss.data)[0, 0]
    pay = np.asarray(ps.data)[0, 0]
    for c in np.flatnonzero(succ):
        u = unpack_message(bytes(pay[c]))
        if u is not None:
            found.append(u.text)
print(f"RESULT {jax.process_index()} local_shards={len(local)} "
      f"global_spots={total} found={found}", flush=True)

# local=True: each process feeds ONLY its own channel rows
# (distributed.process_local_channels) and the spot count must agree
from uwspr_tpu.parallel.distributed import process_local_channels
start, count = process_local_channels(2)
out2, n2 = dec.decode(x[start:start + count], tail[start:start + count],
                      local=True)
assert int(np.asarray(n2)) == total, (int(np.asarray(n2)), total)
print("MULTIHOST_OK", flush=True)
"""


@pytest.mark.slow
def test_two_process_mesh(tmp_path):
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    repo = str(pathlib.Path(__file__).resolve().parent.parent)
    port = "29517"
    procs = [
        subprocess.Popen([sys.executable, str(worker), str(i), port, repo],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
        for i in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=420)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("multi-host worker timed out")
        outs.append(out)
    for i, out in enumerate(outs):
        assert "MULTIHOST_OK" in out, f"process {i} failed:\n{out[-3000:]}"
    # the frame's message must have been unpacked by the process owning
    # channel 0 / window 0 (whichever that is)
    assert any("VE3EMB FN25 30" in out for out in outs), outs
