"""Multi-host runtime setup: jax.distributed + global mesh helpers.

The reference has no distributed capability (SURVEY.md section 2.4); this
framework scales a continuous multichannel receiver over several GPU hosts:
each host feeds its local shard of receive channels / time blocks, the
mesh spans all hosts, and XLA inserts the collectives (the ppermute halo
exchange of parallel.mesh rides NVLink within a host, the network across
hosts).

Launch pattern (one process per host):

    from uwspr_tpu.parallel.distributed import initialize, global_mesh
    initialize("host0:1234", num_processes=2, process_id=0)
    mesh = global_mesh(n_channel=..., n_time=...)
    dec = ShardedDecoder(config, mesh)
    out, n = dec.decode(global_array)   # jax.make_array_from_process_local_data

CPU simulation for CI: jax.distributed with multiple processes, or the
single-process virtual-device grid used by the test suite.
"""

from __future__ import annotations

import jax
from jax.sharding import Mesh


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Initialize jax.distributed. On GPU and CPU clusters pass all three
    arguments explicitly (nothing in a plain host tells JAX of its
    cluster). Safe to call when already initialized (no-op)."""
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id)
    except RuntimeError as e:                     # already initialized
        msg = str(e).lower()
        # jax wordings across versions: "already initialized" /
        # "should only be called once"
        if "already" not in msg and "only be called once" not in msg:
            raise


def global_mesh(n_channel: int, n_time: int) -> Mesh:
    """A (channel, time) mesh over every device in the job (all hosts).

    Devices are laid out so that the time axis — which carries the
    ppermute halo exchange every step — stays within a host's devices
    (ICI) wherever n_time divides the per-host device count, and the
    channel axis (embarrassingly parallel) spans hosts (DCN).
    """
    from uwspr_tpu.parallel.mesh import make_mesh
    devs = jax.devices()
    if len(devs) < n_channel * n_time:
        raise ValueError(
            f"need {n_channel * n_time} devices, have {len(devs)}")
    return make_mesh(n_channel, n_time, devices=devs)


def process_local_channels(n_channel: int) -> tuple[int, int]:
    """(start, count) of the channel rows this process should feed, for
    building global arrays with jax.make_array_from_process_local_data."""
    per = n_channel // jax.process_count()
    return jax.process_index() * per, per


__all__ = ["initialize", "global_mesh", "process_local_channels"]
