"""Multi-host scale-out scaffolding.

The reference scales past one machine with its TCP server protocol
(reference: core/src/server.cpp — one host digitizes, clients consume
compressed IQ over the network).  The JAX equivalent
(BASELINE config 5: 256-channel scanner over ≥2 hosts):

  * hosts join one jax.distributed job over **DCN**
    (``initialize_distributed``);
  * a global Mesh spans every chip; channel/time shardings place
    collectives (halo ppermute, affine-scan all_gather) on **ICI**;
  * each host feeds only its local time-shard of the wideband IQ
    (``feed_time_sharded`` builds the global array from per-host data
    without gathering — the DCN never carries baseband);
  * host↔device transfer thinning reuses the network compression ladder
    (int8 quantize / EFFT masking): ``io/feed.py DeviceFeed`` compresses
    on the host and decompresses in-graph on device
    (ops/efft_jax.efft_decompress_j); the device→host direction masks on
    device with ops/efft_jax.EFFTCompressorJax.

Single-host multi-chip works through the same API (process_count == 1),
which is how the test suite and the driver's dryrun exercise it.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None):
    """Join (or no-op in single-process mode) the jax distributed job."""
    if num_processes is None or num_processes <= 1:
        return
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)


def make_mesh(n_time: int = 1, n_ch: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """(time × ch) mesh over all devices of the job (global across hosts)."""
    devs = list(devices if devices is not None else jax.devices())
    if n_ch is None:
        n_ch = len(devs) // n_time
    assert n_time * n_ch == len(devs), (n_time, n_ch, len(devs))
    return Mesh(np.array(devs).reshape(n_time, n_ch), ("time", "ch"))


def feed_time_sharded(mesh: Mesh, local_block: np.ndarray,
                      t_global: int) -> jax.Array:
    """Assemble the global time-sharded wideband array from this host's
    local samples without any cross-host gather.

    ``local_block`` must be this process's contiguous time segment
    (t_global // process_count samples).  In single-process mode it is
    the whole block.
    """
    sharding = NamedSharding(mesh, P("time"))
    if jax.process_count() == 1:
        assert len(local_block) == t_global
        return jax.device_put(local_block, sharding)
    return jax.make_array_from_process_local_data(
        sharding, local_block, (t_global,))


def replicate(mesh: Mesh, value) -> jax.Array:
    return jax.device_put(value, NamedSharding(mesh, P()))


def host_local_slice(t_global: int) -> Tuple[int, int]:
    """[start, stop) of this host's time segment."""
    n = jax.process_count()
    i = jax.process_index()
    per = t_global // n
    return i * per, (i + 1) * per
