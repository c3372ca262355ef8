"""A 1-D mesh of torch devices, and the runner of one function per shard.

Port of `pyrodigal_tpu.parallel.mesh`: the JAX package's mesh is a
`jax.sharding.Mesh` whose one axis, "contigs", shards a launch's rows,
with `shard_map` running the launch on every device.  Here a mesh is an
ordered list of devices, and `Mesh.run` calls a function once per shard,
each from its own thread, under its device and on a CUDA stream of its
own, so that shards on several cards (or several shards on one card)
run side by side.

The JAX module's `sharded_dp` is not ported: it shards `dp_jax.dp_scores`,
the `lax.scan` DP that the port does not carry (the launches run the
hand-written DP kernels instead; see `meta_shard`).
"""

import concurrent.futures
import threading

import torch

from .. import tracing


def canonical(device):
    """`device` as a torch.device, a CUDA device without an index being
    the current one."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


class Mesh:
    """An ordered list of torch devices, one per shard; a device may
    repeat (two shards on one card, or CPU shards in the tests)."""

    def __init__(self, devices):
        self.devices = tuple(canonical(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self._streams = [None] * len(self.devices)
        self._lock = threading.Lock()
        # one thread a shard, made once; a one-shard mesh runs inline
        self._pool = (concurrent.futures.ThreadPoolExecutor(self.size)
                      if self.size > 1 else None)

    @property
    def size(self):
        return len(self.devices)

    def stream(self, k):
        """Shard k's CUDA stream, made on first use (None on the CPU)."""
        dev = self.devices[k]
        if dev.type != "cuda":
            return None
        with self._lock:
            if self._streams[k] is None:
                self._streams[k] = torch.cuda.Stream(device=dev)
            return self._streams[k]

    def run(self, fn):
        """[fn(k, device) for every shard k], each call under its device
        and on its own stream, from a thread of its own (the caller's in
        a one-shard mesh).  The stream first waits for the device's
        default stream (where the callers' tables were made), and a call
        returns when its stream is done, so its results may be read from
        any stream."""

        def shard(k):
            dev = self.devices[k]
            stream = self.stream(k)
            if stream is None:
                return fn(k, dev)
            with torch.cuda.device(dev), torch.cuda.stream(stream):
                stream.wait_stream(torch.cuda.default_stream(dev))
                out = fn(k, dev)
            with tracing.span("launch.wait"):
                stream.synchronize()
            return out

        if self._pool is None:
            return [shard(0)]
        return list(self._pool.map(tracing.carry(shard, "launch.shard"),
                                   range(self.size)))


def make_mesh(n_devices=None, *, devices=None):
    """A 1-D mesh over every visible CUDA device, or the first
    `n_devices` of them; or over `devices`, an explicit list that may
    repeat a device (e.g. `["cpu"] * 8`, or `["cuda:0"] * 2`).  Without
    `devices` and without a CUDA device it raises: there is no CPU
    fallback."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device is available; "
                               "pass devices=[...] for a mesh on the CPU")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if n_devices is not None:
        if not 1 <= n_devices <= len(devices):
            raise ValueError(f"make_mesh: {n_devices} devices asked for, "
                             f"{len(devices)} available")
        devices = devices[:n_devices]
    return Mesh(devices)
