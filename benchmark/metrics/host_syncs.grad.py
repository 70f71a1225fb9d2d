"""Host runtime calls per gradient step, inside the port's spans, that
wait on the device (stream, device and event synchronizes, synchronous
copies, allocator frees)."""

from benchmark import layers


def read(run):
    return layers.host_syncs(run, "adam")
