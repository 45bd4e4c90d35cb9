"""`extract_device_ms.pairs` (ms, moves `pairs_per_s`): device time of the
operations launched inside the benchmark's span around
`detect_and_compute` (backbone, kernels A and B), per pair of the traced
window."""

from xfeat_bench.readers import span_device_ms


def read(run):
    return span_device_ms(run, "extract", "pairs")
