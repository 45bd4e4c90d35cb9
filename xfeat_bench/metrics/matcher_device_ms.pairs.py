"""`matcher_device_ms.pairs` (ms, moves `pairs_per_s`): device time of
the operations launched inside the benchmark's spans around the matcher
(kernel C's `batch_mnn_match_fused` and its pair gathers, or
`lighterglue_forward`), per pair of the traced window."""

from xfeat_bench.readers import span_device_ms


def read(run):
    return span_device_ms(run, "match", "pairs")
