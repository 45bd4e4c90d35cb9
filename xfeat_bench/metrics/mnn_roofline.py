"""`mnn_roofline` (%, moves `pairs_per_s`): kernel C (`csrc/mnn.cu`)
against the larger of its operations, 2 n0 n1 64 over the valid rows and
columns at the TF32 peak, and its bytes at 3.35 TB/s (`counts.mnn_*`),
over the time C's kernels ran."""

from xfeat_bench import peaks
from xfeat_bench.readers import roofline_pct

KERNEL = r"mnn_panel_kernel|mnn_finish_kernel"


def read(run):
    return roofline_pct(run, KERNEL, lambda w: max(
        w.get("mnn_flops", 0.0) / peaks.TF32_FLOPS,
        w.get("mnn_bytes", 0.0) / peaks.HBM_BYTES))
