"""`attention_roofline` (%, moves `pairs_per_s`): kernel D
(`csrc/attention.cu`) against the larger, launch by launch, of 4 Nq keys
96 at the TF32 peak and its bytes at 3.35 TB/s, Nq and keys being the
points each layer keeps on either side by the reference's masks on the
same inputs (`counts.attention_*`), over the time D's kernels ran."""

from xfeat_bench import peaks
from xfeat_bench.readers import roofline_pct

KERNEL = r"attn_partial_kernel|attn_merge_kernel"


def read(run):
    return roofline_pct(run, KERNEL, lambda w: sum(
        max(f / peaks.TF32_FLOPS, b / peaks.HBM_BYTES)
        for f, b in w.get("attention", [])))
