"""`detect_roofline` (%, moves `images_per_s`): kernel A
(`csrc/detect_fused.cu`) against its byte bound: the keypoint heatmap and
the reliability read once, keypoints and scores written, at 3.35 TB/s
(`counts.detect_bytes`), over the time A's kernels ran."""

from xfeat_bench import peaks
from xfeat_bench.readers import roofline_pct

KERNEL = r"detect_candidates_kernel|select_kernel"


def read(run):
    return roofline_pct(run, KERNEL,
                        lambda w: w.get("detect_bytes", 0.0)
                        / peaks.HBM_BYTES)
