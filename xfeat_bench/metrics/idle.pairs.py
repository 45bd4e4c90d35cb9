"""`idle.pairs` (%, moves `pairs_per_s`): the share of the traced window in
which no operation (kernel, copy or set) ran on the device."""

from xfeat_bench.readers import idle_pct


def read(run):
    return idle_pct(run)
