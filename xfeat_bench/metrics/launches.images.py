"""`launches.images` (launches, moves `images_per_s`): device kernels per
request in the traced window, copies and sets left out: the host's
dispatch work."""

from xfeat_bench.readers import launches_per_request


def read(run):
    return launches_per_request(run)
