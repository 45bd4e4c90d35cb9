"""`layers.pairs` (layers, moves `pairs_per_s`): the mean number of layers
a pair of the traced window ran, from the program's own count
(`lighterglue_forward`'s `layers`, which its depth confidence lowers
when a pair exits early). None where the requests hold no such count."""


def read(run):
    work = run.work
    if not work or any("layers" not in w for w in work):
        return None
    pairs = sum(w["pairs"] for w in work)
    return sum(w["layers"] for w in work) / pairs if pairs else None
