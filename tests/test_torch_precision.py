"""`ops/precision.full_fp32_convs` and `full_fp32_matmuls` under threads
that overlap inside them (a server's handlers): the flag stays off while
any holder is inside, and the caller's value comes back after the last
one leaves. CPU only: the flags are plain torch settings."""

import threading

import pytest
import torch

from accelerated_features_tpu_torch.ops.precision import (full_fp32_convs,
                                                          full_fp32_matmuls)

SWITCHES = {
    "convs": (full_fp32_convs, torch.backends.cudnn, "allow_tf32"),
    "matmuls": (full_fp32_matmuls, torch.backends.cuda.matmul, "allow_tf32"),
}


@pytest.fixture(params=sorted(SWITCHES))
def switch(request):
    fn, backend, flag = SWITCHES[request.param]
    prev = getattr(backend, flag)
    setattr(backend, flag, True)  # the caller's value to restore
    yield fn, lambda: getattr(backend, flag)
    setattr(backend, flag, prev)


def _run(threads):
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
        assert not t.is_alive()


def test_overlapping_holders_never_see_the_flag_on(switch):
    """A enters, B enters, A leaves while B is inside, B leaves: each
    thread reads the flag at every step, as a `with` block and as a
    decorator."""
    fn, read = switch
    steps = [threading.Barrier(2) for _ in range(4)]
    seen = {"a": [], "b": []}

    def a():
        with fn():
            seen["a"].append(read())
            steps[0].wait(10)            # both inside
            seen["a"].append(read())
        steps[1].wait(10)                # A has left, B is inside
        steps[2].wait(10)
        steps[3].wait(10)

    @fn()
    def b_inside():
        steps[0].wait(10)
        steps[1].wait(10)
        seen["b"].append(read())         # A has left
        steps[2].wait(10)
        seen["b"].append(read())

    def b():
        b_inside()
        steps[3].wait(10)

    _run([threading.Thread(target=a), threading.Thread(target=b)])
    assert seen == {"a": [False, False], "b": [False, False]}
    assert read() is True


def test_interleaved_exits_restore_the_callers_flag(switch):
    """B enters first and leaves last, A enters and leaves inside it, and
    one holder raises: the flag is off throughout and True after."""
    fn, read = switch
    inside = threading.Barrier(2)
    a_left = threading.Event()
    seen = []

    def a():
        inside.wait(10)
        try:
            with fn():
                seen.append(read())
                raise ValueError("inside")
        except ValueError:
            pass
        a_left.set()

    def b():
        with fn():
            inside.wait(10)
            a_left.wait(10)
            seen.append(read())

    _run([threading.Thread(target=a), threading.Thread(target=b)])
    assert seen == [False, False]
    assert read() is True


def test_many_threads_stress(switch):
    """Eight threads enter and leave many times with a short switch
    interval; no holder ever reads the flag on, and the caller's value
    comes back."""
    import sys
    fn, read = switch
    bad = []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(300):
                with fn():
                    if read():
                        bad.append(1)
        _run([threading.Thread(target=work) for _ in range(8)])
    finally:
        sys.setswitchinterval(old)
    assert not bad
    assert read() is True
