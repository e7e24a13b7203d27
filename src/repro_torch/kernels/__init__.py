# Hand-written Hopper (sm_90a) kernels replacing the reference's Pallas TPU
# kernels.  Each wrapper launches its CUDA kernel on CUDA tensors and runs
# its plain PyTorch version on CPU tensors; sources live in ../csrc/.
import contextlib
import threading

# the launch tally of the CUDA graph capture this thread is running, if any
_capture = threading.local()
# several threads may launch at once (a scheduler's tick beside a capture,
# a schedulerless frontend's handlers): `launches += n` is no atomic step
_count_lock = threading.Lock()


def count_launch(fn, n: int = 1) -> None:
    """Add n to wrapper `fn`'s `launches` where it launches its kernel (or
    a graph replays its captured launches).  While this thread captures a
    CUDA graph (`captured_launches`), the call ran nothing on the device:
    it goes to the capture's tally instead.  Other threads' launches
    meanwhile count as always."""
    tally = getattr(_capture, "tally", None)
    if tally is not None:
        tally[fn] = tally.get(fn, 0) + n
        return
    with _count_lock:
        fn.launches += n


@contextlib.contextmanager
def captured_launches():
    """Yields a dict that collects this thread's `count_launch` calls, per
    wrapper, until the block ends."""
    tally = {}
    _capture.tally = tally
    try:
        yield tally
    finally:
        _capture.tally = None
