"""Reading a device trace: busy time, idle gaps by host range, and kernel
time attributed to the op range that launched it."""

from types import SimpleNamespace

import pytest

from harness.devtrace import DeviceTrace, op_calls, roofline
from harness import files


class Ev:
    def __init__(self, name, kind, start, dur, corr=0):
        self._n, self._k, self._s, self._d, self._c = name, kind, start, dur, corr

    def name(self):
        return self._n

    def activity_type(self):
        return self._k

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def correlation_id(self):
        return self._c

    def linked_correlation_id(self):
        return 0


class BareEv(Ev):
    """An event of a build with no ``activity_type()`` (the card's torch
    2.11): its kind follows from its device and name."""

    def __getattribute__(self, name):
        if name == "activity_type":
            raise AttributeError(name)
        return super().__getattribute__(name)

    def device_type(self):
        return "DeviceType.CUDA" if self._k in ("kernel", "gpu_memcpy", "gpu_memset") else "DeviceType.CPU"

    def is_user_annotation(self):
        return False


def trace(ev=Ev):
    # On the trace's clock: window 0..1000 ns; an op range 100..300 launching
    # kernel 1 (corr 1); an eager kernel launched at 500 (corr 2); a layer
    # range 600..1000; the marker launched at 10.  The host clock runs 5000
    # ns behind the trace's.
    lag = 5000
    return DeviceTrace([
        ev("cudaLaunchKernel", "cuda_runtime", 10, 2, corr=9),
        ev("spin_kernel", "kernel", 12, 1, corr=9),
        ev("cudaLaunchKernel", "cuda_runtime", 150, 5, corr=1),
        ev("cudaLaunchKernel", "cuda_runtime", 500, 5, corr=2),
        ev("assign_min_kernel", "kernel", 200, 300, corr=1),
        ev("elementwise", "kernel", 520, 30, corr=2),
        ev("Memcpy HtoD", "gpu_memcpy", 900, 200, corr=3),
    ], (0 - lag, 1000 - lag), [("perfbench.op.assign_min#0", 100 - lag, 300 - lag),
                               ("perfbench.layer.kmeans.plusplus", 600 - lag, 1000 - lag)],
        marker=(8 - lag, 12 - lag))


@pytest.mark.parametrize("ev", [Ev, BareEv])
def test_busy_idle_and_attribution(ev):
    t = trace(ev)
    assert t.window_s == pytest.approx(1e-6)
    assert t.busy() == [(12, 13), (200, 500), (520, 550), (900, 1000)]   # the copy clipped at the window's end
    assert t.busy_s() == pytest.approx(431e-9)
    assert t.by_op_call() == {"perfbench.op.assign_min#0": pytest.approx(300e-9)}
    assert t.outside_ops_s() == pytest.approx(31e-9)                 # the elementwise kernel and the marker
    gaps = dict(t.idle_gaps())
    assert gaps["perfbench.op.assign_min"] == pytest.approx(187e-9)  # 13..200, its middle in the op range
    assert gaps["window"] == pytest.approx(32e-9)                    # 0..12 and 500..520: no range open
    assert gaps["perfbench.layer.kmeans.plusplus"] == pytest.approx(350e-9)  # 550..900
    assert t.top_ops()[0] == ["assign_min_kernel", pytest.approx(300e-9)]


def test_roofline_share_of_the_calls():
    t = trace()
    calls = [("assign_min", (("tensor", (1, 1000, 128), "torch.float32"), ("tensor", (1, 100, 128), "torch.float32"), 100), {})]
    assert op_calls(t, calls, "assign_min") == [(calls[0][1], {}, pytest.approx(300e-9))]
    run = SimpleNamespace(trace=t, calls=calls, files=files, peaks=files.peaks())
    cost = files.kernel("assign_min").cost(calls[0][1], {}, run.peaks)["seconds"]
    assert roofline(run, "assign_min") == pytest.approx(100.0 * cost / 300e-9)
    assert roofline(run, "flash_attention") is None


def test_a_marker_without_its_launch_record_ties_the_clocks_by_its_start():
    """A trace that lost the marker's launch call: the marker kernel's start
    stands for it."""
    lag = 5000
    t = DeviceTrace([Ev("spin_kernel", "kernel", 12, 1, corr=9), Ev("k", "kernel", 200, 300, corr=1),
                     Ev("cudaLaunchKernel", "cuda_runtime", 150, 5, corr=1)],
                    (0 - lag, 1000 - lag), [], marker=(8 - lag, 14 - lag))
    assert t.marker_launched is False and t.window == (1, 1001)  # the start, 1 ns past the host times' middle
    with pytest.raises(RuntimeError, match="no marker kernel"):
        DeviceTrace([Ev("k", "kernel", 200, 300, corr=1)], (0, 1000), [], marker=(8, 14))
