"""Kernel launches an env step: the runtime's and the driver's kernel-launch
calls (``cudaLaunchKernel``, ``cuLaunchKernel``, ...) in the host-and-device
``torch.profiler`` trace of the steps after the window, less the trace's two
marker fills, over the steps traced; the benchmark's two draws a step
(actions and spawn slots) included. A count a step."""
from benchmark import spans
from benchmark.drivers.step import TRACED_STEPS


def read(rec):
    n = spans.launches(rec.get('host_trace'))
    return None if n is None else n / TRACED_STEPS
