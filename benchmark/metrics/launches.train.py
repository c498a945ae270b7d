"""Kernel launches in a chunk of the train step: the runtime's and the
driver's kernel-launch calls (``cudaLaunchKernel``, ``cuLaunchKernel``, ...)
of every thread (autograd launches the backward from its own) in the
host-and-device ``torch.profiler`` trace of one chunk after the window, less
the trace's two marker fills. Each is a host call the card may wait on. A
count."""
from benchmark import spans


def read(rec):
    return spans.launches(rec.get('host_trace'))
