"""The observe kernel's share of its roofline (the layer ``ops/fused.py::observe``
and ``csrc/observe.cu``): the least time one H100 could take for one launch
on this step's scene and hits (the benchmark's frozen count of the plain
algorithm's bytes and operations, at the published peaks), over the mean
device time of a launch of the kernels whose name holds ``PATTERN``, from the
traced steps. In percent."""
from benchmark import common

PATTERN = 'observe_kernel'


def read(rec):
    trace, bound = rec.get('trace'), rec.get('observe_bound_ms')
    if trace is None or bound is None:
        return None
    ms, launches = common.kernel_ms(trace, PATTERN)
    return None if ms is None else 100 * bound / ms
