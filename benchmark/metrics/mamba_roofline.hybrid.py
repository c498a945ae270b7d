"""The share of their bound that the rollout's one-step Mamba-2 mixer calls
reach, in percent: the least time an H100 could take for the spans chunk's
``core.mamba`` calls (``counts/hybrid.py``: every weight, the SSM and conv
state read and written, the input and output, against 3.35 TB/s; the
operations against 67 TFLOP/s; the larger), over their device ms."""
from benchmark.counts import hybrid


def read(rec):
    row = (rec.get('spans') or {}).get('core.mamba')
    if row is None or not row['device_ms'] or 'hybrid' not in rec:
        return None
    bound = hybrid.mamba_roofline_ms(rec['hybrid'], rec['n_envs'], row['n'])
    return 100 * bound / row['device_ms']
