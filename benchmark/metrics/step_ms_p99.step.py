"""The 99th percentile, over every step of the window, of the device's step
period: the interval between the CUDA events recorded after consecutive
``env.step`` calls. It reads where the host held the card back for more than
one step in a hundred. In ms."""


def read(rec):
    return rec.get('step_ms_p99')
