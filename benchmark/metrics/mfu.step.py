"""The whole env step's share of the card's f32 peak (67 TFLOP/s): the f32
operations of the step's observe (one ray-line test per agent, ray and live
line) and, in Deathmatch, of its re-bake (one occlusion test per model
texel, light and live wall), from the benchmark's frozen counts, for every
step of the window, over the window's seconds. In percent."""
from benchmark import common


def read(rec):
    if 'step_ops' not in rec or not rec.get('steps'):
        return None
    return 100 * rec['step_ops'] * rec['steps'] / (rec['window_s'] * common.F32_FLOPS)
