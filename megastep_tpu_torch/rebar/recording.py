"""Video encoding of rollouts.

Counterpart of :mod:`megastep_tpu.rebar.recording` (the reference
``rebar/recording.py``): an :class:`Encoder` turning a stream of frames (arrays
or matplotlib figures) into a video, and a :class:`ParallelEncoder` that plots
frames in a worker pool while this process encodes them *in submission order*
with a bounded in-flight queue (reference ``recording.py:135-224``).

Backend selection, in the JAX module's order: PyAV if installed, else the
``ffmpeg`` binary, else an animated GIF via Pillow. ``mimetype`` tells you what
you got. matplotlib, Pillow, PyAV and IPython are imported only inside the
functions that use them.

Three differences from the JAX module, all in :class:`ParallelEncoder`: its
'process' workers (:mod:`.parallel`) are spawned, not forked, so they start
from a fresh import and never inherit the parent's CUDA context; only process
workers run :func:`_init_worker`, which ignores SIGINT and picks matplotlib's
Agg backend (the JAX module also runs it in 'thread' workers, where installing
a signal handler off the main thread raises and breaks the pool); and it
imports matplotlib when it is built, so that where matplotlib is missing the
ImportError names it instead of a worker pool breaking.
"""
import base64
import logging
import multiprocessing
import numbers
import shutil
import subprocess
from collections import deque
from io import BytesIO
from pathlib import Path

import numpy as np

from .parallel import parallel

log = logging.getLogger(__name__)


def adjust_bbox(fig):
    from matplotlib import tight_bbox
    bbox = fig.get_tightbbox(fig.canvas.get_renderer())
    tight_bbox.adjust_bbox(fig, bbox, fig.canvas.fixed_dpi)


def array(fig):
    """Renders a matplotlib figure to an (H, W, 3) uint8 array with even dims
    (libx264 requires even resolutions)."""
    try:
        adjust_bbox(fig)
    except Exception:
        fig.tight_layout()
    fig.canvas.draw()
    renderer = fig.canvas.get_renderer()
    w, h = int(renderer.width), int(renderer.height)
    h2, w2 = 2 * (h // 2), 2 * (w // 2)
    return (np.frombuffer(fig.canvas.buffer_rgba(), np.uint8)
            .reshape((h, w, 4))[:h2, :w2, :3].copy())


def _as_uint8(arr):
    if np.issubdtype(arr.dtype, np.floating):
        arr = 255 * arr
    if not np.issubdtype(arr.dtype, np.uint8):
        arr = arr.clip(0, 255).astype(np.uint8)
    return arr


class _AvBackend:
    mimetype = 'mp4'

    def __init__(self, fps, shape):
        import av
        self._content = BytesIO()
        self._container = av.open(self._content, 'w', 'mp4')
        self._stream = self._container.add_stream('h264', rate=fps)
        self._stream.pix_fmt = 'yuv420p'
        self._stream.height, self._stream.width = shape[:2]
        self._format = {1: 'gray', 3: 'rgb24'}[shape[2]]

    def write(self, arr):
        import av
        frame = av.VideoFrame.from_ndarray(arr, format=self._format)
        self._container.mux(self._stream.encode(frame))

    def finish(self):
        self._container.mux(self._stream.encode())
        self._container.close()
        return self._content.getvalue()


class _FfmpegBackend:
    mimetype = 'mp4'

    def __init__(self, fps, shape):
        h, w, c = shape
        fmt = {1: 'gray', 3: 'rgb24'}[c]
        self._proc = subprocess.Popen(
            ['ffmpeg', '-y', '-f', 'rawvideo', '-pix_fmt', fmt, '-s', f'{w}x{h}',
             '-r', str(fps), '-i', 'pipe:0', '-c:v', 'libx264', '-pix_fmt',
             'yuv420p', '-f', 'mp4', '-movflags', 'frag_keyframe+empty_moov',
             'pipe:1'],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL)

    def write(self, arr):
        self._proc.stdin.write(arr.tobytes())

    def finish(self):
        out, _ = self._proc.communicate()
        return out


class _GifBackend:
    mimetype = 'gif'

    def __init__(self, fps, shape):
        self._duration = 1000 / fps
        self._frames = []

    def write(self, arr):
        from PIL import Image
        if arr.shape[2] == 1:
            arr = arr.repeat(3, 2)
        self._frames.append(Image.fromarray(arr))

    def finish(self):
        bs = BytesIO()
        self._frames[0].save(
            bs, format='gif', save_all=True, append_images=self._frames[1:],
            duration=self._duration, loop=0)
        return bs.getvalue()


def _pick_backend():
    try:
        import av  # noqa: F401
        return _AvBackend
    except ImportError:
        pass
    if shutil.which('ffmpeg'):
        return _FfmpegBackend
    return _GifBackend


class Encoder:
    """Encodes frames — (H, W, 1|3) arrays or matplotlib figures — into a video.
    Float arrays are assumed to live in [0, 1] (reference ``recording.py:36-105``).

    >>> with Encoder() as encoder:
    ...     for frame in frames:
    ...         encoder(frame)
    >>> Path('test.mp4').write_bytes(encoder.value)
    """

    def __init__(self, fps=20):
        self._fps = fps
        self._backend = None
        self.mimetype = None

    def __enter__(self):
        return self

    def __call__(self, arr):
        import matplotlib.pyplot as plt
        if isinstance(arr, plt.Figure):
            fig = arr
            arr = array(fig)
            plt.close(fig)

        arr = _as_uint8(np.asarray(arr))
        if self._backend is None:
            self._backend = _pick_backend()(self._fps, arr.shape)
            self.mimetype = self._backend.mimetype
        self._backend.write(arr)

    def __exit__(self, t, v, tb):
        if not t and self._backend is not None:
            self.value = self._backend.finish()


def html_tag(video, height=None, mimetype='mp4', **kwargs):
    if isinstance(video, Encoder):
        mimetype = video.mimetype
        video = video.value
    b64 = base64.b64encode(video).decode('utf-8')
    style = f'style="height: {height}px"' if height else ''
    if mimetype == 'gif':
        return f'<img {style} src="data:image/gif;base64,{b64}"/>'
    return f"""
<video controls autoplay loop {style}>
    <source type="video/mp4" src="data:video/mp4;base64,{b64}">
    Your browser does not support the video tag.
</video>"""


def notebook(video, height=640, **kwargs):
    from IPython.display import display, HTML
    return display(HTML(html_tag(video, height, **kwargs)))


def _init_worker():
    # Process workers ignore SIGINT (the parent's context-manager exit shuts
    # them down) and draw off-screen.
    import signal
    import matplotlib
    signal.signal(signal.SIGINT, lambda h, f: None)
    matplotlib.use('Agg')


def _array(f, *args, **kwargs):
    import matplotlib.pyplot as plt
    result = f(*args, **kwargs)
    if isinstance(result, plt.Figure):
        arr = array(result)
        plt.close(result)
        return arr
    return result


class ParallelEncoder:
    """Plots frames in a worker pool, encodes them in order in this process
    (reference ``recording.py:135-224``).

    >>> with ParallelEncoder(env.plot_state) as encoder:
    ...     for state in states:
    ...         encoder(state)
    >>> encoder.notebook()

    :param f: frame producer returning an array or figure; under 'process' it
        and its arguments are pickled, so it must be importable by its module
        path (an env's ``plot_state`` classmethod is) and its arguments host
        data (the numpy snapshots of ``env.state``).
    :param fps: framerate.
    :param N: worker count (int), fraction of CPUs (float), or None for half.
    :param backend: 'process' (default), 'thread', or 'serial' (debuggable).
    """

    def __init__(self, f, fps=20, N=None, backend='process'):
        # Without matplotlib, fail here and name it, not as a broken pool later.
        import matplotlib  # noqa: F401
        cpus = multiprocessing.cpu_count()
        if N is None:
            N = max(cpus // 2, 1)
        elif isinstance(N, numbers.Integral):
            N = N
        elif isinstance(N, numbers.Real):
            N = int(cpus * N)
        else:
            raise ValueError(f'Number of processes must be int/float/None, got {type(N)}')

        self._encoder = Encoder(fps)
        self._f = f
        self._queuelen = N
        kwargs = {'initializer': _init_worker} if backend == 'process' else {}
        self._pool = parallel(_array, progress=False, n_workers=N,
                              backend=backend, **kwargs)

    def __enter__(self):
        # Frames enter the deque in submission order and leave only from its
        # head, so a frame a worker finishes early waits there for its turn.
        self._pending = deque()
        self._encoder.__enter__()
        self._submit = self._pool.__enter__()
        return self

    def _drain(self, block=False):
        """Encodes every completed frame at the head of the queue; with
        ``block`` waits for all of them."""
        while self._pending:
            if not (block or self._pending[0].done()):
                return
            self._encoder(self._pending.popleft().result())

    def __exit__(self, t, v, tb):
        self._drain(block=True)
        self._encoder.__exit__(t, v, tb)
        self._pool.__exit__(t, v, tb)

    def __call__(self, *args, **kwargs):
        self._pending.append(self._submit(self._f, *args, **kwargs))
        if len(self._pending) > self._queuelen:
            # Bounded in-flight window: block on the oldest frame, which must
            # be encoded first anyway.
            self._pending[0].result()
        self._drain()

    def result(self):
        self._drain(block=True)
        return self._encoder.value

    @property
    def mimetype(self):
        return self._encoder.mimetype

    def notebook(self):
        return notebook(self.result(), mimetype=self._encoder.mimetype)

    def save(self, path):
        Path(path).write_bytes(self.result())
