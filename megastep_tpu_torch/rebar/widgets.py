"""Side-by-side refreshable text panes for notebooks.

A copy of :mod:`megastep_tpu.rebar.widgets`: a :class:`Compositor` laying
ipywidgets Output panes out horizontally, each refreshable in place; one
:class:`Pane` class serves both backends, bound to an ipywidgets Output in a
notebook and printing on a console. IPython and ipywidgets are imported only
inside the functions that use them. Refreshes are serialized under one lock
(ipywidgets' clear_output isn't thread-safe).
"""
import threading

_LOCK = threading.RLock()


class Pane:
    """One refreshable text pane. ``widget=None`` means console mode."""

    def __init__(self, lines=80, widget=None, on_close=None):
        self.lines = lines
        self._widget = widget
        self._on_close = on_close

    def refresh(self, content):
        if self._widget is None:
            print(content)
            return
        from IPython.display import clear_output
        with _LOCK, self._widget:
            clear_output(wait=True)
            print(content)

    def close(self):
        if self._on_close is not None:
            self._on_close(self._widget)


def _notebook_box():
    """An HBox displayed in the running notebook, or None on a console."""
    from .logging import in_ipython
    if not in_ipython():
        return None
    try:
        import ipywidgets as widgets
        from IPython.display import display
    except ImportError:
        return None
    box = widgets.HBox(layout=widgets.Layout(align_items='stretch'))
    display(box)
    return box


class Compositor:
    """Hands out panes laid out side by side (stdout panes on consoles)."""

    def __init__(self, lines=80):
        self.lines = lines
        self._box = _notebook_box()

    def output(self):
        if self._box is None:
            return Pane(self.lines)
        import ipywidgets as widgets
        w = widgets.Output(layout=widgets.Layout(width='100%'))
        self._box.children = (*self._box.children, w)
        return Pane(self.lines, w, on_close=self._drop)

    def _drop(self, widget):
        if widget is not None:
            widget.close()
            self._box.children = tuple(c for c in self._box.children
                                       if c is not widget)

    # reference-parity names
    def remove(self, widget):
        self._drop(widget)

    def clear(self):
        if self._box is not None:
            for child in tuple(self._box.children):
                self._drop(child)
