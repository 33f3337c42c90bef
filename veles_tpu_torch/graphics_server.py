"""The graphics bus: plot events published on a zmq PUB socket and
rendered to files in process (the port's copy of
``veles_tpu/graphics_server.py``).

Plotting units (:mod:`veles_tpu_torch.plotting_units`) enqueue plot
events on the process's :class:`GraphicsServer`.  It sends each one on
its PUB endpoint, when it has one, to live viewers
(:mod:`veles_tpu_torch.graphics_client`), and renders it to
``<plotter>.png`` in ``$VELES_PLOTS_DIR`` with matplotlib's Agg backend,
unless ``render=False``.

The wire format is JSON (:func:`encode_event` / :func:`decode_event`),
byte for byte the reference's for the same event: never pickle, since a
viewer must not execute what a remote host (or whoever spoofs it)
sends.  ``zmq`` is imported only when an endpoint is bound, and
``matplotlib`` only when an event is rendered.  Unlike the reference,
which quietly disables plots when matplotlib is missing, the renderer
raises (:class:`PlotsUnavailable`): the training command line refuses
``-p`` up front where matplotlib does not import.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

from veles_tpu_torch import knobs
from veles_tpu_torch.logger import Logger


class PlotsUnavailable(RuntimeError):
    """Raised when a plot event is rendered without matplotlib."""


def _jsonable(obj: Any) -> Any:
    """numpy arrays and scalars as plain lists and numbers."""
    import numpy as np

    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, np.generic):
        return obj.item()
    if isinstance(obj, dict):
        return {k: _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    return obj


def encode_event(event: Dict[str, Any]) -> bytes:
    return json.dumps(_jsonable(event)).encode()


def decode_event(raw: bytes) -> Dict[str, Any]:
    event = json.loads(raw)
    if not isinstance(event, dict):
        raise ValueError("plot event must be a JSON object")
    return event


_server: Optional["GraphicsServer"] = None


def get_server() -> "GraphicsServer":
    """The process's graphics server (made at the first call)."""
    global _server
    if _server is None:
        _server = GraphicsServer()
    return _server


def shutdown_server() -> None:
    global _server
    if _server is not None:
        _server.close()
        _server = None


class GraphicsServer(Logger):
    """Publishes plot events; renders them to files unless
    ``render=False``."""

    def __init__(self, endpoint: Optional[str] = None,
                 out_dir: Optional[str] = None,
                 render: bool = True) -> None:
        self.endpoint = endpoint
        self.out_dir = out_dir or knobs.get(knobs.PLOTS_DIR)
        self.render = render
        self._sock = None
        self._renderer = None

    def _ensure_sock(self):
        if self.endpoint and self._sock is None:
            import zmq
            ctx = zmq.Context.instance()
            self._sock = ctx.socket(zmq.PUB)
            self._sock.bind(self.endpoint)
            self.info("graphics PUB bound on %s", self.endpoint)
        return self._sock

    def bind(self) -> None:
        """Bind the PUB endpoint now, so that live viewers can attach
        before the first plot event."""
        self._ensure_sock()

    def enqueue(self, event: Dict[str, Any]) -> None:
        """``event``: ``{"plotter": name, "kind": ..., payload...}``."""
        sock = self._ensure_sock()
        if sock is not None:
            sock.send(encode_event(event))
        if self.render:
            if self._renderer is None:
                self._renderer = FileRenderer(self.out_dir)
            self._renderer.render(event)

    def close(self) -> None:
        if self._sock is not None:
            self._sock.close(0)
            self._sock = None


class FileRenderer(Logger):
    """Renders plot events to PNG files with matplotlib's Agg backend:
    one file per plotter name, overwritten as the run goes on."""

    def __init__(self, out_dir: str) -> None:
        self.out_dir = out_dir
        self._pyplot = None

    def _plt(self):
        if self._pyplot is None:
            try:
                import matplotlib
                matplotlib.use("Agg", force=True)
                import matplotlib.pyplot as plt
            except ImportError as e:
                raise PlotsUnavailable(
                    f"rendering plots needs matplotlib ({e})") from e
            self._pyplot = plt
        return self._pyplot

    def render(self, event: Dict[str, Any]) -> Optional[str]:
        """The PNG's path; None for an event of an unknown kind."""
        plt = self._plt()
        os.makedirs(self.out_dir, exist_ok=True)
        kind = event.get("kind")
        fig = plt.figure(figsize=event.get("figsize", (6, 4)))
        try:
            ax = fig.add_subplot(111)
            if kind == "curves":
                for label, (xs, ys) in event["series"].items():
                    ax.plot(xs, ys, label=label)
                ax.set_xlabel(event.get("xlabel", "epoch"))
                ax.set_ylabel(event.get("ylabel", ""))
                if event["series"]:
                    ax.legend(loc="best", fontsize=8)
                ax.grid(True, alpha=0.3)
            elif kind == "matrix":
                im = ax.imshow(event["matrix"], cmap="viridis",
                               interpolation="nearest")
                fig.colorbar(im, ax=ax)
                ax.set_xlabel(event.get("xlabel", "predicted"))
                ax.set_ylabel(event.get("ylabel", "target"))
            elif kind == "image_grid":
                import numpy as np
                fig.clf()
                tiles = event["tiles"]
                n = len(tiles)
                cols = int(np.ceil(np.sqrt(n)))
                rows = int(np.ceil(n / cols))
                for i, tile in enumerate(tiles):
                    sub = fig.add_subplot(rows, cols, i + 1)
                    sub.imshow(tile, cmap=event.get("cmap", "gray"))
                    sub.set_xticks(())
                    sub.set_yticks(())
            else:
                return None
            title = event.get("title", event.get("plotter", "plot"))
            fig.suptitle(title, fontsize=10)
            path = os.path.join(
                self.out_dir, f"{event.get('plotter', 'plot')}.png")
            fig.savefig(path, dpi=100)
            return path
        finally:
            plt.close(fig)
