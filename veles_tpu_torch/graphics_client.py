"""The graphics client: subscribes to a graphics server's PUB endpoint
and renders the plot events it receives to files (the port's copy of
``veles_tpu/graphics_client.py``).  Run it on a workstation while a run
trains headless with ``--plots-endpoint``::

    python -m veles_tpu_torch.graphics_client tcp://trainhost:5005 [out_dir]

It needs ``zmq`` (exit 2 naming it where it does not import) and, to
render, ``matplotlib``.
"""

from __future__ import annotations

import sys

from veles_tpu_torch.graphics_server import FileRenderer, decode_event
from veles_tpu_torch.logger import Logger, setup_logging


class GraphicsClient(Logger):
    def __init__(self, endpoint: str, out_dir: str = "plots") -> None:
        self.endpoint = endpoint
        self.renderer = FileRenderer(out_dir)

    def serve(self, max_events: int = 0) -> int:
        """Render events until ``max_events`` (0: until interrupted);
        returns how many were received."""
        import zmq

        ctx = zmq.Context.instance()
        sock = ctx.socket(zmq.SUB)
        sock.setsockopt(zmq.SUBSCRIBE, b"")
        sock.connect(self.endpoint)
        self.info("subscribed to %s", self.endpoint)
        n = 0
        try:
            while True:
                event = decode_event(sock.recv())
                path = self.renderer.render(event)
                if path:
                    self.info("rendered %s", path)
                n += 1
                if max_events and n >= max_events:
                    break
        except KeyboardInterrupt:
            pass
        finally:
            sock.close(0)
        return n


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    setup_logging()
    if not argv:
        print(__doc__)
        return 2
    try:
        import zmq  # noqa: F401
    except ImportError as e:
        print(f"graphics_client needs zmq, which does not import here "
              f"({e})", file=sys.stderr)
        return 2
    out = argv[1] if len(argv) > 1 else "plots"
    GraphicsClient(argv[0], out).serve()
    return 0


if __name__ == "__main__":
    sys.exit(main())
