"""The graphics bus across packages: zmq PUB/SUB between the reference's
``veles_tpu/graphics_server.py`` and the port's
``veles_tpu_torch/graphics_client.py``, and the other way round.  Each
client renders what it receives; the events arrive as the publisher
encoded them.  Skipped only where ``zmq`` does not import."""

import os
import socket
import threading
import time

import numpy as np
import pytest

zmq = pytest.importorskip("zmq")

from veles_tpu import graphics_client as ref_gc  # noqa: E402
from veles_tpu import graphics_server as ref_gs  # noqa: E402
from veles_tpu_torch import graphics_client, graphics_server  # noqa: E402

EVENTS = [
    {"kind": "curves", "plotter": "plt_error",
     "series": {"train": ([1, 2], [50.0, 20.0]),
                "validation": ([1, 2], [40.0, 25.0])},
     "ylabel": "error_pct"},
    {"kind": "matrix", "plotter": "plt_confusion",
     "matrix": np.arange(9, dtype=np.int32).reshape(3, 3)},
    {"kind": "image_grid", "plotter": "plt_weights",
     "tiles": [np.full((4, 4), i / 4.0, np.float32) for i in range(4)]},
]


def _endpoint() -> str:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"tcp://127.0.0.1:{s.getsockname()[1]}"


def _relay(server_mod, client_mod, tmp_path):
    """Publish each of EVENTS from ``server_mod``'s server until a
    ``client_mod`` client subscribed for it has rendered it (PUB/SUB
    drops what is sent before a subscription lands, so each event is
    sent again until it arrives); (the rendered file names, the raw
    frames a plain SUB socket saw)."""
    endpoint = _endpoint()
    server = server_mod.GraphicsServer(endpoint=endpoint,
                                       out_dir=str(tmp_path / "srv"),
                                       render=False)
    server.bind()
    sub = zmq.Context.instance().socket(zmq.SUB)
    sub.setsockopt(zmq.SUBSCRIBE, b"")
    sub.connect(endpoint)
    frames = []
    try:
        for event in EVENTS:
            client = client_mod.GraphicsClient(endpoint,
                                               str(tmp_path / "cli"))
            got = []
            t = threading.Thread(target=lambda: got.append(
                client.serve(max_events=1)), daemon=True)
            t.start()
            deadline = time.monotonic() + 30
            while t.is_alive() and time.monotonic() < deadline:
                server.enqueue(event)
                time.sleep(0.05)
            t.join(timeout=10)
            assert got == [1], f"{event['plotter']} never arrived"
        while sub.poll(200):
            frames.append(sub.recv())
    finally:
        sub.close(0)
        server.close()
    return sorted(os.listdir(tmp_path / "cli")), frames


@pytest.mark.parametrize("server_mod,client_mod", [
    (ref_gs, graphics_client), (graphics_server, ref_gc)],
    ids=["reference_to_port", "port_to_reference"])
def test_events_cross_the_bus(server_mod, client_mod, tmp_path):
    files, frames = _relay(server_mod, client_mod, tmp_path)
    assert files == ["plt_confusion.png", "plt_error.png",
                     "plt_weights.png"]
    kinds = [graphics_server.decode_event(f)["plotter"] for f in frames]
    assert set(kinds) == {e["plotter"] for e in EVENTS}
    # every frame is the other package's encoding of the event, too
    for raw in frames:
        ev = graphics_server.decode_event(raw)
        want = next(e for e in EVENTS if e["plotter"] == ev["plotter"])
        assert raw == graphics_server.encode_event(want) == \
            ref_gs.encode_event(want)
